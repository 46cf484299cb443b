"""PyTorch port: streaming generation against the JAX package, on the CPU.

For Parler, Orpheus and Dia, tiny GGUFs (the other port tests' fixtures)
load through both registries (the port's with device="cpu"):
- the port's `generate_stream` against the JAX `generate_stream` on the same
  file, seed, `chunk` and `margin`: the same chunk count, the same greedy
  codes (recorded where each stream delay-undoes them), and each chunk's
  waveform within the vocoders' port tolerances (DAC 1e-3, SNAC 1e-4, as
  tests/test_torch_port_dac.py and test_torch_port_orpheus.py hold them);
- the port's stream against the port's own `generate`: equal length, and
  the JAX test's margins for the seams (tests/test_streaming.py: Parler 95%
  of samples within 1e-4 and all within 0.2; Dia 80% / 0.5 and Orpheus 75%
  / a mean of 0.2, their tiny vocoders' receptive fields being wider than
  the margin);
- each batched engine's `peek` against the JAX engine's, slots at different
  positions;
- the base runner's one-chunk default.
"""
import numpy as np
import pytest

from test_torch_port_dia import (jax_encoder, one_torch_thread,  # noqa: F401
                                 quantized, write_tiny_dia)
from test_torch_port_orpheus import (MAX_CTX, MAX_GEN, SNAC_TOL,  # noqa: F401
                                     small_prompt_ids, write_tiny_orpheus)
from test_torch_port_parler import _gguf, tpu_numerics  # noqa: F401
from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.gguf import quants
from tts_tpu.models.dia import model as jdia
from tts_tpu.models.orpheus import model as jorpheus
from tts_tpu.models.parler import model as jparler
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.runtime.batched_dia import BatchedDiaEngine as JDiaEngine
from tts_tpu.runtime.batched_llama import BatchedLlamaEngine as JLlamaEngine
from tts_tpu.runtime.batched_parler import BatchedParlerEngine as JParlerEngine
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.dia import model as pdia
from tts_tpu_torch.models.orpheus import model as porpheus
from tts_tpu_torch.models.parler import model as pparler
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.runtime import batched_dia
from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine
from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
from tts_tpu_torch.runtime.batched_parler import BatchedParlerEngine

Q4 = quants.GGML_TYPE_Q4_0
DAC_TOL = 1e-3   # the port's DAC against the JAX one (test_torch_port_dac.py)


def record(monkeypatch, module, name):
    """Wrap module.name so that every result is kept (the codes a stream
    delay-undoes each round); returns the list."""
    seen, orig = [], getattr(module, name)

    def wrapped(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    monkeypatch.setattr(module, name, wrapped)
    return seen


def against_jax(pchunks, jchunks):
    assert len(pchunks) == len(jchunks) > 1
    for a, b in zip(pchunks, jchunks):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=DAC_TOL)


def seams(stream, full, frac, atol=None, mean=None):
    """The concatenated stream against one decode of the whole: `frac` of
    the samples within 1e-4, and all within `atol` (or a mean error below
    `mean`)."""
    assert stream.shape == full.shape and full.size
    assert np.isclose(stream, full, atol=1e-4).mean() >= frac
    if atol is not None:
        np.testing.assert_allclose(stream, full, rtol=0, atol=atol)
    if mean is not None:
        assert np.abs(stream - full).mean() < mean


# -- Parler ------------------------------------------------------------------

@pytest.mark.parametrize("H,qtype,text,chunk,margin,seams_too", [
    (32, None, "hello", 4, 10, True), (256, Q4, "hello world", 2, 2, False)])
def test_parler_stream_matches_jax_and_generate(tmp_path, tpu_numerics,
                                                monkeypatch, H, qtype, text,
                                                chunk, margin, seams_too):
    """Per matmul (H 32, F32) and on K2's route (H 256, Q4_0). The tiny
    random DACs' receptive fields pass 10 frames, so the stream matches
    `generate` at the JAX test's margins only where `margin` covers it
    (H 32, 10 frames); K2's fixture stops after 4 frames, which take 2-step
    chunks to split, and is held to the JAX stream and its codes."""
    path = _gguf(tmp_path, H, 4, qtype, False)
    jr = jax_runner_from_file(path)
    pr = runner_from_file(path, device="cpu")
    assert (pr.mega is not None) == (qtype is not None)
    pc, jc = GenerationConfig(sample=False, seed=0), JConfig(sample=False, seed=0)
    want = pr.generate_codes(text, pc)
    full = pr.generate(text, pc).audio
    pseen = record(monkeypatch, pparler, "adjust_output_tokens")
    jseen = record(monkeypatch, jparler, "adjust_output_tokens")
    pchunks = list(pr.generate_stream(text, pc, chunk=chunk, margin=margin))
    jchunks = list(jr.generate_stream(text, jc, chunk=chunk, margin=margin))
    np.testing.assert_array_equal(pseen[-1], want)
    np.testing.assert_array_equal(jseen[-1], want)
    against_jax(pchunks, jchunks)
    if seams_too:
        seams(np.concatenate(pchunks), full, 0.95, atol=0.2)
    else:
        assert np.concatenate(pchunks).shape == full.shape


def test_parler_stream_default_schedule(tmp_path):
    """Without `chunk`: a first round of 32 steps, then 64, 128, ...; the
    tiny model's 24-step window ends in the first round, so the whole
    waveform comes as one chunk equal to `generate`'s."""
    path = _gguf(tmp_path, 32, 4, None, False)
    pr = runner_from_file(path, device="cpu")
    pc = GenerationConfig(sample=False, seed=0)
    chunks = list(pr.generate_stream("hello world", pc))
    assert len(chunks) == 1
    np.testing.assert_array_equal(chunks[0], pr.generate("hello world", pc).audio)


# -- Orpheus -----------------------------------------------------------------

@pytest.fixture(scope="module")
def orpheus_ggufs(tmp_path_factory):
    """The tiny Orpheus in F32 (per matmul) and Q4_0 with a quantized head
    (K6's route)."""
    d = tmp_path_factory.mktemp("orpheus-stream")
    src = str(d / "f32.gguf")
    write_tiny_orpheus(src, np.random.default_rng(0))
    q4 = str(d / "q4-head.gguf")
    quantize_gguf(src, q4, QuantizationParams(Q4, quantize_output_heads=True),
                  log=lambda *a: None)
    return {"f32": src, "q4-head": q4}


def _orpheus_runners(path):
    jr = jax_runner_from_file(path)
    pr = runner_from_file(path, device="cpu")
    for r in (jr, pr):   # a short generation window for the CPU
        r.cfg.max_generation_size = MAX_GEN
        r.cfg.max_context_length = MAX_CTX
    return jr, pr


@pytest.mark.parametrize("name", ["f32", "q4-head"])
def test_orpheus_stream_matches_jax_and_generate(orpheus_ggufs, tpu_numerics,
                                                 small_prompt_ids, monkeypatch,
                                                 name):
    jr, pr = _orpheus_runners(orpheus_ggufs[name])
    greedy = dict(sample=False, seed=7, voice="zoe")
    pc, jc = GenerationConfig(**greedy), JConfig(**greedy)
    out, n_out, _ = pr.generate_tokens("abcd cab", pc)
    want = porpheus.prepare_output_tokens(out, n_out)
    full = pr.generate("abcd cab", pc).audio
    pseen = record(monkeypatch, porpheus, "prepare_output_tokens")
    jseen = record(monkeypatch, jorpheus, "prepare_output_tokens")
    pchunks = list(pr.generate_stream("abcd cab", pc, chunk=7, margin=4))
    jchunks = list(jr.generate_stream("abcd cab", jc, chunk=7, margin=4))
    assert pseen[-1] == jseen[-1] == want
    assert len(pchunks) == len(jchunks) > 1
    for a, b in zip(pchunks, jchunks):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=SNAC_TOL)
    seams(np.concatenate(pchunks), full, 0.75, mean=0.2)


# -- Dia ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def dia_ggufs(tmp_path_factory):
    """The tiny Dia in F32 (per matmul) and Q4_0 with quantized heads
    (K10)."""
    d = tmp_path_factory.mktemp("dia-stream")
    f32 = str(d / "f32.gguf")
    write_tiny_dia(f32, np.random.default_rng(1))
    return {"f32": f32, "q4": quantized(f32, str(d / "q4.gguf"), Q4, True)}


@pytest.mark.parametrize("name", ["f32", "q4"])
def test_dia_stream_matches_jax_and_generate(dia_ggufs, tpu_numerics,
                                             monkeypatch, name):
    """On K10's route both sides decode from the JAX encoder's cross K/V
    (test_torch_port_dia.jax_encoder says why). At the server's margin of
    16 frames, 3-step chunks split the dialogue into 5-6."""
    jr = jax_runner_from_file(dia_ggufs[name])
    pr = runner_from_file(dia_ggufs[name], device="cpu")
    if pr.mega is not None:
        monkeypatch.setattr(pdia, "encode_request", jax_encoder(jr))
    text = "[S1] a b c d. [S2] e f g."
    pc, jc = GenerationConfig(sample=False, seed=3), JConfig(sample=False, seed=3)
    want = pr.generate_codes(text, pc)
    full = pr.generate(text, pc).audio
    pseen = record(monkeypatch, pdia, "adjust_output_tokens")
    jseen = record(monkeypatch, jdia, "adjust_output_tokens")
    pchunks = list(pr.generate_stream(text, pc, chunk=3, margin=16))
    jchunks = list(jr.generate_stream(text, jc, chunk=3, margin=16))
    np.testing.assert_array_equal(pseen[-1], want)
    np.testing.assert_array_equal(jseen[-1], want)
    against_jax(pchunks, jchunks)
    seams(np.concatenate(pchunks), full, 0.8, atol=0.5)


# -- the engines' peek ---------------------------------------------------------

def _peeks_equal(peng, jeng, prids, jrids, steps=2):
    """After `steps` chunks, each live request's peek on the port engine
    equals the JAX engine's; at least two live slots at different
    positions."""
    for _ in range(steps):
        peng.step()
        jeng.step()
    progress = []
    for prid, jrid in zip(prids, jrids):
        got, want = peng.peek(prid), jeng.peek(jrid)
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        progress.append(got[0])
    assert len(set(progress)) >= 2, progress
    assert peng.peek(10_000) is None


def test_parler_engine_peek_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    path = _gguf(tmp_path, 256, 4, Q4, False)
    jr = jax_runner_from_file(path)
    pr = runner_from_file(path, device="cpu")
    peng = BatchedParlerEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                               chunk=3)
    jeng = JParlerEngine(jr.cfg, jr.weights, jr.tokenizer, n_slots=2, chunk=3)
    prids = [peng.submit("hello world", GenerationConfig(sample=False))]
    jrids = [jeng.submit("hello world", JConfig(sample=False))]
    peng.step()
    jeng.step()
    # the second request starts a chunk later, from a shorter prompt
    prids.append(peng.submit("wor ld a b c", GenerationConfig(sample=False)))
    jrids.append(jeng.submit("wor ld a b c", JConfig(sample=False)))
    _peeks_equal(peng, jeng, prids, jrids, steps=1)


def test_llama_engine_peek_matches_jax(orpheus_ggufs, small_prompt_ids,
                                       monkeypatch):
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    jr, pr = _orpheus_runners(orpheus_ggufs["f32"])
    peng = BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                              chunk=4)
    jeng = JLlamaEngine(jr.cfg, jr.weights, jr.tokenizer, n_slots=2, chunk=4)
    prids = [peng.submit("abcd cab", GenerationConfig(sample=False, seed=0))]
    jrids = [jeng.submit("abcd cab", JConfig(sample=False, seed=0))]
    peng.step()
    jeng.step()
    prids.append(peng.submit("ab", GenerationConfig(sample=False, seed=0)))
    jrids.append(jeng.submit("ab", JConfig(sample=False, seed=0)))
    _peeks_equal(peng, jeng, prids, jrids, steps=1)


def test_dia_engine_peek_matches_jax(dia_ggufs, tpu_numerics, monkeypatch):
    jr = jax_runner_from_file(dia_ggufs["q4"])
    pr = runner_from_file(dia_ggufs["q4"], device="cpu")
    for mod in (pdia, batched_dia):
        monkeypatch.setattr(mod, "encode_request", jax_encoder(jr))
    peng = BatchedDiaEngine(pr.cfg, pr.weights, n_slots=2, chunk=5,
                            device="cpu")
    jeng = JDiaEngine(jr.cfg, jr.weights, n_slots=2, chunk=5)
    greedy = dict(sample=False, seed=0)
    prids = [peng.submit("[S1] hi there.", GenerationConfig(**greedy))]
    jrids = [jeng.submit("[S1] hi there.", JConfig(**greedy))]
    peng.step()
    jeng.step()
    prids.append(peng.submit("[S2] ab", GenerationConfig(**greedy)))
    jrids.append(jeng.submit("[S2] ab", JConfig(**greedy)))
    _peeks_equal(peng, jeng, prids, jrids, steps=1)


# -- the base runner -----------------------------------------------------------

def test_base_runner_streams_one_chunk():
    r = runner_from_file("test:dummy", device="cpu")
    chunks = list(r.generate_stream("abc"))
    assert len(chunks) == 1
    np.testing.assert_array_equal(chunks[0], r.generate("abc").audio)
