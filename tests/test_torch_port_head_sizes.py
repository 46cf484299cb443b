"""PyTorch port: head sizes other than 64 / 128, on the CPU.

The decode attention (K3 / K4, and the Dia steps' cross-attention entry)
takes every head size from 1 to 1024 (`decode_attention.head_size_ok`,
the rule of csrc/attention.cuh, whose lane layout's registers set the
limit); the JAX `paged_decode_attention` takes any. The persistent steps
(K10, K12, the llama step) compile their attention for 64 and 128 only.
Here: the rule itself; K3 / K4's plain versions at heads of 1 to 320
against the JAX package's `paged_decode_attention` (the Pallas kernel in
interpret mode) and `_xla_fallback`; the route gates, which send heads
that fail the JAX gates' `head_size % 64` test to the per-matmul route
(K1 + K3 / K4) as the JAX gates do, refuse at model load (not at the
first step) only what no decode route's attention takes, naming the head
size, and send heads the persistent steps do not take to a launch
sequence of K3 / K4; tiny models with heads of 12, 100, 260 and 320
through both packages' runners (and the port's engines at 100), greedy
tokens (codes) equal; and tiny heads-of-256 Orpheus and Dia GGUFs through
both packages' runners and the port's engines.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_port_dia import jax_encoder, quantized, write_tiny_dia
from test_torch_port_orpheus import MAX_CTX, MAX_GEN, write_tiny_orpheus
from test_torch_port_parler import make_parler_gguf
from test_torch_port_runtime_options import jax_dia_engine_codes
from test_torch_port_parler import tpu_numerics  # noqa: F401  (fixture)
from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.gguf import quants
from tts_tpu.models.dia import model as jdia
from tts_tpu.models.orpheus import model as jorpheus
from tts_tpu.models.parler import model as jparler
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.ops.decode_attention import _xla_fallback, paged_decode_attention
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.dia import model as pdia
from tts_tpu_torch.models.orpheus import model as porpheus
from tts_tpu_torch.models.parler import model as pparler
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.ops import decode_attention as da
from tts_tpu_torch.ops.llama_flat import LlamaFlat
from tts_tpu_torch.runtime import batched_dia
from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine
from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
from tts_tpu_torch.runtime.batched_parler import BatchedParlerEngine


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run many tiny torch ops: one intra-op thread keeps
    the CPU to the other test workers and JAX's compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TAKEN = (1, 4, 8, 12, 36, 60, 64, 80, 100, 128, 130, 192, 254, 256, 260,
         320, 512, 1000, 1024)
REFUSED = (0, 1025, 2048)


@pytest.mark.parametrize("d", TAKEN + REFUSED)
def test_head_size_rule(d):
    """Every size from 1 to 1024, bf16 and f32 caches alike; nothing past
    it, and no other cache dtype."""
    ok = d in TAKEN
    assert da.head_size_ok(d) == da.head_size_ok(d, torch.float32) == ok
    assert not da.head_size_ok(d, torch.float16)
    if ok:
        da.require_head_size(d, "x")
    else:
        with pytest.raises(ValueError, match=f"heads of {d} "):
            da.require_head_size(d, "x")
    assert set(da.STEP_HEAD_SIZES) == {64, 128}


CTX = 512


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 255, 256, 511])
@pytest.mark.parametrize("d", [1, 36, 80, 100, 192, 256, 320])
def test_k3_plain_matches_jax_at_other_head_sizes(rng, d, pos, cache):
    """3 q heads a kv head over a 512-row cache: K3's plain version against
    the Pallas kernel (interpret mode, pages of 256) and `_xla_fallback`.
    Every side is an f32 softmax over the same values (a bf16 cache read as
    f32 exactly), only the sums' order differs: 1e-5 absolute on outputs of
    size ~1."""
    hkv, n_rep = 2, 3
    q = rng.standard_normal((hkv * n_rep, d)).astype(np.float32)
    k = rng.standard_normal((hkv, CTX, d)).astype(np.float32)
    v = rng.standard_normal((hkv, CTX, d)).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if cache == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    kt, vt = (torch.from_numpy(a).to(tdt) for a in (k, v))
    kj, vj = (jnp.asarray(a).astype(jdt) for a in (k, v))
    out = da.decode_attention(torch.from_numpy(q), kt, vt,
                              torch.tensor([pos], dtype=torch.int32)).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(paged_decode_attention(jnp.asarray(q), kj, vj, pos))
    xla = np.asarray(_xla_fallback(jnp.asarray(q), kj, vj, pos, d ** -0.5))
    assert out.shape == (hkv * n_rep, d)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, xla, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [1, 36, 80, 100, 192, 256, 320])
def test_k4_plain_matches_jax_at_other_head_sizes(rng, d):
    """K4's plain version, 4 slots at positions across the pages, each slot
    against `_xla_fallback` on its own cache; 1e-5 absolute."""
    pos = [0, 255, 256, 511]
    q = rng.standard_normal((4, 4, d)).astype(np.float32)
    k = rng.standard_normal((4, 2, CTX, d)).astype(np.float32)
    v = rng.standard_normal((4, 2, CTX, d)).astype(np.float32)
    out = da.decode_attention_batched(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(pos, dtype=torch.int32)).numpy()
    for s, p in enumerate(pos):
        ref = np.asarray(_xla_fallback(jnp.asarray(q[s]), jnp.asarray(k[s]),
                                       jnp.asarray(v[s]), p, d ** -0.5))
        np.testing.assert_allclose(out[s], ref, rtol=0, atol=1e-5)


class _Unquantized:
    """Stacked layer weights none of whose projections is quantized (every
    attribute None)."""

    def __getattr__(self, name):
        return None


def _no_mega_weights():
    """Weights whose projections are not quantized: every gate's prep
    raises ValueError on them, so a gate that admits the head size gives
    the per-matmul route (None)."""
    return types.SimpleNamespace(layers=_Unquantized(), dec_layers=_Unquantized())


GATES = {
    "parler": (lambda d: pparler.ParlerConfig(hidden_size=4 * d, n_attn_heads=4),
               pparler.maybe_prep_mega,
               lambda d: jparler.ParlerConfig(hidden_size=4 * d, n_attn_heads=4),
               jparler.maybe_prep_mega),
    "orpheus": (lambda d: porpheus.OrpheusConfig(head_size=d),
                porpheus.maybe_prep_llama_mega,
                lambda d: jorpheus.OrpheusConfig(head_size=d),
                jorpheus.maybe_prep_llama_mega),
    "orpheus_flat": (lambda d: porpheus.OrpheusConfig(head_size=d),
                     porpheus.maybe_prep_llama_flat,
                     lambda d: jorpheus.OrpheusConfig(head_size=d),
                     jorpheus.maybe_prep_llama_flat),
    "dia": (lambda d: pdia.DiaConfig(head_size=d), pdia.maybe_prep_dia_mega,
            lambda d: jdia.DiaConfig(head_size=d), jdia.maybe_prep_dia_mega),
}


@pytest.mark.parametrize("d", [12, 64, 80, 100, 128, 192, 256, 260, 320, 1024,
                               1025, 2048])
@pytest.mark.parametrize("gate", list(GATES))
def test_gates_refuse_what_the_attention_refuses(gate, d, monkeypatch):
    """Each route gate admits every head size K3 / K4 take (every route
    attends through them) and refuses the rest, past 1024, with a
    ValueError naming the head size, before it looks at the weights. The
    sizes that fail the JAX gate's `head_size % 64` test (12, 80, 100,
    260, 320, ...) get the per-matmul route (None) before the weights are
    read, as the JAX gate, with its fused path forced on
    (TTS_TPU_MEGAKERNEL=1), returns (None, None) for them."""
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    make_cfg, prep, make_jcfg, jprep = GATES[gate]
    cfg = make_cfg(d)
    assert cfg.head_size == d
    if not da.head_size_ok(d):
        with pytest.raises(ValueError, match=f"heads of {d} "):
            prep(cfg, None)
        return
    assert prep(cfg, _no_mega_weights()) is None
    if d % 64:
        assert prep(cfg, None) is None
        jr = jprep(make_jcfg(d), None)
        assert jr == (None, None) if isinstance(jr, tuple) else jr is None


def test_orpheus_runner_refuses_at_load():
    """The Orpheus runner prepares its route at the first generate; a head
    size past the attention's limit is refused when the runner is built."""
    with pytest.raises(ValueError, match="heads of 1025 "):
        porpheus.OrpheusRunner(porpheus.OrpheusConfig(head_size=1025), None,
                               None)


# -- tiny models with heads of other sizes through both packages ---------------

def _parler_gguf(tmp_path, d):
    src = str(tmp_path / f"parler-d{d}.gguf")
    make_parler_gguf(src, np.random.default_rng(d), H=2 * d, n_attn_heads=2,
                     ffn=64)
    return src


def _orpheus_gguf(tmp_path, d):
    src = str(tmp_path / f"orpheus-d{d}.gguf")
    write_tiny_orpheus(src, np.random.default_rng(d), heads=4, kv=2, d=d)
    return src


def _dia_gguf(tmp_path, d):
    src = str(tmp_path / f"dia-d{d}.gguf")
    write_tiny_dia(src, np.random.default_rng(d), decoder_attn_heads=2,
                   decoder_query_heads=1, head_size=d, encoder_attn_heads=1)
    return src


def _parler_case(tmp_path, d, engine):
    path = _parler_gguf(tmp_path, d)
    jr, pr = jax_runner_from_file(path), runner_from_file(path, device="cpu")
    assert pr.cfg.head_size == d and pr.mega is None and jr._mega is None
    texts = ["hello world", "wor ld"]
    want = {t: jr.generate_codes(t, JConfig(sample=False, seed=0)) for t in texts}
    for t in texts:
        assert want[t].shape[0] > 0
        got = pr.generate_codes(t, GenerationConfig(sample=False, seed=0))
        assert np.array_equal(got, want[t]), t
    if engine:
        eng = BatchedParlerEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                                  chunk=8)
        assert eng.mega is None
        rids = [eng.submit(t, GenerationConfig(sample=False, seed=0))
                for t in texts]
        eng.run_until_done()
        assert not eng.errors
        for t, rid in zip(texts, rids):
            assert np.array_equal(eng.results[rid], want[t]), t


def _orpheus_case(tmp_path, d, engine):
    from test_torch_port_orpheus import _jax_tokens
    path = _orpheus_gguf(tmp_path, d)
    jr, pr = jax_runner_from_file(path), runner_from_file(path, device="cpu")
    for r in (jr, pr):
        r.cfg.max_generation_size, r.cfg.max_context_length = MAX_GEN, MAX_CTX
    assert pr.cfg.head_size == d and pr.mega is None and jr._mega is None
    greedy = dict(sample=False, seed=0, voice="zoe")
    texts = ["abcd cab", "ab"] if engine else ["abcd cab"]
    want = {}
    for text in texts:
        jout, jn = _jax_tokens(jr, pr._prompt_ids(text, "zoe"))
        out, n_out, _ = pr.generate_tokens(text, GenerationConfig(**greedy))
        assert jn == n_out
        np.testing.assert_array_equal(out[:n_out], jout[:jn])
        want[text] = porpheus.prepare_output_tokens(out, n_out)
    if engine:
        eng = BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                                 chunk=8)
        assert eng.mega is None
        rids = [eng.submit(t, GenerationConfig(**greedy)) for t in texts]
        eng.run_until_done()
        assert not eng.errors
        for text, rid in zip(texts, rids):
            assert eng.results[rid] == want[text], text


def _dia_case(tmp_path, d, engine, monkeypatch):
    path = _dia_gguf(tmp_path, d)
    jr, pr = jax_runner_from_file(path), runner_from_file(path, device="cpu")
    assert pr.cfg.head_size == d and pr.mega is None and jr._mega is None
    for mod in (pdia, batched_dia):
        monkeypatch.setattr(mod, "encode_request", jax_encoder(jr))
    texts = ["[S1] hi there.", "[S2] ab"] if engine else ["[S1] hi there."]
    want = {}
    for text in texts:
        want[text] = jr.generate_codes(text, JConfig(sample=False, seed=0))
        got = pr.generate_codes(text, GenerationConfig(sample=False, seed=0))
        assert want[text].shape[0] > 0 and np.array_equal(got, want[text]), text
    if engine:
        eng = BatchedDiaEngine(pr.cfg, pr.weights, n_slots=2, chunk=7,
                               device="cpu")
        assert eng.mega is None
        rids = [eng.submit(t, GenerationConfig(sample=False, seed=0))
                for t in texts]
        eng.run_until_done()
        assert not eng.errors
        # the per-matmul engine reads the bucketed bf16 cross K/V and the
        # runner the f32 window: the engine is held to the JAX engine
        want = jax_dia_engine_codes(jr, texts)
        for text, rid in zip(texts, rids):
            assert np.array_equal(eng.results[rid], want[text]), text


@pytest.mark.parametrize("d", [12, 100, 260, 320])
@pytest.mark.parametrize("family", ["parler", "orpheus", "dia"])
def test_other_head_sizes_match_jax(tmp_path, tpu_numerics, small_prompt_ids,
                                    monkeypatch, family, d):
    """Tiny F32 models whose heads fail the JAX gates' `head_size % 64`
    test (Parler: 2 heads of d, H 2d; Orpheus: 4 / 2 heads of d, H 256;
    Dia: 2 / 2 heads of d): both packages take the per-matmul route, and
    the port's runner gives the JAX runner's greedy tokens (codes); at
    heads of 100 the port's engine (2 slots, K4 per layer on the card)
    gives them too (Dia's: the JAX engine's)."""
    if family == "parler":
        _parler_case(tmp_path, d, d == 100)
    elif family == "orpheus":
        _orpheus_case(tmp_path, d, d == 100)
    else:
        _dia_case(tmp_path, d, d == 100, monkeypatch)


@pytest.fixture
def small_prompt_ids(monkeypatch):
    """The prompt format's special ids, in the tiny 300-token vocab."""
    from test_torch_port_orpheus import APP, PRE
    for m in (jorpheus, porpheus):
        monkeypatch.setattr(m, "PREPENDED_TOKENS", PRE)
        monkeypatch.setattr(m, "APPENDED_TOKENS", APP)


def test_orpheus_heads_of_256_match_jax(tmp_path, tpu_numerics, small_prompt_ids):
    """A tiny Orpheus with one q / kv head of 256, Q4_0 with a quantized
    head: both packages take the K6 route (the JAX side its flat kernel in
    interpret mode; the port's single stream K7's launch sequence at one
    slot, as its gate sends heads the persistent step does not take), and
    the greedy tokens are equal; the port's engine (K7) gives the runner's
    tokens for two prompts in two slots."""
    src, q4 = str(tmp_path / "f32.gguf"), str(tmp_path / "q4.gguf")
    write_tiny_orpheus(src, np.random.default_rng(3), heads=1, kv=1)
    quantize_gguf(src, q4, QuantizationParams(quants.GGML_TYPE_Q4_0,
                                              quantize_output_heads=True),
                  log=lambda *a: None)
    jr = jax_runner_from_file(q4)
    pr = runner_from_file(q4, device="cpu")
    for r in (jr, pr):
        r.cfg.max_generation_size, r.cfg.max_context_length = MAX_GEN, MAX_CTX
    assert pr.cfg.head_size == 256
    mega = pr.mega
    assert isinstance(mega.step, LlamaFlat) and not mega.persistent
    assert jr._mega is not None
    greedy = dict(sample=False, seed=0, voice="zoe")
    texts = ["abcd cab", "ab"]
    want = {}
    for text in texts:
        out, n_out, _ = pr.generate_tokens(text, GenerationConfig(**greedy))
        ids = pr._prompt_ids(text, "zoe")
        from test_torch_port_orpheus import _jax_tokens
        jout, jn = _jax_tokens(jr, ids)
        assert jn == n_out == MAX_GEN
        np.testing.assert_array_equal(out[:n_out], jout[:jn])
        want[text] = porpheus.prepare_output_tokens(out, n_out)
    eng = BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                             chunk=8)
    assert isinstance(eng.mega.step, LlamaFlat)
    rids = [eng.submit(t, GenerationConfig(**greedy)) for t in texts]
    eng.run_until_done()
    assert not eng.errors
    for text, rid in zip(texts, rids):
        assert eng.results[rid] == want[text], text


def test_dia_heads_of_256_match_jax(tmp_path, tpu_numerics, monkeypatch):
    """A tiny Dia with one q / kv head of 256, Q4_0 with quantized heads:
    both packages take the megastep route (the JAX side
    `dia_megastep_reference`; the port's single stream K11's launch
    sequence at one pair, as its gate sends heads the persistent K10 does
    not take), greedy codes equal; the port's engine (K11) gives the
    runner's codes for two prompts in two slots."""
    src = str(tmp_path / "f32.gguf")
    write_tiny_dia(src, np.random.default_rng(1), decoder_attn_heads=1,
                   decoder_query_heads=1, head_size=256, encoder_attn_heads=1)
    q4 = quantized(src, str(tmp_path / "q4.gguf"), quants.GGML_TYPE_Q4_0, True)
    jr = jax_runner_from_file(q4)
    pr = runner_from_file(q4, device="cpu")
    assert pr.cfg.head_size == 256
    assert pr.mega is not None and not pr.mega.persistent and jr._mega is not None
    for mod in (pdia, batched_dia):
        monkeypatch.setattr(mod, "encode_request", jax_encoder(jr))
    texts = ["[S1] hi there.", "[S2] ab"]
    want = {}
    for text in texts:
        want[text] = jr.generate_codes(text, JConfig(sample=False, seed=0))
        got = pr.generate_codes(text, GenerationConfig(sample=False, seed=0))
        assert got.shape[1] == 3 and np.array_equal(got, want[text]), text
    eng = BatchedDiaEngine(pr.cfg, pr.weights, n_slots=2, chunk=7, device="cpu")
    rids = [eng.submit(t, GenerationConfig(sample=False, seed=0)) for t in texts]
    eng.run_until_done()
    assert not eng.errors
    for text, rid in zip(texts, rids):
        assert np.array_equal(eng.results[rid], want[text]), text
