"""PyTorch port: the JAX package's three runtime switches, on the CPU.

The port reads the JAX package's own variables with their meanings
(tts_tpu_torch/common.py):
  * TTS_TPU_KV_DTYPE=float32|bfloat16: the self-attention caches' dtype on
    every runner and engine (unset: bfloat16 on the card, float32 here);
  * TTS_TPU_MEGAKERNEL=0: every route gate returns None, so runners and
    engines take the per-matmul route; "1" or unset: chosen by the weights;
  * TTS_TPU_DAC_DTYPE=bfloat16, and `DACRunner(compute_dtype=...)` over it:
    the DAC's convolution weights in bf16 (`bf16_conv_weights`).
Each is held to the JAX package under the same setting (monkeypatch.setenv)
on tiny GGUFs: the route taken, greedy tokens (codes) equal, logits and
waveforms within the tolerances stated.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_e2e_parler import make_tiny_parler_gguf
from test_torch_port_dia import jax_encoder, quantized, write_tiny_dia
from test_torch_port_orpheus import (APP, MAX_CTX, MAX_GEN, PRE, _jax_tokens,
                                     write_tiny_orpheus)
from test_torch_port_parler import make_parler_gguf
from test_torch_port_parler import tpu_numerics  # noqa: F401  (fixture)
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.common import kv_cache_dtype as jax_kv_cache_dtype
from tts_tpu.gguf import GGUFReader as JReader
from tts_tpu.gguf import quants
from tts_tpu.models.codec import dac as jdac
from tts_tpu.models.orpheus import model as jorpheus
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.runtime.batched_dia import BatchedDiaEngine as JEngine
from tts_tpu_torch.common import GenerationConfig, kv_cache_dtype
from tts_tpu_torch.gguf import GGUFReader
from tts_tpu_torch.models.codec import dac as pdac
from tts_tpu_torch.models.dia import model as pdia
from tts_tpu_torch.models.orpheus import model as porpheus
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.runtime import batched_dia
from tts_tpu_torch.runtime.batched_dia import BatchedDiaEngine
from tts_tpu_torch.runtime.batched_llama import BatchedLlamaEngine
from tts_tpu_torch.runtime.batched_parler import BatchedParlerEngine

FAMILIES = ("parler", "orpheus", "dia")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread keeps the CPU to the other test
    workers and JAX's compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_prompt_ids(monkeypatch):
    """The Orpheus prompt format's special ids, in the tiny 300-token vocab."""
    for m in (jorpheus, porpheus):
        monkeypatch.setattr(m, "PREPENDED_TOKENS", PRE)
        monkeypatch.setattr(m, "APPENDED_TOKENS", APP)


# -- TTS_TPU_KV_DTYPE ---------------------------------------------------------

@pytest.mark.parametrize("env", [None, "float32", "bfloat16"])
def test_kv_cache_dtype_reads_the_variable(monkeypatch, env):
    """Set, the variable names the dtype on every device, as the JAX
    package's `kv_cache_dtype` reads it; unset, bfloat16 on the card and
    float32 on the CPU (the JAX package: bfloat16 on the TPU only)."""
    if env is None:
        monkeypatch.delenv("TTS_TPU_KV_DTYPE", raising=False)
    else:
        monkeypatch.setenv("TTS_TPU_KV_DTYPE", env)
    want = env or "float32"
    assert kv_cache_dtype("cpu") == getattr(torch, want)
    assert kv_cache_dtype(torch.device("cuda")) == getattr(torch, env or "bfloat16")
    assert jnp.dtype(jax_kv_cache_dtype()) == jnp.dtype(want)


def test_kv_cache_dtype_refuses_other_dtypes(monkeypatch):
    """Only the dtypes every cache-reading kernel takes: float16 is refused,
    naming the variable."""
    monkeypatch.setenv("TTS_TPU_KV_DTYPE", "float16")
    with pytest.raises(ValueError, match="TTS_TPU_KV_DTYPE"):
        kv_cache_dtype("cpu")


# -- tiny quantized GGUFs whose weights pass every route gate ------------------

@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """Q4_0 GGUFs on which each gate takes its fused route: Parler at H 256
    with 4 heads of 64 (K2), Orpheus at H 256 with 4 / 2 heads of 64 (K8),
    Dia at H 256 with 4 / 2 heads of 64 and quantized heads (K10)."""
    d = tmp_path_factory.mktemp("options")
    paths = {}
    src = str(d / "parler-f32.gguf")
    make_parler_gguf(src, np.random.default_rng(256), H=256, n_attn_heads=4)
    paths["parler"] = quantized(src, str(d / "parler-q4.gguf"),
                                quants.GGML_TYPE_Q4_0)
    src = str(d / "orpheus-f32.gguf")
    write_tiny_orpheus(src, np.random.default_rng(0))
    paths["orpheus"] = quantized(src, str(d / "orpheus-q4.gguf"),
                                 quants.GGML_TYPE_Q4_0)
    src = str(d / "dia-f32.gguf")
    write_tiny_dia(src, np.random.default_rng(1))
    paths["dia"] = quantized(src, str(d / "dia-q4.gguf"),
                             quants.GGML_TYPE_Q4_0, True)
    return paths


def _runners(family, path, monkeypatch):
    """Both packages' runners of `path` (the port's on the CPU), with the
    tiny models' short windows."""
    jr, pr = jax_runner_from_file(path), runner_from_file(path, device="cpu")
    if family == "orpheus":
        for r in (jr, pr):
            r.cfg.max_generation_size, r.cfg.max_context_length = MAX_GEN, MAX_CTX
    if family == "dia":
        for mod in (pdia, batched_dia):
            monkeypatch.setattr(mod, "encode_request", jax_encoder(jr))
    return jr, pr


def _engine(family, pr):
    if family == "parler":
        return BatchedParlerEngine(pr.cfg, pr.weights, pr.tokenizer,
                                   n_slots=2, chunk=8)
    if family == "orpheus":
        return BatchedLlamaEngine(pr.cfg, pr.weights, pr.tokenizer, n_slots=2,
                                  chunk=8)
    return BatchedDiaEngine(pr.cfg, pr.weights, n_slots=2, chunk=7,
                            device="cpu")


TEXTS = {"parler": ["hello world", "wor ld"], "orpheus": ["abcd cab", "ab"],
         "dia": ["[S1] hi there.", "[S2] ab"]}


def _greedy(family):
    kw = dict(sample=False, seed=0)
    return dict(kw, voice="zoe") if family == "orpheus" else kw


def _jax_result(family, jr, pr, text):
    """The JAX runner's greedy codes (Parler, Dia) or token lists
    (Orpheus), in the form the port's engines return them."""
    if family == "orpheus":
        out, n = _jax_tokens(jr, pr._prompt_ids(text, "zoe"))
        return jorpheus.prepare_output_tokens(out, n)
    return jr.generate_codes(text, JConfig(**_greedy(family)))


def _port_result(family, pr, text):
    cfg = GenerationConfig(**_greedy(family))
    if family == "orpheus":
        out, n, _ = pr.generate_tokens(text, cfg)
        return porpheus.prepare_output_tokens(out, n)
    return pr.generate_codes(text, cfg)


def _same(a, b):
    return a == b if isinstance(a, list) else np.array_equal(a, b)


@pytest.mark.parametrize("env", ["0", "1", None])
@pytest.mark.parametrize("family", FAMILIES)
def test_megakernel_variable_picks_the_route(ggufs, monkeypatch, family, env):
    """TTS_TPU_MEGAKERNEL=0: the runner's and the engine's gates return
    None (the per-matmul route), as the JAX runner's do; "1" or unset: the
    fused route, chosen by the weights (the JAX runner takes it with "1"
    on the CPU; unset, its gate also looks at the platform)."""
    if env is None:
        monkeypatch.delenv("TTS_TPU_MEGAKERNEL", raising=False)
    else:
        monkeypatch.setenv("TTS_TPU_MEGAKERNEL", env)
    pr = runner_from_file(ggufs[family], device="cpu")
    fused = env != "0"
    assert (pr.mega is not None) == fused
    assert (_engine(family, pr).mega is not None) == fused
    if env is not None:
        jr = jax_runner_from_file(ggufs[family])
        assert (jr._mega is not None) == fused


@pytest.mark.parametrize("setting", ["megakernel_0", "kv_bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_switch_matches_jax(ggufs, tpu_numerics, small_prompt_ids, monkeypatch,
                            family, setting):
    """Both packages under the same setting, on the Q4_0 GGUFs: with
    TTS_TPU_MEGAKERNEL=0 both take the per-matmul route (K1 per projection,
    K3 / K4); with TTS_TPU_KV_DTYPE=bfloat16 both keep their fused route on
    bf16 caches (the JAX side with TTS_TPU_MEGAKERNEL=1, its CPU gate).
    The port's runner gives the JAX runner's greedy tokens (codes), and
    its engine (2 slots, bf16 caches under the second setting) gives them
    for two prompts at once."""
    if setting == "megakernel_0":
        monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "0")
    else:
        monkeypatch.setenv("TTS_TPU_KV_DTYPE", "bfloat16")
    jr, pr = _runners(family, ggufs[family], monkeypatch)
    fused = setting == "kv_bf16"
    assert (pr.mega is not None) == fused and (jr._mega is not None) == fused
    want = {}
    for text in TEXTS[family]:
        want[text] = _jax_result(family, jr, pr, text)
        assert len(want[text]) > 0
        assert _same(_port_result(family, pr, text), want[text]), text
    eng = _engine(family, pr)
    assert eng.state.kv_k.dtype == (torch.bfloat16 if fused else torch.float32)
    rids = [eng.submit(t, GenerationConfig(**_greedy(family)))
            for t in TEXTS[family]]
    eng.run_until_done()
    assert not eng.errors
    if family == "dia" and not fused:
        # the per-matmul engine reads the bucketed bf16 cross K/V and the
        # runner the f32 window: the engine is held to the JAX engine
        want = jax_dia_engine_codes(jr, TEXTS[family])
    for text, rid in zip(TEXTS[family], rids):
        assert _same(eng.results[rid], want[text]), text


def jax_dia_engine_codes(jr, texts):
    """The JAX Dia engine's greedy codes of `texts`, one a slot."""
    jeng = JEngine(jr.cfg, jr.weights, n_slots=len(texts), chunk=7)
    jids = [jeng.submit(t, JConfig(sample=False, seed=0)) for t in texts]
    jeng.run_until_done()
    return {t: jeng.results[j] for t, j in zip(texts, jids)}


def test_kv_bf16_decode_logits_match_jax(ggufs, monkeypatch, small_prompt_ids):
    """TTS_TPU_KV_DTYPE=bfloat16 on the Orpheus runner's per-matmul route
    (TTS_TPU_MEGAKERNEL=0): prefill into bf16 caches, then 8 greedy decode
    steps on both sides from the same tokens. The caches hold bf16 values
    on both; the f32 K / V that are rounded into them differ by sum order
    (~1e-6), which can move a cached element by one bf16 ulp (2^-8
    relative): the logits agree within 1e-3 of the largest."""
    monkeypatch.setenv("TTS_TPU_KV_DTYPE", "bfloat16")
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "0")
    jr, pr = _runners("orpheus", ggufs["orpheus"], monkeypatch)
    cfg = pr.cfg
    ids = pr._prompt_ids(TEXTS["orpheus"][0], "zoe")
    shape = (cfg.n_layers, cfg.n_kv_heads, porpheus.cache_ctx(cfg), cfg.head_size)
    toks = np.zeros(64, np.int32)
    toks[:len(ids)] = ids
    jl, jk, jv = jorpheus.orpheus_prefill(
        jr.cfg, jr.weights, jnp.asarray(toks), jnp.int32(len(ids)),
        jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16))
    dt = kv_cache_dtype("cpu")
    assert dt == torch.bfloat16
    pk, pv = torch.zeros(shape, dtype=dt), torch.zeros(shape, dtype=dt)
    pl = porpheus.orpheus_prefill(cfg, pr.weights, pr.inv_freq,
                                  torch.tensor(ids), pk, pv)
    tok = int(np.argmax(np.asarray(jl)))
    assert tok == int(pl.argmax())
    st = porpheus.init_state(cfg, torch.tensor([tok]), len(ids), pk, pv, 9)
    ctx = shape[2]
    worst = 0.0
    for i in range(8):
        pos = len(ids) + i
        x = jorpheus.take_rows(jr.weights.embd, jnp.asarray([tok]))
        bias = jnp.where(jnp.arange(ctx)[None, :] <= pos, 0.0, -jnp.inf)
        h, jk, jv = jorpheus._llama_step(jr.cfg, jr.weights, x,
                                         jnp.asarray([pos]), jk, jv, pos, bias)
        ref = np.asarray(jorpheus.matmul(h, jr.weights.head))[0, :cfg.vocab_size]
        got = porpheus.step_logits(cfg, pr.weights, pr.inv_freq, st, pr.mega)
        got = got.reshape(-1)[:cfg.vocab_size].numpy()
        worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
        tok = int(np.argmax(ref))
        assert tok == int(np.argmax(got))
        st = st._replace(pos=st.pos + 1, token_in=torch.tensor([tok]))
    assert pk.dtype == torch.bfloat16 and jk.dtype == jnp.bfloat16
    assert worst < 1e-3, worst


# -- TTS_TPU_DAC_DTYPE -----------------------------------------------------------

# The tiny DAC's final convolution scaled by OUT_SCALE, so that the
# waveform stays in tanh's near-linear range (peaks ~0.5; unscaled, ~1e2
# before tanh saturates it, and a rounding that moves a sample across 0
# flips it by ~2): the comparison then measures the convolutions' bf16
# roundings, not tanh's sign.
OUT_SCALE = 0.005


@pytest.fixture(scope="module")
def tiny_dac(tmp_path_factory):
    """Both packages' DAC weights of the tiny Parler GGUF (2 layers, 3
    quantizers, latent 8, 8 samples a frame), f32 as loaded, the final
    convolution scaled by OUT_SCALE."""
    path = str(tmp_path_factory.mktemp("dac") / "parler-tiny.gguf")
    make_tiny_parler_gguf(path, np.random.default_rng(0))
    jr, pr = JReader(path), GGUFReader(path)
    jcfg, pcfg = jdac.DACConfig.from_gguf(jr), pdac.DACConfig.from_gguf(pr)
    jw = jdac.load_dac_weights(jr, jcfg)
    pw = pdac.load_dac_weights(pr, pcfg, device="cpu")
    jw = jw._replace(out_w=jw.out_w * OUT_SCALE, out_b=jw.out_b * OUT_SCALE)
    pw = pw._replace(out_w=pw.out_w * OUT_SCALE, out_b=pw.out_b * OUT_SCALE)
    return jcfg, jw, pcfg, pw


# bf16 convolutions: the activations are rounded to bf16 on both sides
# (relative 2^-9), and on this random net the JAX bf16 decode departs from
# its f32 one by 3.5-4.1% relative RMS (measured; the JAX package's own
# test allows 25% on a saturating net). The port's torch convolution also
# returns its output in bf16, where JAX keeps it in f32: one more rounding
# a convolution. Measured, the port's bf16 decode is 2.5-3.7% from JAX's
# bf16 one: held within 6% relative RMS and 10% of the peak sample, and
# nearer to JAX's bf16 decode than to its f32 one. The f32 decodes agree
# within 1e-3 (test_torch_port_dac.py).
DAC_BF16_RMS, DAC_BF16_PEAK = 0.06, 0.1


@pytest.mark.parametrize("t", [13, 70])
def test_dac_bf16_matches_jax(tiny_dac, t):
    """`DACRunner(compute_dtype="bfloat16")` against JAX `bf16_conv_weights`
    + `dac_decode`: the convolution kernels (3-D) in bf16 and nothing else;
    the waveform within the tolerance above."""
    jcfg, jw, pcfg, pw = tiny_dac
    run = pdac.DACRunner(pcfg, pw, compute_dtype="bfloat16")
    w = run.weights
    assert w.in_w.dtype == w.layers[0].up_w.dtype == torch.bfloat16
    assert w.layers[0].units[0].in_w.dtype == w.quantizers[0].out_w.dtype == \
        torch.bfloat16
    for a in (w.in_b, w.final_alpha, w.quantizers[0].codebook,
              w.layers[0].alpha, w.layers[0].units[0].out_b):
        assert a.dtype == torch.float32
    codes = np.random.default_rng(t).integers(0, 10, (t, 3)).astype(np.int64)
    ref = np.asarray(jdac.dac_decode(jcfg, jdac.bf16_conv_weights(jw),
                                     jnp.asarray(codes, jnp.int32)))
    f32 = np.asarray(jdac.dac_decode(jcfg, jw, jnp.asarray(codes, jnp.int32)))
    got = run.decode(codes)
    assert got.shape == ref.shape == (t * 8,) and np.isfinite(got).all()
    assert np.abs(ref).max() < 0.9     # tanh's near-linear range

    def rms(a, b):
        return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))

    assert rms(got, ref) < DAC_BF16_RMS, rms(got, ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=DAC_BF16_PEAK * np.abs(ref).max())
    assert rms(got, ref) < rms(got, f32)


@pytest.mark.parametrize("env,compute_dtype,bf16", [
    (None, None, False), ("bfloat16", None, True), ("float32", None, False),
    ("bfloat16", "float32", False), (None, "bfloat16", True)])
def test_dac_dtype_variable_and_override(tiny_dac, monkeypatch, env,
                                         compute_dtype, bf16):
    """TTS_TPU_DAC_DTYPE=bfloat16 gives the runner bf16 convolution weights
    (as it gives the JAX runner); `compute_dtype` overrides the variable
    both ways. The runner's `decode` and `stream_segment` (done, from frame
    0: the whole decode) both run on the runner's weights."""
    jcfg, jw, pcfg, pw = tiny_dac
    if env is None:
        monkeypatch.delenv("TTS_TPU_DAC_DTYPE", raising=False)
    else:
        monkeypatch.setenv("TTS_TPU_DAC_DTYPE", env)
    run = pdac.DACRunner(pcfg, pw, compute_dtype=compute_dtype)
    jrun = jdac.DACRunner(jcfg, jw, compute_dtype=compute_dtype)
    want = torch.bfloat16 if bf16 else torch.float32
    assert run.weights.out_w.dtype == want and run.weights.out_b.dtype == torch.float32
    assert jnp.dtype(jrun.weights.out_w.dtype) == jnp.dtype(
        "bfloat16" if bf16 else "float32")
    codes = np.random.default_rng(5).integers(0, 10, (21, 3)).astype(np.int64)
    wav = run.decode(codes)
    same = pdac.DACRunner(pcfg, pw, compute_dtype="bfloat16" if bf16
                          else "float32").decode(codes)
    np.testing.assert_array_equal(wav, same)
    seg, ready = pdac.stream_segment(run, codes, 0, True, 4)
    assert ready == 21
    np.testing.assert_array_equal(seg, wav)
