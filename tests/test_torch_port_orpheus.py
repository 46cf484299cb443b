"""PyTorch port: the Orpheus + SNAC slice against the JAX package, on the CPU.

The BPE tokenizer, SNAC (`snac_decode`, `SNACRunner` with position-stable
numpy noise, whole and in segments), `prepare_output_tokens`, and a tiny
Orpheus GGUF (L=2, H=256, 4 q / 2 kv heads of 64, F=512, vocab 300, the
tiny SNAC of `tests/test_orpheus.py::make_tiny_snac`) written with
`tts_tpu.convert.write_orpheus_gguf`, quantized with `tts_tpu.apps.quantize`
and loaded through both packages' registries (the port's with device="cpu")
on each decode route: per matmul (F32), K8 (Q4_0 layers, F32 head) and K6
(Q4_0 layers and head). The JAX side runs with TTS_TPU_MEGAKERNEL=1 so that
its CPU run takes the same route (K6 in Pallas interpret mode), and its
bf16-scale LM head goes through its TPU kernel's plain reference
(`tpu_numerics`, as in tests/test_torch_port_parler.py).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from test_orpheus import make_tiny_snac
from test_torch_port_parler import tpu_numerics  # noqa: F401  (fixture)
from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.convert.writers import write_orpheus_gguf
from tts_tpu.gguf import quants
from tts_tpu.models.codec import snac as jsnac
from tts_tpu.models.orpheus import model as jmodel
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.text import BPETokenizer as JBPE
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.codec import dac as pdac
from tts_tpu_torch.models.codec import snac as psnac
from tts_tpu_torch.models.orpheus import model as pmodel
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.ops.llama_flat import LlamaFlat
from tts_tpu_torch.ops.llama_megastep import LlamaMegaLayers
from tts_tpu_torch.text import BPETokenizer

# -- BPE ---------------------------------------------------------------------

BPE_TOKENS = ["<unk>", "a", "b", "c", "d", "Ġ", "Ġa", "Ġb", "ab", "bc", "abc",
              "Ġab", "cd", "abcd", "Ġabcd", "dd", "ca", "é", "éa"]
BPE_MERGES = ["a b", "b c", "Ġ a", "c d", "ab c", "Ġa b", "abc d", "Ġab cd",
              "d d", "c a", "é a"]


def _bpe_pair():
    vocab = {t: i for i, t in enumerate(BPE_TOKENS)}
    ranks = {tuple(m.split(" ")): i for i, m in enumerate(BPE_MERGES)}
    return BPETokenizer(vocab, ranks, 1, 2), JBPE(vocab, ranks, 1, 2)


@pytest.mark.parametrize("text", [
    "abcd", "abc abcd", "  ab   cab ", "dd cadd", "xyz ab", "é éa", "",
    "a b c d", "abcdabcd bcab"])
def test_bpe_matches_jax(text):
    """Space runs emit nothing and latch the 'Ġ' prefix for good, unknown
    pieces map to id 0, merges follow rank then position."""
    port, ref = _bpe_pair()
    assert port.tokenize(text) == ref.tokenize(text)


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet="abcdxé ", max_size=16))
def test_bpe_matches_jax_on_any_short_string(text):
    port, ref = _bpe_pair()
    assert port.tokenize(text) == ref.tokenize(text)


# -- SNAC --------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def port_snac(jcfg, jw):
    """The JAX package's tiny SNAC config and weights as the port's."""
    cfg = psnac.SNACConfig(**{f: getattr(jcfg, f) for f in
                              ("n_layers", "n_heads", "up_sampling_factor",
                               "embd", "repeats", "noise_steps", "strides",
                               "paddings", "groupings")})
    w = psnac.SNACWeights(
        quantizers=[pdac.QuantizeLayerWeights(*(_t(a) for a in q))
                    for q in jw.quantizers],
        in_w=_t(jw.in_w), in_b=_t(jw.in_b), up_w=_t(jw.up_w), up_b=_t(jw.up_b),
        layers=[pdac.CodecLayerWeights(
            alpha=_t(lw.alpha), up_w=_t(lw.up_w), up_b=_t(lw.up_b),
            units=[pdac.ResidualUnitWeights(*(_t(a) for a in u))
                   for u in lw.units],
            noise_w=_t(lw.noise_w)) for lw in jw.layers],
        final_alpha=_t(jw.final_alpha), out_w=_t(jw.out_w), out_b=_t(jw.out_b))
    return cfg, w


@pytest.fixture(scope="module")
def snacs():
    jcfg, jw = make_tiny_snac(np.random.default_rng(0))
    cfg, w = port_snac(jcfg, jw)
    return (jsnac.SNACRunner(jcfg, jw, buckets=(16, 32)),
            psnac.SNACRunner(cfg, w, buckets=(16, 32)))


# Both are float32 convolution stacks summed in different orders over the
# tiny net's random weights (scale 0.3), whose activations grow large enough
# to saturate the final tanh: measured differences reach 3.0e-5 on the tanh
# output, so 1e-4 absolute.
SNAC_TOL = 1e-4


def _heads(rng, t):
    return [rng.integers(0, 10, t // 4).tolist(),
            rng.integers(0, 10, t // 2).tolist(), rng.integers(0, 10, t).tolist()]


def test_snac_decode_matches_jax(snacs):
    """The decoder itself at a padded length with a valid prefix: the noise
    branch and the valid-length masks."""
    jrun, prun = snacs
    rng = np.random.default_rng(1)
    t, valid = 16, 12
    h = _heads(rng, t)
    noise = rng.standard_normal(sum(jrun.cfg.noise_steps) * t).astype(np.float32)
    ref = np.asarray(jsnac.snac_decode(
        jrun.cfg, jrun.weights, jnp.asarray(h[2], jnp.int32),
        jnp.asarray(h[1], jnp.int32), jnp.asarray(h[0], jnp.int32),
        jnp.asarray(noise), jnp.int32(valid)))
    got = psnac.snac_decode(prun.cfg, prun.weights, torch.tensor(h[2]),
                            torch.tensor(h[1]), torch.tensor(h[0]),
                            torch.from_numpy(noise), valid).numpy()
    assert got.shape == ref.shape == (t * 8,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=SNAC_TOL)
    # the masked tail is exactly zero on both
    np.testing.assert_array_equal(got[valid * 8:], 0.0)


@pytest.mark.parametrize("t,offset", [(8, 0), (20, 0), (36, 0), (12, 8),
                                      (8, 16)])
def test_snac_runner_matches_jax(snacs, t, offset):
    """Whole decodes across the 16/32-frame buckets and segments at a frame
    offset, with make_noise_layers noise (the same numpy draws in both),
    and the seeded noise of a decode without noise layers."""
    jrun, prun = snacs
    rng = np.random.default_rng(t + offset)
    h = _heads(rng, t)
    jn = jsnac.make_noise_layers(jrun.cfg, 5, 64)
    pn = psnac.make_noise_layers(prun.cfg, 5, 64)
    for a, b in zip(jn, pn):
        np.testing.assert_array_equal(a, b)
    ref = jrun.decode(h, noise_layers=jn, frame_offset=offset)
    got = prun.decode(h, noise_layers=pn, frame_offset=offset)
    assert got.shape == ref.shape == (t * 8,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=SNAC_TOL)
    if offset == 0:
        np.testing.assert_allclose(prun.decode(h, seed=3), jrun.decode(h, seed=3),
                                   rtol=0, atol=SNAC_TOL)


def test_prepare_output_tokens_matches_jax():
    rng = np.random.default_rng(0)
    out = rng.integers(128266, 128266 + 7 * 4096, 40)
    for n in (0, 6, 7, 23, 40):
        assert pmodel.prepare_output_tokens(out, n) == \
            jmodel.prepare_output_tokens(out, n)


# -- a tiny Orpheus GGUF through both registries -------------------------------

L, H, HEADS, KV, F, VOCAB = 2, 256, 4, 2, 512, 300
PRE, APP, STOP = (290, 291), (292, 293, 294, 295), 299
TEXT, VOICE = "abcd cab", "zoe"
MAX_GEN, MAX_CTX = 21, 64


def write_tiny_orpheus(path, rng, heads=HEADS, kv=KV):
    """Random F32 Orpheus + SNAC weights (projections of std 0.05, head 0.1,
    embeddings 1.0: logits of O(1)), a BPE vocab with merges, and the
    special ids PRE/APP/STOP inside the 300-token vocab. `heads` / `kv` set
    the attention heads (head_d = H / heads)."""
    def r(*s, scale=0.05):
        return rng.standard_normal(s).astype(np.float32) * scale

    t = {"orpheus.embed_tokens": r(VOCAB, H, scale=1.0),
         "orpheus.norm": r(H) + 1, "orpheus.lm_head": r(VOCAB, H, scale=0.1),
         "orpheus.rope_frequencies":
             (1.0 + rng.random(H // heads // 2)).astype(np.float32)}
    d = H // heads
    for l in range(L):
        b = f"orpheus.layers.{l}."
        t[b + "input_layernorm"] = r(H) + 1
        t[b + "post_attention_layernorm"] = r(H) + 1
        for n, shape in (("self_attn.q_proj", (H, H)),
                         ("self_attn.k_proj", (kv * d, H)),
                         ("self_attn.v_proj", (kv * d, H)),
                         ("self_attn.o_proj", (H, H)),
                         ("mlp.gate_proj", (F, H)), ("mlp.up_proj", (F, H)),
                         ("mlp.down_proj", (H, F))):
            t[b + n] = r(*shape)
    scfg, sw = make_tiny_snac(rng)
    s = {"in.weight": sw.in_w, "in.bias": sw.in_b, "up.weight": sw.up_w,
         "up.bias": sw.up_b, "alpha_out": np.asarray(sw.final_alpha)[None],
         "final.weight": sw.out_w, "final.bias": sw.out_b}
    for i, q in enumerate(sw.quantizers):
        b = f"quantizers.{i}."
        s.update({b + "codebook.weight": q.codebook,
                  b + "out_proj.weight": q.out_w, b + "out_proj.bias": q.out_b})
    for i, lw in enumerate(sw.layers):
        b = f"layers.{i}."
        s.update({b + "alpha": np.asarray(lw.alpha)[None], b + "weight": lw.up_w,
                  b + "bias": lw.up_b, b + "noise_weight": lw.noise_w})
        for j, u in enumerate(lw.units):   # the flat tensor-name layout
            ub = f"{b}{j}."
            s.update({ub + "in_alpha": u.in_alpha, ub + "in_weight": u.in_w,
                      ub + "in_bias": u.in_b, ub + "out_alpha": u.out_alpha,
                      ub + "out_weight": u.out_w, ub + "out_bias": u.out_b})
    vocab = BPE_TOKENS + [f"tok{i}" for i in range(len(BPE_TOKENS), VOCAB)]
    vocab[20:26] = ["z", "o", "e", "zo", "zoe", ":"]
    write_orpheus_gguf(
        path, vocab_size=VOCAB, attn_heads=heads, kv_attn_heads=kv,
        head_dim=d, hidden_size=H, n_layers=L, stopping_token_id=STOP,
        bos_token_id=PRE[1], eos_token_id=APP[0],
        tensors=t, tokenizer_tokens=vocab,
        tokenizer_merges=BPE_MERGES + ["z o", "zo e"],
        snac_tensors={k: np.asarray(v) for k, v in s.items()},
        snac_strides=scfg.strides, snac_paddings=scfg.paddings,
        snac_groupings=scfg.groupings,
        snac_up_sampling_factor=scfg.up_sampling_factor)


@pytest.fixture(scope="module")
def gguf_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("orpheus")
    src = str(d / "orpheus-f32.gguf")
    write_tiny_orpheus(src, np.random.default_rng(0))
    paths = {"f32": src}
    for name, q_heads in (("q4", False), ("q4-head", True)):
        paths[name] = str(d / f"orpheus-{name}.gguf")
        quantize_gguf(src, paths[name], QuantizationParams(
            quants.GGML_TYPE_Q4_0, quantize_output_heads=q_heads),
            log=lambda *a: None)
    return paths


@pytest.fixture
def small_prompt_ids(monkeypatch):
    """The reference's special ids (128000-128261) do not fit a 300-token
    vocab: both packages' prompt builders take these in-vocab ids instead."""
    for m in (jmodel, pmodel):
        monkeypatch.setattr(m, "PREPENDED_TOKENS", PRE)
        monkeypatch.setattr(m, "APPENDED_TOKENS", APP)


def cut_port_window(monkeypatch):
    """Port runners loaded from a GGUF (which does not carry the window) get
    the short generation window of `_runners`, e.g. the CLI's."""
    from_gguf = pmodel.OrpheusConfig.from_gguf

    def short(cls, r):
        c = from_gguf(r)
        c.max_generation_size, c.max_context_length = MAX_GEN, MAX_CTX
        return c

    monkeypatch.setattr(pmodel.OrpheusConfig, "from_gguf", classmethod(short))


def _runners(path):
    jr = jax_runner_from_file(path)
    pr = runner_from_file(path, device="cpu")
    for r in (jr, pr):   # a short generation window for the CPU
        r.cfg.max_generation_size = MAX_GEN
        r.cfg.max_context_length = MAX_CTX
    return jr, pr


@pytest.mark.parametrize("name,route", [("f32", None), ("q4", LlamaMegaLayers),
                                        ("q4-head", LlamaFlat)])
def test_orpheus_gguf_matches_jax(gguf_paths, tpu_numerics, small_prompt_ids,
                                  name, route):
    """Per route: the prompt ids, the prefill logits, the greedy tokens
    (equal) and the WAV."""
    jr, pr = _runners(gguf_paths[name])
    assert pr.arch == "orpheus" and pr.list_voices() == jr.list_voices()
    assert pr.weights.out_norm.device.type == "cpu"
    mega = pr.mega
    assert (route is None and mega is None) or isinstance(mega.step, route)
    assert (jr._mega is None) == (route is None)
    ids = pr._prompt_ids(TEXT, VOICE)
    assert ids == jr._prompt_ids(TEXT, VOICE) and 0 not in ids[2:-4]
    # prefill logits: JAX pads the prompt to its 64-token bucket
    cfg = pr.cfg
    shape = (cfg.n_layers, cfg.n_kv_heads, pmodel.cache_ctx(cfg), cfg.head_size)
    toks = np.zeros(64, np.int32)
    toks[:len(ids)] = ids
    ref, _, _ = jmodel.orpheus_prefill(jr.cfg, jr.weights, jnp.asarray(toks),
                                       jnp.int32(len(ids)), jnp.zeros(shape),
                                       jnp.zeros(shape))
    got = pmodel.orpheus_prefill(cfg, pr.weights, pr.inv_freq,
                                 torch.tensor(ids), torch.zeros(shape),
                                 torch.zeros(shape))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (VOCAB,)
    # f32 layers on both sides (K1 exact, f32 XLA); the bf16-scale head
    # rounds its input on both: 1e-5 of the largest logit, f32 sum order
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    greedy = dict(sample=False, seed=0, voice=VOICE)
    out, n_out, _ = pr.generate_tokens(TEXT, GenerationConfig(**greedy))
    jresp = jr.generate(TEXT, JConfig(**greedy))
    presp = pr.generate(TEXT, GenerationConfig(**greedy))
    assert n_out == MAX_GEN        # the stop token never came
    # the JAX runner's tokens, through its own chunked loop
    jout, jn = _jax_tokens(jr, ids)
    assert jn == n_out
    np.testing.assert_array_equal(out[:n_out], jout[:jn])
    assert presp.sample_rate == jresp.sample_rate == 24000
    assert presp.audio.shape == jresp.audio.shape == (12 * 8,)
    np.testing.assert_allclose(presp.audio, jresp.audio, rtol=0, atol=SNAC_TOL)


def _jax_tokens(jr, ids):
    """The JAX runner's greedy tokens (generate() keeps them internal)."""
    import jax
    cfg = jr.cfg
    toks = np.zeros(64, np.int32)
    toks[:len(ids)] = ids
    shape = (cfg.n_layers, cfg.n_kv_heads, jmodel.cache_ctx(cfg), cfg.head_size)
    logits, kv_k, kv_v = jmodel.orpheus_prefill(
        cfg, jr.weights, jnp.asarray(toks), jnp.int32(len(ids)),
        jnp.zeros(shape), jnp.zeros(shape))
    out, n = jmodel.orpheus_generate_tokens_chunked(
        cfg, jr.weights, jnp.argmax(logits).astype(jnp.int32), len(ids),
        kv_k, kv_v, jax.random.PRNGKey(0), max_steps=cfg.max_generation_size,
        do_sample=False, mega=jr._mega, mega_qtype=jr._mega_qtype)
    return np.asarray(out), int(n)


def test_orpheus_voice_and_cli(gguf_paths, small_prompt_ids, tmp_path,
                               monkeypatch):
    """--voice reaches the runner through the CLI; an unknown voice raises
    the JAX package's message."""
    from tts_tpu_torch.apps import cli
    from tts_tpu_torch.audio.wav import read_audio_file
    path = gguf_paths["q4-head"]
    with pytest.raises(ValueError, match="Voice 'bob' is not a valid Orpheus voice"):
        runner_from_file(path, device="cpu").generate(
            TEXT, GenerationConfig(voice="bob"))
    with pytest.raises(ValueError, match="Voice 'bob' is not a valid Orpheus voice"):
        cli.main(["-mp", path, "-p", TEXT, "-v", "bob", "--device", "cpu"])
    cut_port_window(monkeypatch)
    wav = str(tmp_path / "o.wav")
    assert cli.main(["-mp", path, "-p", TEXT, "-v", VOICE, "-sp", wav,
                     "--seed", "2", "--device", "cpu"]) == 0
    audio, rate = read_audio_file(wav)
    assert rate == 24000 and audio.size == 12 * 8
