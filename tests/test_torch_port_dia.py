"""PyTorch port: Dia against the JAX package, on the CPU.

The byte tokenizer, the delay undo and the wind-down; `dia_encode`'s hidden
states and cross K/V; the sampler on CFG-masked logits; then a tiny Dia GGUF
(2 decoder layers of H 256, 4 q / 2 kv heads of 64, a 1-layer encoder of
H 128, 3 codebooks, a tiny DAC) through both registries: greedy codes equal
on each decode route, per matmul (F32) and K10's plain version (Q4_0 and
Q8_0; the JAX side with TTS_TPU_MEGAKERNEL=1, so that its CPU runner takes
`dia_megastep_reference`, and its bf16-scale heads through the kernel's
plain reference, as `tpu_numerics` arranges), and the port's CLI writing a
WAV. The plain kernels are held to the JAX package in
tests/test_torch_port_dia_ops.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_parler import tpu_numerics  # noqa: F401  (fixture)
from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.convert.writers import write_dia_gguf
from tts_tpu.gguf import quants
from tts_tpu.models.dia import model as jmodel
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu_torch.apps import cli
from tts_tpu_torch.audio.wav import read_audio_file
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.dia import model as pmodel
from tts_tpu_torch.models.dia.convert import dia_weights_from_numpy
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.ops import sampling

@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run many tiny torch ops: one intra-op thread keeps
    the CPU to the other test workers and JAX's compiles, which share it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the tiny model: 3 codebooks of vocab 12 (audio 8, EOS 8, PAD 9, BOS 10)
TINY = dict(n_output_heads=3, n_encoder_layers=1, n_decoder_layers=2,
            encoder_hidden_size=128, decoder_hidden_size=256,
            encoder_attn_heads=2, decoder_attn_heads=4, decoder_query_heads=2,
            head_size=64, eos_token_id=8, pad_token_id=9, bos_token_id=10,
            output_vocab_size=12, audio_vocab_size=8, max_generation_size=40,
            max_encoder_context_length=64, max_delay=4,
            delay_pattern=(0, 2, 4), cfg_max_output=8)
PROMPTS = ["[S1] hi there.", "[S2] ab", "[S1] a b c d. [S2] e f g.", "ok",
           "[S1] the quick brown fox."]


def write_tiny_dia(path, rng, tc=64, max_gen=40, **over):
    """A tiny F32 Dia GGUF with a tiny DAC-style decoder (2 blocks, 8x
    upsampling), written with the JAX package's writer; `over` replaces
    fields of TINY (the head count and size). The heads' EOS / PAD / BOS
    rows are damped so that greedy decoding makes valid frames for a
    while."""
    c = dict(TINY, max_encoder_context_length=tc, max_generation_size=max_gen,
             **over)
    H, E, d = c["decoder_hidden_size"], c["encoder_hidden_size"], c["head_size"]
    QH, KVH = c["decoder_attn_heads"] * d, c["decoder_attn_heads"] // \
        c["decoder_query_heads"] * d
    EQ, F, nh, V = c["encoder_attn_heads"] * d, 2 * H, c["n_output_heads"], \
        c["output_vocab_size"]

    def r(*s, k=None):
        a = rng.standard_normal(s).astype(np.float32) * 0.3
        return a / np.sqrt(k / 32) if k else a

    def norm(n):
        return r(n) * 0.1 + 1

    t = {"dia.encoder.embedding": r(256, E), "dia.encoder.norm": norm(E),
         "dia.decoder.norm": norm(H)}
    for l in range(c["n_encoder_layers"]):
        b = f"dia.encoder.layers.{l}."
        t.update({b + "pre_sa_norm": norm(E), b + "post_sa_norm": norm(E),
                  b + "q_proj": r(EQ, E, k=E), b + "k_proj": r(EQ, E, k=E),
                  b + "v_proj": r(EQ, E, k=E), b + "o_proj": r(E, EQ, k=EQ),
                  b + "gate": r(2 * E, E, k=E), b + "up": r(2 * E, E, k=E),
                  b + "wo": r(E, 2 * E, k=2 * E)})
    for l in range(c["n_decoder_layers"]):
        b = f"dia.decoder.layers.{l}."
        t.update({b + "pre_sa_norm": norm(H), b + "pre_ca_norm": norm(H),
                  b + "pre_mlp_norm": norm(H),
                  b + "self_q_proj": r(QH, H, k=H), b + "self_k_proj": r(KVH, H, k=H),
                  b + "self_v_proj": r(KVH, H, k=H), b + "self_o_proj": r(H, QH, k=QH),
                  b + "cross_q_proj": r(QH, H, k=H), b + "cross_k_proj": r(QH, E, k=E),
                  b + "cross_v_proj": r(QH, E, k=E), b + "cross_o_proj": r(H, QH, k=QH),
                  b + "gate": r(F, H, k=H), b + "up": r(F, H, k=H),
                  b + "wo": r(H, F, k=F)})
    damp = np.where(np.arange(V) < 8, 1.0, 0.5).astype(np.float32)[:, None]
    for i in range(nh):
        t[f"dia.decoder.embeddings.{i}"] = r(c["bos_token_id"] + 1, H)
        t[f"dia.decoder.heads.{i}"] = r(V, H, k=H) * damp
    dac = {"initial.weight": r(8, 8, 7), "initial.bias": r(8)}
    ch = [8, 6, 4]
    for i in (1, 2):
        b = f"decoder_block.{i}."
        cin, cout = ch[i - 1], ch[i]
        dac[b + "final.alpha"] = np.abs(r(1, cin, 1)) + 0.5
        dac[b + "final.weight"] = r(cin, cout, 2 * (4, 2)[i - 1])
        dac[b + "final.bias"] = r(cout)
        for j in range(3):
            ub = b + f"residual_unit.{j}.res."
            dac[ub + "initial.alpha"] = np.abs(r(1, cout, 1)) + 0.5
            dac[ub + "initial.weight"] = r(cout, cout, 7)
            dac[ub + "initial.bias"] = r(cout)
            dac[ub + "final.alpha"] = np.abs(r(1, cout, 1)) + 0.5
            dac[ub + "final.weight"] = r(cout, cout, 1)
            dac[ub + "final.bias"] = r(cout)
    dac["final.alpha"] = np.abs(r(1, 4, 1)) + 0.5
    dac["final.weight"] = r(1, 4, 7)
    dac["final.bias"] = r(1)
    for i in range(nh):
        b = f"quantizers.{i}."
        dac[b + "codebook.weight"] = r(10, 6)
        dac[b + "out_proj.weight"] = r(8, 6, 1)
        dac[b + "out_proj.bias"] = r(8)
    write_dia_gguf(
        path, head_size=d, encoder_hidden=E, decoder_hidden=H,
        encoder_layers=c["n_encoder_layers"], decoder_layers=c["n_decoder_layers"],
        encoder_heads=c["encoder_attn_heads"], decoder_heads=c["decoder_attn_heads"],
        query_heads=c["decoder_query_heads"], output_heads=nh, output_vocab=V,
        audio_vocab=c["audio_vocab_size"], max_generation=max_gen,
        max_encoder_context=tc, eos_token_id=c["eos_token_id"],
        bos_token_id=c["bos_token_id"], pad_token_id=c["pad_token_id"],
        max_delay=c["max_delay"], delay_pattern=c["delay_pattern"], tensors=t,
        dac_tensors=dac, dac_strides=(4, 2), dac_paddings=(2, 1),
        dac_up_sampling_factor=8)


def quantized(src, dst, qtype, heads=False):
    quantize_gguf(src, dst, QuantizationParams(qtype, quantize_output_heads=heads),
                  log=lambda *a: None)
    return dst


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """The tiny Dia per decode route: F32 (per matmul), Q4_0 with quantized
    heads and Q8_0 with F32 heads (K10)."""
    d = tmp_path_factory.mktemp("dia")
    f32 = str(d / "f32.gguf")
    write_tiny_dia(f32, np.random.default_rng(1))
    return {"f32": f32,
            "q4": quantized(f32, str(d / "q4.gguf"), quants.GGML_TYPE_Q4_0, True),
            "q8": quantized(f32, str(d / "q8.gguf"), quants.GGML_TYPE_Q8_0)}


@pytest.mark.parametrize("text", PROMPTS + ["", "  [S2] trailing.  ", "é ü"])
def test_tokenize_sentence_matches_jax(text):
    cfg = pmodel.DiaConfig()
    assert pmodel.tokenize_sentence(text, cfg) == \
        jmodel.tokenize_sentence(text, jmodel.DiaConfig())


def test_tokenize_sentence_refuses_long_prompts():
    cfg = pmodel.DiaConfig(max_encoder_context_length=16)
    with pytest.raises(ValueError, match="at most 16"):
        pmodel.tokenize_sentence("x" * 40, cfg)


@pytest.mark.parametrize("n_steps", [0, 3, 4, 5, 12, 40])
def test_adjust_output_tokens_matches_jax(n_steps):
    """Delay undo and invalid-frame filtering on random tokens, some of
    them outside the audio vocab."""
    rng = np.random.default_rng(n_steps)
    out = rng.integers(0, 10, (40, 3))
    pcfg = pmodel.DiaConfig(**TINY)
    jcfg = jmodel.DiaConfig(**TINY)
    got = pmodel.adjust_output_tokens(out, n_steps, pcfg)
    want = jmodel.adjust_output_tokens(out, n_steps, jcfg)
    assert got.dtype == np.int64 and np.array_equal(got, want)


def test_wind_down_matches_jax_decode_loop():
    """The wind-down at the end of the window: with tokens that never say
    EOS, the delay counter starts max_delay steps before max_steps, channel
    c gets EOS at wind-down step delay[c] and PAD after, and generation
    ends at position max_steps - 1, as in the JAX package's
    `dia_generate_tokens` (whose greedy tokens here are the reference's
    own)."""
    cfg = pmodel.DiaConfig(**TINY)
    max_steps = 20
    toks = torch.full((1, 3), 5, dtype=torch.int64)
    ds = torch.full((1,), -1, dtype=torch.int32)
    seen = []
    for p in range(max_steps):
        t_in, ds, ended = pmodel.wind_down(cfg, toks, ds,
                                           torch.tensor([p], dtype=torch.int32),
                                           max_steps)
        seen.append(t_in[0].tolist())
        if bool(ended):
            break
    assert p == max_steps - 1 and len(seen) == max_steps
    # wind-down steps 0..3 of delays (0, 2, 4): EOS on channel c at step
    # delay[c], PAD after
    assert seen[max_steps - 4:] == [[8, 5, 5], [9, 5, 5], [9, 8, 5], [9, 9, 5]]
    # an EOS on channel 0 starts it at once
    t_in, ds, ended = pmodel.wind_down(cfg, torch.tensor([[8, 1, 2]]),
                                       torch.tensor([-1], dtype=torch.int32),
                                       torch.tensor([3], dtype=torch.int32), 40)
    assert t_in.tolist() == [[8, 1, 2]] and ds.tolist() == [3] and not bool(ended)


def _jax_weights(path):
    return jax_runner_from_file(path).weights


def _numpy_fields(w):
    def leaf(v):
        if hasattr(v, "codes_t"):
            return (np.asarray(v.codes_t), np.asarray(v.scales_t), v.qtype)
        return np.asarray(v)

    return {f: ({g: leaf(getattr(v, g)) for g in type(v)._fields}
                if f in ("enc_layers", "dec_layers") else leaf(v))
            for f, v in w._asdict().items()}


@pytest.mark.parametrize("name", ["f32", "q4"])
def test_dia_encode_matches_jax(ggufs, name):
    """Hidden states and cross K/V of a prompt and of the all-zero
    unconditional row, the K rows past the prompt exactly zero: 1e-4 of
    the largest value (f32 products in another order)."""
    jw = _jax_weights(ggufs[name])
    pw = dia_weights_from_numpy(_numpy_fields(jw), device="cpu")
    cfg = pmodel.DiaConfig(**TINY)
    ids = pmodel.tokenize_sentence(PROMPTS[2], cfg)
    tokens = np.zeros((2, 64), np.int64)
    tokens[0, :len(ids)] = ids
    want = jmodel.dia_encode(jmodel.DiaConfig(**TINY), jw,
                             jnp.asarray(tokens, jnp.int32), jnp.int32(len(ids)))
    got = pmodel.dia_encode(cfg, pw, torch.from_numpy(tokens), len(ids))
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        assert g.shape == w_.shape
        assert np.abs(g.numpy() - w_).max() <= 1e-4 * np.abs(w_).max()
    assert not got[1][:, :, :, len(ids):].any()


@pytest.mark.parametrize("top_k,top_p,rep", [(0, 1.0, 1.0), (5, 1.0, 1.0),
                                             (0, 0.8, 1.0), (4, 0.9, 1.3)])
def test_sampler_on_cfg_masked_logits(top_k, top_p, rep):
    """The CFG merge sets every token above cfg_max_output to -inf: the
    single-stream and the batched sampler still draw finite, in-range
    tokens under top-k, top-p and the repetition penalty."""
    rng = np.random.default_rng(top_k)
    logits = torch.from_numpy(rng.standard_normal((3, 12)).astype(np.float32))
    logits[:, 9:] = float("-inf")
    gen = torch.Generator().manual_seed(0)
    st = sampling.init_state(3, "cpu")
    bst = sampling.init_batched_state(2, 3, "cpu")
    for _ in range(20):
        toks, st = sampling.sample_or_greedy(
            gen, logits, st, do_sample=True, temperature=0.8, top_k=top_k,
            top_p=top_p, repetition_penalty=rep)
        assert ((toks >= 0) & (toks < 9)).all()
        u = sampling.draw_u(gen, (2, 3), "cpu")
        btoks, bst = sampling.select_batched(
            logits[None].expand(2, 3, 12), bst, u,
            do_sample=torch.tensor([True, False]),
            temperature=torch.tensor([0.8, 1.0]),
            top_k=torch.tensor([top_k, 0]), top_p=torch.tensor([top_p, 1.0]),
            repetition_penalty=torch.tensor([rep, 1.0]))
        assert ((btoks >= 0) & (btoks < 9)).all()


def jax_encoder(jr):
    """`encode_request` through the JAX runner's encoder: the cross K/V the
    JAX decode reads, for the port's runner and engine. The K10 route
    rounds them to bf16, and the two encoders' f32 sums in other orders
    (1e-6 apart, test_dia_encode_matches_jax) can round an element to a
    neighbouring bf16 value; the CFG merge amplifies that fourfold and a
    greedy near-tie (a margin of 0.024 was seen) then parts the histories.
    With the same cross K/V the decode paths are compared alone."""
    def encode(cfg, w, ids):
        tokens = np.zeros((2, cfg.max_encoder_context_length), np.int32)
        tokens[0, :len(ids)] = ids
        _, ck, cv = jmodel.dia_encode(jr.cfg, jr.weights, jnp.asarray(tokens),
                                      jnp.int32(len(ids)))
        return torch.from_numpy(np.array(ck)), torch.from_numpy(np.array(cv))

    return encode


def _runners(path):
    jr = jax_runner_from_file(path)
    pr = runner_from_file(path, device="cpu")
    return jr, pr


@pytest.mark.parametrize("name,route", [("f32", None), ("q4", "K10"),
                                        ("q8", "K10")])
def test_dia_gguf_greedy_codes_match_jax(ggufs, tpu_numerics, monkeypatch,
                                         name, route):
    """The tiny GGUF through both registries: the same route on each side
    (the JAX megastep on the CPU is `dia_megastep_reference`) and equal
    greedy codes, prompt by prompt, over the whole 40-step window. On K10's
    route the port decodes from the JAX encoder's cross K/V (`jax_encoder`
    says why); on the per-matmul route, whose cross K/V stay f32, from its
    own. A sum in another order can still flip one bf16 rounding inside the
    step (test_k10_plain_matches_reference's 1e-2), which parts the greedy
    histories at a near-tie: the fixture's weights meet none on these
    prompts (with seeds 0 and 2 about one prompt in six parts, at a JAX
    margin of 0.024 of logits up to 15); test_torch_port_dia_ops.py holds
    the step itself to the reference."""
    jr, pr = _runners(ggufs[name])
    assert pr.arch == "dia" and pr.cfg.delay_pattern == (0, 2, 4)
    assert (pr.mega is not None) == (route == "K10") == (jr._mega is not None)
    if route == "K10":
        monkeypatch.setattr(pmodel, "encode_request", jax_encoder(jr))
    for text in PROMPTS:
        want = jr.generate_codes(text, JConfig(sample=False, seed=0))
        got = pr.generate_codes(text, GenerationConfig(sample=False, seed=0))
        assert got.shape[1] == 3 and np.array_equal(got, want), text


def test_dia_cli_writes_a_wav(ggufs, tmp_path):
    """The port's CLI on the Q4_0 GGUF, sampled: a 44.1 kHz WAV of whole
    8-sample DAC frames."""
    wav = str(tmp_path / "dia.wav")
    rc = cli.main(["-mp", ggufs["q4"], "-p", PROMPTS[0], "-sp", wav, "--seed",
                   "3", "--device", "cpu", "-tk", "4"])
    assert rc == 0
    audio, rate = read_audio_file(wav)
    assert rate == 44100 and audio.size > 0 and audio.size % 8 == 0
    assert np.all(np.isfinite(audio))


def test_sampled_codes_stay_in_the_audio_vocab(ggufs):
    """Sampled generation through the K10 route never emits a frame with a
    token outside the audio vocab (the CFG mask and the frame filter)."""
    pr = runner_from_file(ggufs["q4"], device="cpu")
    codes = pr.generate_codes(PROMPTS[1], GenerationConfig(
        temperature=1.5, top_k=0, top_p=0.95, repetition_penalty=1.2, seed=5))
    assert codes.ndim == 2 and codes.shape[1] == 3
    assert ((codes >= 0) & (codes < 8)).all()
