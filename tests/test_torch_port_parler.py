"""PyTorch port: the whole Parler slice (GGUF -> tokenizer -> prefill ->
decode -> delay-undo -> DAC -> WAV) against the JAX package, on the CPU.

Tiny GGUFs are written with `tts_tpu.convert.write_parler_gguf` and
quantized with `tts_tpu.apps.quantize`; each loads through both packages'
registries (the port's with device="cpu"). The JAX side runs with
TTS_TPU_MEGAKERNEL=1 so its CPU run takes the megastep path too, and LM
heads with bf16 scales, which its TPU run sends to the Pallas kernel, go
through that kernel's plain reference `_qdot_ref` (see `tpu_numerics`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_megastep import jax_fields, tiny_q4
from tts_tpu.apps.quantize import QuantizationParams, quantize_gguf
from tts_tpu.common import GenerationConfig as JConfig
from tts_tpu.convert import write_parler_gguf
from tts_tpu.gguf import quants
from tts_tpu.models.parler import model as jmodel
from tts_tpu.models.registry import runner_from_file as jax_runner_from_file
from tts_tpu.ops import quant_matmul as jqm
from tts_tpu.ops.parler_megastep import _qdot_ref
from tts_tpu_torch.audio.wav import read_audio_file
from tts_tpu_torch.common import GenerationConfig
from tts_tpu_torch.models.parler import model as pmodel
from tts_tpu_torch.models.parler.convert import parler_weights_from_numpy
from tts_tpu_torch.models.registry import runner_from_file


def make_parler_gguf(path, rng, H=32, n_attn_heads=4, ffn=None):
    """A tiny Parler GGUF (decoder + tiny DAC + unigram vocab), as
    `tests/test_e2e_parler.py::make_tiny_parler_gguf` writes it, with the
    width and head count as parameters."""
    L, NH, vocab = 2, 3, 12  # output vocab 12; audio vocab 8, eos 8, bos 9
    ffn = ffn or 2 * H

    def r(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.3

    dec = {}
    for l in range(L):
        b = f"layers.{l}."
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                   "final_layer_norm"):
            dec[b + ln + ".weight"] = r(H) * 0.1 + 1
            dec[b + ln + ".bias"] = r(H) * 0.1
        for n in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.out_proj", "encoder_attn.q_proj",
                  "encoder_attn.k_proj", "encoder_attn.v_proj",
                  "encoder_attn.out_proj"):
            dec[b + n + ".weight"] = r(H, H) / np.sqrt(H / 32)
        dec[b + "fc1.weight"] = r(ffn, H) / np.sqrt(H / 32)
        dec[b + "fc2.weight"] = r(H, ffn) / np.sqrt(ffn / 64)
    dec["layer_norm.weight"] = r(H) * 0.1 + 1
    dec["layer_norm.bias"] = r(H) * 0.1
    dec["embed_prompts"] = r(20, H)
    dec["positional_embed"] = r(64, H)
    for i in range(NH):
        dec[f"embed_tokens.{i}.weight"] = r(10, H)
        # damp the EOS/BOS/pad rows so greedy decoding yields valid frames
        # for a while before EOS latches
        dec[f"lm_heads.{i}.weight.head"] = r(vocab, H) * np.where(
            np.arange(vocab) < 8, 1.0, 0.5).astype(np.float32)[:, None]
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
    for i in range(NH):
        b = f"quantizers.{i}."
        dac[b + "codebook.weight"] = r(10, 6)
        dac[b + "out_proj.weight"] = r(8, 6, 1)
        dac[b + "out_proj.bias"] = r(8)
    tokens = ["<unk>", "</s>", " ", "he", "llo", "wor", "ld", "a", "b", "c"]
    scores = [-10.0, -1.0, -1.0, -2.0, -2.0, -2.0, -2.0, -3.0, -3.0, -3.0]
    write_parler_gguf(
        path, hidden_size=H, n_layers=L, n_attn_heads=n_attn_heads,
        n_output_heads=NH, output_vocab_size=vocab, max_generation=24,
        max_ctx=64, bos_token_id=9, eos_token_id=8, decoder_tensors=dec,
        tokenizer_tokens=tokens, tokenizer_scores=scores, tokenizer_unk_id=0,
        tokenizer_eos_id=1, text_encoding=r(6, H), dac_tensors=dac,
        dac_strides=(4, 2), dac_paddings=(2, 1), dac_up_sampling_factor=8)


@pytest.fixture
def tpu_numerics(monkeypatch):
    """JAX's CPU run with the numerics of its TPU run: the megastep path
    (TTS_TPU_MEGAKERNEL=1, through `parler_megastep_reference`) and, for
    bf16-scale weights (the padded LM heads), the quant-matmul kernel's
    bf16 mode through its plain reference `_qdot_ref` — on the CPU the
    dispatcher would otherwise take the f32 XLA path for them."""
    monkeypatch.setenv("TTS_TPU_MEGAKERNEL", "1")
    orig = jqm.quant_matmul

    def quant_matmul(x, codes_t, scales_t, qtype, use_pallas=None):
        if scales_t.dtype == jnp.bfloat16:
            return _qdot_ref(x.astype(jnp.float32), codes_t, scales_t,
                             jqm._BIAS[qtype]).astype(x.dtype)
        return orig(x, codes_t, scales_t, qtype, use_pallas)

    monkeypatch.setattr(jqm, "quant_matmul", quant_matmul)


# (width, heads, qtype, quantize_output_heads): H=32 takes the per-matmul
# path; H=256 with 4 heads (D=64) passes the megastep gate when quantized.
CASES = [
    (32, 4, None, False),
    (32, 4, quants.GGML_TYPE_Q8_0, False),
    (32, 4, quants.GGML_TYPE_Q4_0, False),
    (256, 4, None, False),
    (256, 4, quants.GGML_TYPE_Q8_0, False),
    (256, 4, quants.GGML_TYPE_Q4_0, False),
    (256, 4, quants.GGML_TYPE_Q4_0, True),
]


def _gguf(tmp_path, H, heads, qtype, q_heads):
    src = str(tmp_path / "parler-f32.gguf")
    make_parler_gguf(src, np.random.default_rng(H), H=H, n_attn_heads=heads)
    if qtype is None:
        return src
    dst = str(tmp_path / "parler-q.gguf")
    quantize_gguf(src, dst, QuantizationParams(
        qtype, quantize_output_heads=q_heads), log=lambda *a: None)
    return dst


@pytest.mark.parametrize("H,heads,qtype,q_heads", CASES)
def test_greedy_codes_and_waveform_match_jax(tmp_path, tpu_numerics, H, heads,
                                             qtype, q_heads):
    path = _gguf(tmp_path, H, heads, qtype, q_heads)
    jr = jax_runner_from_file(path)
    pr = runner_from_file(path, device="cpu")
    mega_expected = H == 256 and qtype is not None
    assert (jr._mega is not None) == mega_expected
    assert (pr.mega is not None) == mega_expected
    assert pr.weights.pos_embd.device.type == "cpu"
    if q_heads:   # the padded bf16-scale heads: K1's `_dqdot` mode
        assert pr.weights.heads.scales.dtype == torch.bfloat16
    text = "hello world"
    ref = jr.generate_codes(text, JConfig(sample=False, seed=0))
    out = pr.generate_codes(text, GenerationConfig(sample=False, seed=0))
    assert out.dtype == np.int64 and out.shape[1] == 3
    np.testing.assert_array_equal(out, ref)
    if ref.shape[0]:
        # the DAC tolerance of test_torch_port_dac.py (same tiny vocoder)
        jw = jr.generate(text, JConfig(sample=False, seed=0)).audio
        pw = pr.generate(text, GenerationConfig(sample=False, seed=0)).audio
        assert pw.shape == jw.shape == (ref.shape[0] * 8,)
        np.testing.assert_allclose(pw, jw, rtol=0, atol=1e-3)


def test_cli_writes_wav(tmp_path):
    from tts_tpu_torch.apps import cli
    path = _gguf(tmp_path, 32, 4, quants.GGML_TYPE_Q4_0, False)
    wav = str(tmp_path / "out.wav")
    args = ["-mp", path, "-p", "hello world", "-sp", wav, "--seed", "1",
            "--device", "cpu"]
    assert cli.main(args) == 0
    audio, rate = read_audio_file(wav)
    assert rate == 44100 and audio.size > 0 and audio.size % 8 == 0
    assert np.all(np.abs(audio) <= 1.0)
    # the same seed through the runner gives the same audio (16-bit WAV)
    resp = runner_from_file(path, device="cpu").generate(
        "hello world", GenerationConfig(top_k=50, seed=1))
    np.testing.assert_allclose(audio, resp.audio, atol=1.0 / 32767 + 1e-7)


def test_cli_refuses_unported_flags(tmp_path, capsys):
    from tts_tpu_torch.apps import cli
    assert cli.main(["-mp", "test:dummy", "-p", "hi", "--play",
                     "--device", "cpu"]) == 1
    assert cli.main(["-mp", "test:dummy", "-p", "hi", "-cp", "calm",
                     "-tep", "t5.gguf", "--device", "cpu"]) == 1
    assert "not supported" in capsys.readouterr().err
    wav = str(tmp_path / "dummy.wav")
    assert cli.main(["-mp", "test:dummy", "-p", "hi", "-sp", wav,
                     "--device", "cpu"]) == 0
    assert read_audio_file(wav)[0].size == 2 * 44100


def test_weights_from_numpy_decode_matches_jax(tpu_numerics):
    """tiny_q4's JAX weights carried across with parler_weights_from_numpy
    give the same greedy decode: prefill + 40 megastep decode steps (EOS
    never fires in this config), out_tokens and step count equal."""
    rng = np.random.default_rng(0)
    jcfg, jw = tiny_q4(rng)
    cfg = pmodel.ParlerConfig(**dataclasses.asdict(jcfg))
    pw = parler_weights_from_numpy(jax_fields(jw), device="cpu")
    mega, qtype = jmodel.maybe_prep_mega(jcfg, jw)
    pmega = pmodel.maybe_prep_mega(cfg, pw)
    assert mega is not None and pmega is not None and pmega.qtype == qtype
    toks = rng.integers(0, 900, 8).astype(np.int32)
    shape = (cfg.n_layers, cfg.n_attn_heads, cfg.max_ctx_length, cfg.head_size)
    kv_k, kv_v = jmodel.parler_prefill(jcfg, jw, jnp.asarray(toks),
                                       jnp.zeros(shape), jnp.zeros(shape))
    ref, ref_steps = jmodel.parler_generate_tokens_chunked(
        jcfg, jw, len(toks), kv_k, kv_v, jax.random.PRNGKey(0), chunk=16,
        do_sample=False, mega=mega, mega_qtype=qtype)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    pmodel.parler_prefill(cfg, pw, torch.from_numpy(toks).long(), pk, pv)
    out, steps = pmodel.generate_tokens_chunked(
        cfg, pw, len(toks), pk, pv, torch.Generator(), chunk=16,
        use_cross=True, do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
        repetition_penalty=1.0, mega=pmega)
    assert steps == int(ref_steps) == cfg.max_generation_size - len(toks)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
