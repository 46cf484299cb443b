"""Kokoro (82M, StyleTTS2-derived) in plain PyTorch.

The port of the JAX package's `models/kokoro/model.py` (parity: reference
src/models/kokoro/model.cpp). Two graphs a text chunk:

  duration graph:  tokens -> ALBERT (one shared layer run n_recurrence
                   times) -> prosody encoder (masked biLSTMs + AdaLayerNorm
                   with the style) -> duration biLSTM -> sigmoid projection
                   -> frames per token
  generation graph: the hidden states expanded to frames -> shared biLSTM
                   -> F0 / N curves (AdainResBlk1d chains) -> text encoder
                   (conv + LN + biLSTM) -> decoder (Adain blocks) ->
                   iSTFTNet generator (harmonic source, STFT, upsampling
                   with noise blocks, snake res blocks, iSTFT)

The JAX package runs both in XLA and reaches no Pallas kernel (its weights
are dense float32, its products XLA matmuls, its LSTMs `lax.scan`, its FFTs
`jnp.fft`), so everything here is plain torch on the weights' device, in
float32 without TF32 (common.strict_fp32).

Shapes are bucketed as in the JAX runner (tokens to 64 / 128 / 256 / 512,
frames to 250 ... 10240) and every conv and norm is masked on the padded
tail, so the result is the JAX package's: the generator zeroes the harmonic
source past the valid samples and its STFT reflect-pads the bucket's end,
so the last frames see the bucket's zeros, and a run at the exact length
would compute something else. The LSTMs stop at the valid length (their
padded steps carry the state and emit zeros, ops/rnn.py). The valid
lengths are host integers: the runner reads the durations back anyway to
pick the frame bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...common import (GenerationConfig, KOKORO_SAMPLES_PER_FRAME,
                       SAMPLE_RATE_KOKORO, TTSResponse, default_device)
from ...gguf.reader import GGUFReader
from ...ops import dsp
from ...ops.conv import conv1d, conv_transpose_1d
from ...ops.rnn import LSTMWeights, masked_bilstm
from ...text import SinglePassTokenizer
from ..base import TTSRunner

LRELU = 0.2

# Kokoro voice packs encode their language as the first letter of the voice
# name; this maps it to the espeak-ng voice identifier used for
# phonemization (reference kokoro/model.h:20-30).
KOKORO_LANG_TO_ESPEAK_ID = {
    "a": "gmw/en-US",
    "b": "gmw/en",
    "e": "roa/es",
    "f": "roa/fr",
    "h": "inc/hi",
    "i": "roa/it",
    "j": "jpx/ja",
    "p": "roa/pt-BR",
    "z": "sit/cmn",
}


def get_espeak_id_from_kokoro_voice(voice: str) -> str:
    return KOKORO_LANG_TO_ESPEAK_ID.get(voice[:1], "gmw/en-US")


@dataclasses.dataclass(eq=False)
class KokoroConfig:
    """Defaults per reference kokoro/model.h:186-232; overridden by
    kokoro.* GGUF keys (model.cpp:841-930)."""

    bos_token_id: int = 0
    eos_token_id: int = 0
    space_token_id: int = 16
    max_context_length: int = 512
    vocab_size: int = 178
    hidden_size: int = 768
    n_attn_heads: int = 12
    n_layers: int = 1
    n_recurrence: int = 12
    duration_hidden_size: int = 512
    style_half_size: int = 128
    f0_n_blocks: int = 3
    n_duration_prediction_layers: int = 3
    n_conv_layers: int = 3
    n_kernels: int = 3
    n_upsamples: int = 2
    n_decoder_blocks: int = 4
    n_res_blocks: int = 6
    n_noise_blocks: int = 2
    out_conv_padding: int = 3
    true_n_fft: int = 20
    stft_hop: int = 5
    harmonic_num: int = 8
    up_sampling_factor: int = KOKORO_SAMPLES_PER_FRAME
    upsample_scale: float = 300.0
    albert_scale: float = 0.125
    sin_amp: float = 0.1
    noise_std: float = 0.003
    voice_threshold: float = 10.0
    sample_rate: float = 24000.0
    max_duration_per_token: int = 50
    # per-block conv geometry (from GGUF metadata)
    res_block_dilations: tuple = ((1, 3, 5),) * 6
    res_block_paddings: tuple = ((1, 3, 5),) * 6
    noise_block_dilations: tuple = ((1, 3, 5),) * 2
    noise_block_paddings: tuple = ((1, 3, 5),) * 2
    noise_conv_strides: tuple = (6, 1)
    noise_conv_paddings: tuple = (3, 0)
    up_strides: tuple = (10, 6)
    up_paddings: tuple = (5, 3)

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.n_attn_heads

    @property
    def post_n_fft(self) -> int:
        return self.true_n_fft // 2 + 1

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "KokoroConfig":
        c = cls()
        g = r.metadata.get
        c.max_context_length = int(g("kokoro.duration_predictor.albert.context_length", c.max_context_length))
        vocab = g("kokoro.tokenizer.vocab_size")
        if vocab is None and g("tokenizer.ggml.tokens") is not None:
            # the reference converter (py-gguf kokoro_gguf_encoder.py) never
            # writes the vocab-size key; the token list defines it
            vocab = len(g("tokenizer.ggml.tokens"))
        if vocab is not None:
            c.vocab_size = int(vocab)
        for name, ti in r.tensors.items():
            # style vector width is not in the metadata either — each voice
            # pack row is concat(style_half, style_half2)
            if name.startswith("kokoro.voice_tensors."):
                c.style_half_size = int(ti.shape[-1]) // 2
                break
        c.hidden_size = int(g("kokoro.duration_predictor.albert.hidden_size", c.hidden_size))
        c.n_attn_heads = int(g("kokoro.duration_predictor.albert.attn_heads", c.n_attn_heads))
        c.n_layers = int(g("kokoro.duration_predictor.albert.layers", c.n_layers))
        c.n_recurrence = int(g("kokoro.duration_predictor.albert.recurrence", c.n_recurrence))
        c.duration_hidden_size = int(g("kokoro.duration_predictor.hidden_size", c.duration_hidden_size))
        c.f0_n_blocks = int(g("kokoro.duration_predictor.f0_n_blocks", c.f0_n_blocks))
        c.n_duration_prediction_layers = int(g("kokoro.duration_predictor.layers", c.n_duration_prediction_layers))
        c.n_conv_layers = int(g("kokoro.text_encoder.layers", c.n_conv_layers))
        c.n_kernels = int(g("kokoro.decoder.generator.kernels", c.n_kernels))
        c.n_upsamples = int(g("kokoro.decoder.generator.upsamples", c.n_upsamples))
        c.n_decoder_blocks = int(g("kokoro.decoder.generator.layers", c.n_decoder_blocks))
        c.out_conv_padding = int(g("kokoro.decoder.generator.padding", c.out_conv_padding))
        c.up_sampling_factor = int(g("kokoro.decoder.generator.up_sampling_factor", c.up_sampling_factor))
        # the F0 curve runs at 2x frame rate; its linear interpolation factor
        # is therefore half the per-frame sample count (600 -> 300 for the
        # published model, where the reference hardcodes 300)
        c.upsample_scale = c.up_sampling_factor / 2.0
        if "kokoro.decoder.generator.n_fft" in r.metadata:
            c.true_n_fft = int(g("kokoro.decoder.generator.n_fft"))
        c.stft_hop = int(g("kokoro.decoder.generator.hop", c.stft_hop))
        c.n_res_blocks = c.n_upsamples * c.n_kernels

        def geom(base, n):
            dil, pad = [], []
            for i in range(n):
                dd, pp = [], []
                for j in range(3):
                    d = g(f"{base}.{i}.{j}.dilation")
                    p = g(f"{base}.{i}.{j}.padding")
                    if d is None or p is None:
                        return None
                    dd.append(int(d)); pp.append(int(p))
                dil.append(tuple(dd)); pad.append(tuple(pp))
            return tuple(dil), tuple(pad)

        got = geom("kokoro.decoder.generator.res_blocks", c.n_res_blocks)
        if got:
            c.res_block_dilations, c.res_block_paddings = got
        nb, nbp = [], []
        ok = True
        for i in range(c.n_noise_blocks):
            dd, pp = [], []
            for j in range(3):
                d = g(f"kokoro.decoder.generator.noise_blocks.{i}.res_block.{j}.dilation")
                p = g(f"kokoro.decoder.generator.noise_blocks.{i}.res_block.{j}.padding")
                if d is None or p is None:
                    ok = False
                    break
                dd.append(int(d)); pp.append(int(p))
            if not ok:
                break
            nb.append(tuple(dd)); nbp.append(tuple(pp))
        if ok and nb:
            c.noise_block_dilations, c.noise_block_paddings = tuple(nb), tuple(nbp)
        ncs, ncp, ups, upp = [], [], [], []
        for i in range(c.n_noise_blocks):
            s = g(f"kokoro.decoder.generator.noise_blocks.{i}.stride")
            p = g(f"kokoro.decoder.generator.noise_blocks.{i}.padding")
            if s is not None:
                ncs.append(int(s)); ncp.append(int(p))
        if ncs:
            c.noise_conv_strides, c.noise_conv_paddings = tuple(ncs), tuple(ncp)
        for i in range(c.n_upsamples):
            s = g(f"kokoro.decoder.generator.up_convs.{i}.stride")
            p = g(f"kokoro.decoder.generator.up_convs.{i}.padding")
            if s is not None:
                ups.append(int(s)); upp.append(int(p))
        if ups:
            c.up_strides, c.up_paddings = tuple(ups), tuple(upp)
        return c


# ---------------------------------------------------------------------------
# Weight containers (the JAX package's, field for field)
# ---------------------------------------------------------------------------

class AlbertLayer(NamedTuple):
    q_w: Any; q_b: Any; k_w: Any; k_b: Any; v_w: Any; v_b: Any
    o_w: Any; o_b: Any
    attn_ln_w: Any; attn_ln_b: Any       # post-attention LayerNorm
    ffn_w: Any; ffn_b: Any
    ffn_out_w: Any; ffn_out_b: Any
    out_ln_w: Any; out_ln_b: Any         # post-ffn LayerNorm


class AdaLayerNormW(NamedTuple):
    gamma_w: Any; gamma_b: Any; beta_w: Any; beta_b: Any


class AdaResBlockW(NamedTuple):
    """StyleTTS2 AdainResBlk1d (reference build_ada_residual_conv,
    model.cpp:88-134)."""
    norm1: AdaLayerNormW
    conv1_w: Any; conv1_b: Any
    norm2: AdaLayerNormW
    conv2_w: Any; conv2_b: Any
    pool_w: Any; pool_b: Any             # depthwise convT (or None)
    upsample_w: Any; upsample_b: Any     # 1x1 shortcut (or None)


class GenResBlockW(NamedTuple):
    """iSTFTNet resblock with snake + AdaIN (model.cpp:136-165)."""
    adain1: List[AdaLayerNormW]
    adain2: List[AdaLayerNormW]
    alpha1: List[Any]
    alpha2: List[Any]
    convs1_w: List[Any]; convs1_b: List[Any]
    convs2_w: List[Any]; convs2_b: List[Any]


class NoiseBlockW(NamedTuple):
    conv_w: Any; conv_b: Any
    res: GenResBlockW


class DurationPredictorW(NamedTuple):
    encode_w: Any; encode_b: Any
    layers_lstm: List[tuple]             # [(fwd, bwd), ...]
    layers_ada: List[AdaLayerNormW]
    duration_lstm: tuple
    duration_proj_w: Any; duration_proj_b: Any
    shared_lstm: tuple
    f0_blocks: List[AdaResBlockW]
    n_blocks: List[AdaResBlockW]
    f0_proj_w: Any; f0_proj_b: Any
    n_proj_w: Any; n_proj_b: Any


class TextEncoderW(NamedTuple):
    embd: Any
    convs: List[tuple]                   # (gamma, beta, conv_w, conv_b)
    lstm: tuple


class GeneratorW(NamedTuple):
    m_source_w: Any; m_source_b: Any
    ups_w: List[Any]; ups_b: List[Any]
    noise_blocks: List[NoiseBlockW]
    res_blocks: List[GenResBlockW]
    out_conv_w: Any; out_conv_b: Any


class DecoderW(NamedTuple):
    f0_conv_w: Any; f0_conv_b: Any
    n_conv_w: Any; n_conv_b: Any
    asr_conv_w: Any; asr_conv_b: Any
    encoder_block: AdaResBlockW
    decoder_blocks: List[AdaResBlockW]
    generator: GeneratorW


class KokoroWeights(NamedTuple):
    token_embd: Any
    position_embd: Any
    token_type_row: Any
    input_ln_w: Any; input_ln_b: Any
    embd_hidden_w: Any; embd_hidden_b: Any
    albert_layers: List[AlbertLayer]
    prosody: DurationPredictorW
    text_encoder: TextEncoderW
    decoder: DecoderW


# ---------------------------------------------------------------------------
# primitive helpers
# ---------------------------------------------------------------------------

def _ln(x, w, b, eps):
    """LayerNorm over the last axis (w / b None: no affine)."""
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _ada_affine(style, w: AdaLayerNormW):
    gamma = style @ w.gamma_w.T + w.gamma_b
    beta = style @ w.beta_w.T + w.beta_b
    return gamma, beta


def _mask_t(x, valid: int):
    """Zero columns >= valid of (C, T)."""
    t = x.shape[-1]
    return x if valid >= t else F.pad(x[..., :valid], (0, t - valid))


def _masked_instance_norm(x, valid: int, eps=1e-5):
    """Per-channel mean / variance over the valid time prefix of (C, T);
    the tail zero."""
    h = F.instance_norm(x[None, :, :valid], eps=eps)[0]
    return F.pad(h, (0, x.shape[-1] - h.shape[-1]))


def ada_res_block(x, style, w: AdaResBlockW, valid: int):
    """x (C, T) -> (C_out, T or 2T). Returns (out, valid_out)."""
    gamma, beta = _ada_affine(style, w.norm1)
    h = _masked_instance_norm(x, valid)
    h = h * (1.0 + gamma[:, None]) + beta[:, None]
    h = F.leaky_relu(h, LRELU)
    h = _mask_t(h, valid)
    v_out = valid
    if w.pool_w is not None:
        c = h.shape[0]
        h = conv_transpose_1d(h, w.pool_w, w.pool_b, stride=2, padding=1,
                              groups=c, output_padding=1)
        v_out = valid * 2
        h = _mask_t(h, v_out)
    h = conv1d(h, w.conv1_w, w.conv1_b, padding=1)
    h = _mask_t(h, v_out)
    gamma, beta = _ada_affine(style, w.norm2)
    h = _masked_instance_norm(h, v_out)
    h = h * (1.0 + gamma[:, None]) + beta[:, None]
    h = F.leaky_relu(h, LRELU)
    # (no mask here: the JAX package's conv2 reads the tail as it stands)
    h = conv1d(h, w.conv2_w, w.conv2_b, padding=1)
    h = _mask_t(h, v_out)
    s = x
    if w.upsample_w is not None:
        if w.pool_w is not None:
            s = torch.repeat_interleave(s, 2, dim=-1)  # nearest x2
        s = w.upsample_w @ s
        if w.upsample_b is not None:
            s = s + w.upsample_b[:, None]
        s = _mask_t(s, v_out)
    return dsp.true_div(h + s, float(np.sqrt(2.0))), v_out


def gen_res_block(x, style, w: GenResBlockW, dilations, paddings, valid: int):
    """iSTFTNet residual block, x (C, T) (model.cpp:136-165)."""
    inpl = x
    for i in range(len(w.convs1_w)):
        gamma, beta = _ada_affine(style, w.adain1[i])
        h = _masked_instance_norm(inpl, valid)
        h = h * (1.0 + gamma[:, None]) + beta[:, None]
        h = dsp.snake_1d(h, w.alpha1[i].reshape(-1, 1))
        h = _mask_t(h, valid)
        h = conv1d(h, w.convs1_w[i], w.convs1_b[i], padding=paddings[i],
                   dilation=dilations[i])
        h = _mask_t(h, valid)
        gamma, beta = _ada_affine(style, w.adain2[i])
        h = _masked_instance_norm(h, valid)
        h = h * (1.0 + gamma[:, None]) + beta[:, None]
        h = dsp.snake_1d(h, w.alpha2[i].reshape(-1, 1))
        h = _mask_t(h, valid)
        # the reference uses conv1_paddings[0] for every convs2
        # (model.cpp:161)
        h = conv1d(h, w.convs2_w[i], w.convs2_b[i], padding=paddings[0])
        h = _mask_t(h, valid)
        inpl = inpl + h
    return inpl


# ---------------------------------------------------------------------------
# duration graph
# ---------------------------------------------------------------------------

def kokoro_duration(cfg: KokoroConfig, w: KokoroWeights, tokens: torch.Tensor,
                    valid_len: int, style_half: torch.Tensor):
    """tokens (P,) padded, `valid_len` of them real; returns (durations
    (P,) float32, padded tokens 0, and the hidden states (P, 640)).

    Parity: build_kokoro_duration_graph (model.cpp:938-1047)."""
    p = tokens.shape[0]
    valid_len = int(valid_len)
    pos = torch.arange(p, device=tokens.device)
    x = w.token_embd[tokens] + w.position_embd[:p] + w.token_type_row
    x = _ln(x, w.input_ln_w, w.input_ln_b, 1e-12)
    x = x @ w.embd_hidden_w.T + w.embd_hidden_b

    pad_bias = torch.zeros(p, device=x.device)
    pad_bias[valid_len:] = -torch.inf
    nh = cfg.n_attn_heads

    for _ in range(cfg.n_recurrence):
        for lw in w.albert_layers:
            res = x
            q = (x @ lw.q_w.T + lw.q_b).reshape(p, nh, -1).transpose(0, 1)
            k = (x @ lw.k_w.T + lw.k_b).reshape(p, nh, -1).transpose(0, 1)
            v = (x @ lw.v_w.T + lw.v_b).reshape(p, nh, -1).transpose(0, 1)
            logits = (q @ k.transpose(1, 2)) * cfg.albert_scale + pad_bias
            probs = torch.softmax(logits, dim=-1)
            a = (probs @ v).transpose(0, 1).reshape(p, -1)
            x = a @ lw.o_w.T + lw.o_b + res
            x = _ln(x, lw.attn_ln_w, lw.attn_ln_b, 1e-12)
            res = x
            h = F.gelu(x @ lw.ffn_w.T + lw.ffn_b, approximate="tanh")
            h = h @ lw.ffn_out_w.T + lw.ffn_out_b
            x = _ln(h + res, lw.out_ln_w, lw.out_ln_b, 1e-12)

    pw = w.prosody
    x = x @ pw.encode_w.T + pw.encode_b            # (P, 512)
    sty = style_half.expand(p, style_half.shape[-1])
    x = torch.cat([x, sty], dim=-1)                # (P, 640)
    for (fwd, bwd), ada in zip(pw.layers_lstm, pw.layers_ada):
        x = masked_bilstm(x, valid_len, fwd, bwd)  # (P, 512)
        gamma, beta = _ada_affine(style_half, ada)
        x = _ln(x, None, None, 1e-5) * (1.0 + gamma) + beta
        x = torch.cat([x, sty], dim=-1)
    hidden = x                                      # duration_hidden_states
    d = masked_bilstm(x, valid_len, *pw.duration_lstm)
    d = torch.sigmoid(d @ pw.duration_proj_w.T + pw.duration_proj_b)
    dur = torch.floor(d.sum(dim=-1) + 0.5)          # roundf (half away)
    dur = dur.clamp(1.0, 50.0)
    dur = dur * (pos < valid_len)                   # zero padded tokens
    return dur, hidden


# ---------------------------------------------------------------------------
# generation graph
# ---------------------------------------------------------------------------

def _expand_frames(values, durations, n_frames: int):
    """(P, C) per-token -> (F, C) per-frame via cumulative durations (a
    searchsorted gather in place of the reference's host-built 0/1
    expansion matrix, model.cpp:1265-1274)."""
    cum = torch.cumsum(durations, dim=0)
    frames = torch.arange(n_frames, device=values.device, dtype=cum.dtype)
    idx = torch.searchsorted(cum, frames, right=True)
    return values[idx.clamp(0, values.shape[0] - 1)]


def kokoro_generate(cfg: KokoroConfig, w: KokoroWeights, tokens: torch.Tensor,
                    valid_len: int, durations: torch.Tensor,
                    hidden: torch.Tensor, style_half: torch.Tensor,
                    style_half2: torch.Tensor, uv_rand: torch.Tensor,
                    n_frames: int):
    """Generation graph. n_frames is the frame bucket; the true frame count
    is sum(durations) <= n_frames. uv_rand is uniform [0, 1) noise of shape
    (harmonics+1, 2*n_frames*upsample_scale), drawn by the caller. Returns
    (waveform (n_frames*600,) whose first total*600 samples are valid,
    total).

    Parity: build_kokoro_graph (model.cpp:1141-1242)."""
    total = int(durations.sum())
    valid_len = int(valid_len)
    pw = w.prosody

    en = _expand_frames(hidden, durations, n_frames)            # (F, 640)
    x = masked_bilstm(en, total, *pw.shared_lstm)               # (F, 512)
    xT = _mask_t(x.T, total)                                    # (512, F)

    f0 = xT
    vf = total
    for blk in pw.f0_blocks:
        f0, vf = ada_res_block(f0, style_half, blk, vf)
    f0_curve = _mask_t(pw.f0_proj_w @ f0 + pw.f0_proj_b.reshape(-1, 1), vf)[0]

    nn = xT
    vn = total
    for blk in pw.n_blocks:
        nn, vn = ada_res_block(nn, style_half, blk, vn)
    n_curve = _mask_t(pw.n_proj_w @ nn + pw.n_proj_b.reshape(-1, 1), vn)[0]

    # text encoder (model.cpp:1196-1206)
    te = w.text_encoder
    hC = te.embd[tokens].T                                       # (128, P)
    for (gamma, beta, cw, cb) in te.convs:
        hC = conv1d(hC, cw, cb, padding=2)
        hC = F.leaky_relu(_ln(hC.T, gamma, beta, 1e-5), LRELU).T
        hC = _mask_t(hC, valid_len)
    enc = masked_bilstm(hC.T, valid_len, *te.lstm)               # (P, 512)
    asr = _mask_t(_expand_frames(enc, durations, n_frames).T, total)

    # decoder (model.cpp:1215-1231)
    dw = w.decoder
    f0_d = _mask_t(conv1d(f0_curve[None, :], dw.f0_conv_w, dw.f0_conv_b,
                          stride=2, padding=1), total)           # (64, F)
    n_d = _mask_t(conv1d(n_curve[None, :], dw.n_conv_w, dw.n_conv_b,
                         stride=2, padding=1), total)
    cur = torch.cat([asr, f0_d, n_d], dim=0)
    cur, vcur = ada_res_block(cur, style_half2, dw.encoder_block, total)
    asr_res = _mask_t(dw.asr_conv_w @ asr + dw.asr_conv_b.reshape(-1, 1), total)
    # every decoder block gets the residual concat; only the LAST block may
    # carry a pool (temporal x2), matching the reference loop
    # (model.cpp:1226-1230)
    for blk in dw.decoder_blocks:
        cat = torch.cat([cur, asr_res, f0_d, n_d], dim=0)
        cur, vcur = ada_res_block(cat, style_half2, blk, vcur)

    wav = _generator(cfg, dw.generator, cur, style_half2, f0_curve, vf,
                     uv_rand, vcur, total)
    return wav, total


def harmonic_phase(cfg: KokoroConfig, f0_curve, f0_valid: int):
    """The harmonic source's phase (harmonics+1, 2F): mod BEFORE cumsum
    (model.cpp:174-176). The running sum (up to 2 x 10240 steps) is
    dsp.scan_sum, whose float32 adds come in one fixed order on every
    device: the phase feeds sin() at hundreds of radians and, through the
    STFT's angles, the noise convolutions raw, so a few ulps here move the
    waveform."""
    nharm = cfg.harmonic_num + 1
    harm = dsp.true_div(torch.arange(nharm, device=f0_curve.device,
                                     dtype=torch.float32) + 1.0, cfg.sample_rate)
    ph = torch.remainder(f0_curve[None, :] * harm[:, None], 1.0)  # (9, 2F)
    ph = _mask_t(ph, f0_valid)                                     # keep cumsum clean
    ph = dsp.scan_sum(ph)
    return ph * (cfg.upsample_scale * 2.0 * np.pi)


def _generator(cfg: KokoroConfig, gw: GeneratorW, x, style, f0_curve,
               f0_valid: int, uv_rand, valid: int, total: int):
    nharm = cfg.harmonic_num + 1
    f2 = f0_curve.shape[0]                          # 2F
    ph = dsp.upscale_linear(harmonic_phase(cfg, f0_curve, f0_valid),
                            int(cfg.upsample_scale))                 # (9, 600F)
    f0_up = torch.repeat_interleave(f0_curve, int(cfg.upsample_scale))
    # the reference fills uniform [0,1) noise host-side (model.cpp:1255,
    # util.cpp:66-72); callers pass it in pre-drawn
    uv, noise = dsp.uv_noise(f0_up, nharm, uv_rand, cfg.voice_threshold,
                             cfg.noise_std, cfg.sin_amp)
    sing = (torch.sin(ph) * uv + noise).T                          # (600F, 9)
    har = dsp.rational_tanh(sing @ gw.m_source_w.T + gw.m_source_b)  # (600F, 1)
    har = _mask_t(har[:, 0], total * cfg.up_sampling_factor)

    window = dsp.hann_window(cfg.true_n_fft, device=x.device)
    spec = dsp.stft(har, window, cfg.true_n_fft, cfg.stft_hop)     # (2, Fr, 11)
    combined = torch.cat([spec[0], spec[1]], dim=-1).T              # (22, Fr)

    cur = x
    vcur = valid
    for i in range(len(gw.ups_w)):
        cur = _mask_t(F.leaky_relu(cur, 0.1), vcur)
        cur = conv_transpose_1d(cur, gw.ups_w[i], gw.ups_b[i],
                                stride=cfg.up_strides[i],
                                padding=cfg.up_paddings[i])
        vcur = vcur * cfg.up_strides[i]
        cur = _mask_t(cur, vcur)
        if i == len(gw.ups_w) - 1:
            # reflect-pad front by one (model.cpp:213-217)
            cur = torch.cat([cur[:, 1:2], cur], dim=-1)
            vcur = vcur + 1
        nb = gw.noise_blocks[i]
        ns = conv1d(combined, nb.conv_w, nb.conv_b,
                    stride=cfg.noise_conv_strides[i],
                    padding=cfg.noise_conv_paddings[i])
        ns = ns[:, : cur.shape[-1]]
        if ns.shape[-1] < cur.shape[-1]:
            ns = F.pad(ns, (0, cur.shape[-1] - ns.shape[-1]))
        ns = _mask_t(ns, vcur)
        ns = gen_res_block(ns, style, nb.res, cfg.noise_block_dilations[i],
                           cfg.noise_block_paddings[i], vcur)
        cur = cur + ns
        acc = None
        for k in range(cfg.n_kernels):
            j = i * cfg.n_kernels + k
            out = gen_res_block(cur, style, gw.res_blocks[j],
                                cfg.res_block_dilations[j],
                                cfg.res_block_paddings[j], vcur)
            acc = out if acc is None else acc + out
        cur = dsp.true_div(acc, cfg.n_kernels)

    cur = _mask_t(F.leaky_relu(cur, 0.01), vcur)
    cur = conv1d(cur, gw.out_conv_w, gw.out_conv_b,
                 padding=cfg.out_conv_padding)                     # (22, L)
    cur = _mask_t(cur, vcur)
    mag = torch.exp(cur[: cfg.post_n_fft])
    phase = torch.sin(cur[cfg.post_n_fft:])
    spec = torch.stack([mag.T, phase.T], dim=0)                    # (2, L, 11)
    wav = dsp.istft(spec, window, cfg.true_n_fft, cfg.stft_hop)
    wav = wav[: (f2 // 2) * cfg.up_sampling_factor]                # bucket samples
    return _mask_t(wav, total * cfg.up_sampling_factor)


# ---------------------------------------------------------------------------
# Loading (GGUF names per the reference converter, py-gguf
# kokoro_gguf_encoder.py, and kokoro_model::assign_* in model.cpp:394-773).
# Every tensor is dequantized to dense float32 on the device.
# ---------------------------------------------------------------------------

class _Loader:
    def __init__(self, r: GGUFReader, device):
        self.r = r
        self.device = device

    def __call__(self, name: str, shape=None) -> torch.Tensor:
        a = np.asarray(self.r.array(name), dtype=np.float32)
        if shape is not None:
            a = a.reshape(shape)
        return torch.tensor(a, device=self.device)

    def maybe(self, name: str, shape=None):
        return self(name, shape) if name in self.r.tensors else None

    def matrix(self, name: str):
        """A (C_out, C_in, 1) kernel as a (C_out, C_in) matrix, or None."""
        if name not in self.r.tensors:
            return None
        return self(name, self.r.tensors[name].shape[:2])

    def lstm(self, base: str) -> tuple:
        """'<base>.0.weights.N' 8-tensor layout: even=input, odd=recurrent,
        gate order I,F,G,O (kokoro converter prepare_lstm_tensor)."""
        def cell(kind_w: str, kind_b: str) -> LSTMWeights:
            ws = [self(f"{base}.0.{kind_w}.{i}") for i in range(8)]
            bs = [self(f"{base}.0.{kind_b}.{i}") for i in range(8)]
            return LSTMWeights(torch.cat(ws[0::2]), torch.cat(ws[1::2]),
                               torch.cat(bs[0::2]), torch.cat(bs[1::2]))
        return cell("weights", "biases"), cell("reverse_weights", "reverse_biases")

    def ada_ln(self, base: str, g="gamma_", b="beta_") -> AdaLayerNormW:
        return AdaLayerNormW(gamma_w=self(f"{base}{g}weight"),
                             gamma_b=self(f"{base}{g}bias"),
                             beta_w=self(f"{base}{b}weight"),
                             beta_b=self(f"{base}{b}bias"))

    def ada_res_block(self, base: str) -> AdaResBlockW:
        return AdaResBlockW(
            norm1=self.ada_ln(f"{base}.norm1_"),
            conv1_w=self(f"{base}.conv1_weight"),
            conv1_b=self(f"{base}.conv1_bias"),
            norm2=self.ada_ln(f"{base}.norm2_"),
            conv2_w=self(f"{base}.conv2_weight"),
            conv2_b=self(f"{base}.conv2_bias"),
            pool_w=self.maybe(f"{base}.pool_weight"),
            pool_b=self.maybe(f"{base}.pool_bias"),
            upsample_w=self.matrix(f"{base}.conv1x1_weight"),
            upsample_b=self.maybe(f"{base}.conv1x1_bias"),
        )

    def gen_res_block(self, base: str) -> GenResBlockW:
        n = range(3)
        return GenResBlockW(
            adain1=[self.ada_ln(f"{base}.{i}.", "gamma1_", "beta1_") for i in n],
            adain2=[self.ada_ln(f"{base}.{i}.", "gamma2_", "beta2_") for i in n],
            alpha1=[self(f"{base}.{i}.alpha1") for i in n],
            alpha2=[self(f"{base}.{i}.alpha2") for i in n],
            convs1_w=[self(f"{base}.{i}.convs1_weight") for i in n],
            convs1_b=[self(f"{base}.{i}.convs1_bias") for i in n],
            convs2_w=[self(f"{base}.{i}.convs2_weight") for i in n],
            convs2_b=[self(f"{base}.{i}.convs2_bias") for i in n],
        )


def load_kokoro_weights(r: GGUFReader, cfg: KokoroConfig,
                        device=None) -> KokoroWeights:
    """Every Kokoro tensor of the GGUF as dense float32 on `device`
    (default cuda, see common.default_device)."""
    t = _Loader(r, default_device(device))
    a = "kokoro.albert."
    albert_layers = []
    for i in range(cfg.n_layers):
        b = f"{a}layer.{i}."
        albert_layers.append(AlbertLayer(
            q_w=t(b + "q"), q_b=t(b + "q_bias"),
            k_w=t(b + "k"), k_b=t(b + "k_bias"),
            v_w=t(b + "v"), v_b=t(b + "v_bias"),
            o_w=t(b + "o"), o_b=t(b + "o_bias"),
            attn_ln_w=t(b + "ffn_norm"), attn_ln_b=t(b + "ffn_norm_bias"),
            ffn_w=t(b + "ffn"), ffn_b=t(b + "ffn_bias"),
            ffn_out_w=t(b + "ffn_out"), ffn_out_b=t(b + "ffn_out_bias"),
            out_ln_w=t(b + "attn_norm"), out_ln_b=t(b + "attn_norm_bias"),
        ))

    d = "kokoro.duration_predictor."
    n_dp = cfg.n_duration_prediction_layers
    prosody = DurationPredictorW(
        encode_w=t(d + "encode"), encode_b=t(d + "encode_bias"),
        layers_lstm=[t.lstm(f"{d}layers.{i * 2}.lstm") for i in range(n_dp)],
        layers_ada=[t.ada_ln(f"{d}layers.{i * 2 + 1}.") for i in range(n_dp)],
        duration_lstm=t.lstm(d + "duration_lstm"),
        duration_proj_w=t(d + "duration_proj"),
        duration_proj_b=t(d + "duration_proj_bias"),
        shared_lstm=t.lstm(d + "shared_lstm"),
        f0_blocks=[t.ada_res_block(f"{d}f0_blocks.{i}")
                   for i in range(cfg.f0_n_blocks)],
        n_blocks=[t.ada_res_block(f"{d}n_blocks.{i}")
                  for i in range(cfg.f0_n_blocks)],
        f0_proj_w=t.matrix(d + "f0_proj_kernel"), f0_proj_b=t(d + "f0_proj_bias"),
        n_proj_w=t.matrix(d + "n_proj_kernel"), n_proj_b=t(d + "n_proj_bias"),
    )

    te = "kokoro.text_encoder."
    text_encoder = TextEncoderW(
        embd=t(te + "embedding_weight"),
        convs=[(t(f"{te}layers.{i}.gamma"), t(f"{te}layers.{i}.beta"),
                t(f"{te}layers.{i}.weight"), t(f"{te}layers.{i}.bias"))
               for i in range(cfg.n_conv_layers)],
        lstm=t.lstm(te + "lstm"),
    )

    g = "kokoro.decoder.generator."
    generator = GeneratorW(
        m_source_w=t(g + "m_source_weight"), m_source_b=t(g + "m_source_bias"),
        ups_w=[t(f"{g}ups.{i}.weight") for i in range(cfg.n_upsamples)],
        ups_b=[t(f"{g}ups.{i}.bias") for i in range(cfg.n_upsamples)],
        noise_blocks=[NoiseBlockW(
            conv_w=t(f"{g}noise_blocks.{i}.conv_weight"),
            conv_b=t(f"{g}noise_blocks.{i}.conv_bias"),
            res=t.gen_res_block(f"{g}noise_blocks.{i}.resblock"))
            for i in range(cfg.n_noise_blocks)],
        res_blocks=[t.gen_res_block(f"{g}resblocks.{i}")
                    for i in range(cfg.n_res_blocks)],
        out_conv_w=t(g + "conv_post_weight"), out_conv_b=t(g + "conv_post_bias"),
    )

    dd = "kokoro.decoder."
    decoder = DecoderW(
        f0_conv_w=t(dd + "f0_conv_weight"), f0_conv_b=t(dd + "f0_conv_bias"),
        n_conv_w=t(dd + "n_conv_weight"), n_conv_b=t(dd + "n_conv_bias"),
        asr_conv_w=t.matrix(dd + "asr_conv_weight"),
        asr_conv_b=t(dd + "asr_conv_bias"),
        encoder_block=t.ada_res_block(dd + "encoder_block"),
        decoder_blocks=[t.ada_res_block(f"{dd}decoder_blocks.{i}")
                        for i in range(cfg.n_decoder_blocks)],
        generator=generator,
    )

    return KokoroWeights(
        token_embd=t(a + "token_embd"), position_embd=t(a + "position_embd"),
        token_type_row=t(a + "token_type_embd"),
        input_ln_w=t(a + "norm"), input_ln_b=t(a + "norm_bias"),
        embd_hidden_w=t(a + "embd"), embd_hidden_b=t(a + "embd_bias"),
        albert_layers=albert_layers,
        prosody=prosody,
        text_encoder=text_encoder,
        decoder=decoder,
    )


def load_voices(r: GGUFReader) -> dict:
    """kokoro.voice_tensors.<name> -> (510, 256) style packs (numpy, host:
    one row a chunk goes to the device)."""
    out = {}
    prefix = "kokoro.voice_tensors."
    for name in r.tensor_names():
        if name.startswith(prefix):
            v = np.array(r.array(name), dtype=np.float32)
            out[name[len(prefix):]] = v.reshape(v.shape[0], -1)
    return out


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

class KokoroRunner(TTSRunner):
    """Kokoro text -> 24 kHz waveform on the weights' device. Kokoro is
    feed-forward: `generate_stream` yields one waveform per <= 512-token
    text chunk."""

    arch = "kokoro"
    sample_rate = SAMPLE_RATE_KOKORO

    def __init__(self, cfg: KokoroConfig, weights: KokoroWeights,
                 tokenizer: SinglePassTokenizer, voices: dict,
                 phonemizer=None, device=None,
                 token_buckets=(64, 128, 256, 512),
                 frame_buckets=(250, 500, 1000, 2000, 4000, 10240)):
        self.device = default_device(device)
        self.cfg = cfg
        self.weights = weights
        self.tokenizer = tokenizer
        self.voices = voices
        self.phonemizer = phonemizer
        self.token_buckets = token_buckets
        self.frame_buckets = frame_buckets

    def list_voices(self):
        return sorted(self.voices.keys())

    def _bucket(self, n, buckets):
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _style(self, voice: str, n_tokens: int):
        """(style_half, style_half2) for a chunk of n_tokens: the voice
        pack's row clip(n_tokens - 3); the prosody half is the row's second
        half, the decoder's its first (model.cpp:1013, 1150, 1213)."""
        pack = self.voices[voice]
        row = pack[int(np.clip(n_tokens - 3, 0, pack.shape[0] - 1))]
        half = self.cfg.style_half_size
        return (torch.tensor(row[half:], device=self.device),
                torch.tensor(row[:half], device=self.device))

    def noise(self, shape, seed=None) -> torch.Tensor:
        """The harmonic source's uniform [0, 1) noise for one chunk, drawn
        on the runner's device from a generator seeded with `seed` (a
        random seed when None). Every draw of the runner goes through
        here."""
        gen = torch.Generator(device=self.device)
        if seed is None:
            gen.seed()
        else:
            gen.manual_seed(int(seed))
        return torch.rand(shape, generator=gen, device=self.device)

    def run_tokens(self, tokens, voice: str, seed=None) -> np.ndarray:
        """One chunk: tokens (with bos/eos) -> waveform (float32)."""
        cfg = self.cfg
        n = len(tokens)
        p = self._bucket(n, self.token_buckets)
        toks = torch.zeros(p, dtype=torch.long)
        toks[:n] = torch.as_tensor(tokens, dtype=torch.long)
        toks = toks.to(self.device)
        s_half, s_half2 = self._style(voice, n)
        dur, hidden = kokoro_duration(cfg, self.weights, toks, n, s_half)
        total = int(dur.sum())
        if total == 0:
            return np.zeros(0, np.float32)
        f = self._bucket(total, self.frame_buckets)
        uv_rand = self.noise(
            (cfg.harmonic_num + 1, int(2 * f * cfg.upsample_scale)), seed)
        wav, _ = kokoro_generate(cfg, self.weights, toks, n, dur, hidden,
                                 s_half, s_half2, uv_rand, n_frames=f)
        return wav[: total * cfg.up_sampling_factor].cpu().numpy()

    def tokenize_chunks(self, clauses):
        """Clause list -> <=512-token chunks (model.cpp:1340-1388)."""
        cfg = self.cfg
        chunks = []
        for clause in clauses:
            clause = clause.strip()
            if not clause:
                continue
            body = self.tokenizer.tokenize(clause)
            if len(body) + 1 <= cfg.max_context_length - 2:
                chunks.append([cfg.bos_token_id] + body + [cfg.eos_token_id])
                continue
            tokens = [cfg.bos_token_id] + body
            last_space, last_split = 1, 1
            for i in range(1, len(tokens)):
                if tokens[i] == cfg.space_token_id:
                    last_space = i
                cur_len = (i - last_split) + (len(chunks[-1]) if chunks else 0)
                if cur_len >= cfg.max_context_length - 1:
                    if last_space > last_split:
                        chunks.append([cfg.bos_token_id] +
                                      tokens[last_split:last_space] +
                                      [cfg.eos_token_id])
                        last_split = last_space
                    else:
                        chunks.append([cfg.bos_token_id] +
                                      tokens[last_split:i + 1] +
                                      [cfg.eos_token_id])
                        last_split = i + 1
            if last_split + 1 < len(tokens):
                chunks.append([cfg.bos_token_id] + tokens[last_split:] +
                              [cfg.eos_token_id])
        return chunks

    def generate(self, prompt: str, config: GenerationConfig | None = None) -> TTSResponse:
        """Parity: kokoro_runner::generate (model.cpp:1409-1460)."""
        parts = list(self._stream_parts(prompt, config))
        wav = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        return TTSResponse(wav.astype(np.float32), SAMPLE_RATE_KOKORO)

    def generate_stream(self, prompt: str, config: GenerationConfig | None = None):
        """One waveform per <=512-token text chunk as it is synthesized
        (the reference's clause chunk, model.cpp:1436-1449)."""
        for part in self._stream_parts(prompt, config):
            yield part.astype(np.float32)

    def _stream_parts(self, prompt: str, config: GenerationConfig | None = None):
        config = config or GenerationConfig()
        cfg = self.cfg
        voice = config.voice or "af_heart"
        if voice not in self.voices:
            if self.voices:
                voice = sorted(self.voices)[0]
            else:
                raise ValueError("no voices in checkpoint")
        # propagate the voice's language to the espeak phonemizer if in use
        # (reference propagate_voice_setting, model.cpp:1390-1407)
        if self.phonemizer is not None and \
                hasattr(self.phonemizer, "set_voice"):
            code = config.espeak_voice_id or get_espeak_id_from_kokoro_voice(voice)
            try:
                self.phonemizer.set_voice(code)
            except Exception:  # noqa: BLE001 — an unknown espeak voice keeps the last
                pass
        text = prompt
        for ch in ",;:":
            text = text.replace(ch, "--")
        text = text.replace("\n", " ")
        if self.phonemizer is not None:
            text = self.phonemizer.text_to_phonemes(text)
        if len(text) < cfg.max_context_length - 2:
            stripped = text
            for ch in ".!?":
                stripped = stripped.replace(ch, "")
            stripped = stripped.strip()
            if not stripped:
                return
            tokens = [cfg.bos_token_id] + self.tokenizer.tokenize(stripped) + \
                [cfg.eos_token_id]
            yield self.run_tokens(tokens, voice, seed=config.seed)
        else:
            clauses = []
            cur = ""
            for ch in text:
                cur += ch
                if ch in ".!?":
                    clauses.append(cur)
                    cur = ""
            if cur:
                clauses.append(cur)
            for chunk in self.tokenize_chunks(clauses):
                yield self.run_tokens(chunk, voice, seed=config.seed)
