"""DAC (Descript Audio Codec) decoder in plain PyTorch.

Parity: reference src/decoder/dac_model.{h,cpp} + shared blocks in
src/decoder/general_neural_audio_codec.cpp; the JAX package's
`models/codec/dac.py`. 44.1 kHz, 512 samples/token, 9 codebooks. The JAX
package pads the frame count to a few length buckets (XLA compiles static
shapes) and masks the tail so that padded equals unpadded; eager PyTorch
decodes the exact length instead.

Structure (dac_model.cpp:146-170, general_neural_audio_codec.cpp:133-172):
  embd   = sum_i out_proj_i(codebook_i[codes_i])         (quantize layers)
  x      = conv1d(embd, k=7, p=3)
  4x layer: snake -> conv_transpose(stride,pad) -> bias
            -> 3 residual units (dilation 3^j, pad 3^(j+1))
  x      = snake -> conv1d(k=7, p=3) -> tanh

Convolutions are float32 without TF32 (common.strict_fp32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple

import numpy as np
import torch

from ...common import default_device, strict_fp32
from ...gguf.reader import GGUFReader
from ...ops.conv import conv1d, conv_transpose_1d
from ...ops.dsp import snake_1d


class ResidualUnitWeights(NamedTuple):
    in_alpha: Any
    in_w: Any; in_b: Any
    out_alpha: Any
    out_w: Any; out_b: Any


class CodecLayerWeights(NamedTuple):
    alpha: Any
    up_w: Any; up_b: Any            # conv_transpose kernel/bias
    units: List[ResidualUnitWeights]
    noise_w: Any = None             # 1x1 conv of the noise branch (SNAC only)


class QuantizeLayerWeights(NamedTuple):
    codebook: Any                   # (codebook_size, dim)
    out_w: Any; out_b: Any          # 1x1 conv


class DACWeights(NamedTuple):
    quantizers: List[QuantizeLayerWeights]
    in_w: Any; in_b: Any
    layers: List[CodecLayerWeights]
    final_alpha: Any
    out_w: Any; out_b: Any


@dataclasses.dataclass(eq=False)
class DACConfig:
    n_layers: int = 4
    n_heads: int = 9
    up_sampling_factor: int = 512
    strides: tuple = (8, 8, 4, 2)
    paddings: tuple = (4, 4, 2, 1)

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "DACConfig":
        c = cls()
        c.n_heads = int(r.first_key(["parler-tts.decoder.output_heads",
                                     "output_heads", "dia.decoder.output_heads"],
                                    c.n_heads))
        c.up_sampling_factor = int(r.first_key(
            ["dac.up_sampling_factor", "up_sampling_factor",
             "dac.up_scaling_factor"], c.up_sampling_factor))
        strides, paddings = [], []
        i = 0
        while True:
            s = r.first_key([f"dac.dac_layer_stride_{i}", f"dac_layer_stride_{i}"])
            p = r.first_key([f"dac.dac_layer_padding_{i}", f"dac_layer_padding_{i}"])
            if s is None or p is None:
                break
            strides.append(int(s)); paddings.append(int(p))
            i += 1
        if strides:
            c.strides, c.paddings = tuple(strides), tuple(paddings)
            c.n_layers = len(strides)
        return c


def _mask(x, valid):
    """Zero the padded tail: (C, T) with columns >= valid zeroed. Masking
    after every conv makes a bucket-padded decode equal to an exact-length
    decode on the valid prefix (the JAX package's `_mask`)."""
    if valid is None:
        return x
    return x * (torch.arange(x.shape[-1], device=x.device) < valid)[None, :]


def residual_unit(x, u: ResidualUnitWeights, dilation: int, padding: int,
                  valid=None):
    """snake -> (depthwise if grouped) dilated conv -> snake -> 1x1 conv -> +res
    (general_neural_audio_codec.cpp:133-149)."""
    h = snake_1d(x, u.in_alpha)
    groups = x.shape[0] if u.in_w.shape[1] == 1 else 1
    h = conv1d(h, u.in_w, u.in_b, padding=padding, dilation=dilation,
               groups=groups)
    h = snake_1d(_mask(h, valid), u.out_alpha)
    return _mask(conv1d(h, u.out_w, u.out_b), valid) + x


def codec_layer(x, lw: CodecLayerWeights, stride: int, padding: int,
                noise=None, valid=None):
    """snake -> conv_transpose -> noise branch (when the layer has one and
    `noise` is given) -> residual units (general_neural_audio_codec.cpp:
    151-164). `valid` is the input's valid length; returns (h, the output's
    valid length valid * stride), as the codec kernels have k = 2s, p = s/2.
    DAC passes no noise, and `valid` only for a padded decode."""
    h = snake_1d(x, lw.alpha)
    h = conv_transpose_1d(h, lw.up_w, lw.up_b, stride=stride, padding=padding)
    v_out = None if valid is None else valid * stride
    h = _mask(h, v_out)
    if lw.noise_w is not None and noise is not None:
        h = h + _mask(conv1d(h, lw.noise_w), v_out) * noise
    for j, u in enumerate(lw.units):
        h = residual_unit(h, u, dilation=3 ** j, padding=3 ** (j + 1),
                          valid=v_out)
    return h, v_out


@torch.no_grad()
def dac_decode(cfg: DACConfig, w: DACWeights, codes: torch.Tensor,
               valid=None) -> torch.Tensor:
    """codes (T, n_heads) integer -> waveform (T * up_sampling_factor,).

    With `valid` (the true frame count, an int), frames past it are padding:
    the decode masks them after the quantizers' sum, the in-conv, each codec
    layer and the out-conv, so the first valid * up samples equal an
    unpadded decode of the first `valid` frames (the JAX package's
    `dac_decode(..., valid=...)`)."""
    codes = codes.long()
    x = 0
    for i, q in enumerate(w.quantizers):
        z = q.codebook[codes[:, i]]                    # (T, dim)
        x = x + conv1d(z.T, q.out_w, q.out_b)          # 1x1 -> (latent, T)
    x = _mask(x, valid)
    x = _mask(conv1d(x, w.in_w, w.in_b, padding=3), valid)
    for lw, s, p in zip(w.layers, cfg.strides, cfg.paddings):
        x, valid = codec_layer(x, lw, s, p, valid=valid)
    x = snake_1d(x, w.final_alpha)
    x = _mask(conv1d(x, w.out_w, w.out_b, padding=3), valid)
    return torch.tanh(x)[0]


def load_dac_weights(r: GGUFReader, cfg: DACConfig, prefix: str = "audio_encoder.",
                     device=None) -> DACWeights:
    """The decoder's weights on `device` (default cuda, see
    common.default_device).

    GGUF names per the reference converter (py-gguf dac_gguf_encoder.py):
    initial.*, decoder_block.{1..4}.final.*, decoder_block.N.residual_unit.M.
    res.{initial,final}.*, final.*, quantizers.N.{codebook.weight,out_proj.*}.
    Conv biases are stored (C,); alphas (1, C, 1) or (C, 1)."""
    device = default_device(device)

    def get(name):
        return torch.from_numpy(np.array(r.array(name), dtype=np.float32)).to(device)

    def alpha(name):
        return get(name).reshape(-1, 1)  # broadcast over time, per channel

    def bias(name):
        return get(name).reshape(-1)

    quantizers = []
    for i in range(cfg.n_heads):
        b = f"{prefix}quantizers.{i}."
        quantizers.append(QuantizeLayerWeights(
            codebook=get(b + "codebook.weight"),
            out_w=get(b + "out_proj.weight"),
            out_b=bias(b + "out_proj.bias")))
    layers = []
    for i in range(1, cfg.n_layers + 1):
        b = f"{prefix}decoder_block.{i}."
        units = []
        for j in range(3):
            ub = b + f"residual_unit.{j}.res."
            units.append(ResidualUnitWeights(
                in_alpha=alpha(ub + "initial.alpha"),
                in_w=get(ub + "initial.weight"),
                in_b=bias(ub + "initial.bias"),
                out_alpha=alpha(ub + "final.alpha"),
                out_w=get(ub + "final.weight"),
                out_b=bias(ub + "final.bias")))
        layers.append(CodecLayerWeights(
            alpha=alpha(b + "final.alpha"), up_w=get(b + "final.weight"),
            up_b=bias(b + "final.bias"), units=units))
    return DACWeights(
        quantizers=quantizers,
        in_w=get(prefix + "initial.weight"), in_b=bias(prefix + "initial.bias"),
        layers=layers, final_alpha=alpha(prefix + "final.alpha"),
        out_w=get(prefix + "final.weight"), out_b=bias(prefix + "final.bias"))


class DACRunner:
    """Decode wrapper (reference dac_runner::run, dac_model.cpp:172-212):
    numpy codes in, numpy waveform out, float32 convolutions on the
    weights' device."""

    def __init__(self, cfg: DACConfig, weights: DACWeights):
        strict_fp32()
        self.cfg = cfg
        self.weights = weights
        self.device = weights.in_w.device

    def decode(self, codes: np.ndarray) -> np.ndarray:
        c = torch.from_numpy(np.asarray(codes, np.int64)).to(self.device)
        return dac_decode(self.cfg, self.weights, c).cpu().numpy()


def stream_segment(dac: DACRunner, codes: np.ndarray, emitted: int,
                   done: bool, margin: int):
    """Margin-overlap vocoding of a growing code sequence (the JAX
    package's streaming scheme): the waveform of frames [emitted, ready)
    of codes (T, n_heads), where ready is every frame once generation is
    done and all but the last `margin` before (delay-undone frames near the
    end may still change). The span is decoded with `margin` frames of
    context on each side, so that the convolutions see their true
    neighbourhood and the concatenated segments match one decode of the
    whole away from the seams. Returns (waveform or None, ready)."""
    total = codes.shape[0]
    ready = total if done else max(0, total - margin)
    if ready <= emitted:
        return None, emitted
    lo = max(0, emitted - margin)
    hi = total if done else min(total, ready + margin)
    up = dac.cfg.up_sampling_factor
    seg = np.asarray(dac.decode(codes[lo:hi]), np.float32)
    return seg[(emitted - lo) * up:(ready - lo) * up], ready
