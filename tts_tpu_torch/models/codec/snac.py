"""SNAC (Scale Neural Audio Codec, 24 kHz) decoder in plain PyTorch.

Parity: reference src/decoder/snac_model.{h,cpp}; the JAX package's
`models/codec/snac.py`. Differences from DAC: multi-rate codebook heads
repeat-interleaved (x4/x2/x1), depthwise in-conv + 1x1 up-conv, per-layer
Gaussian noise injection (noise length = layer output length), grouped
residual units. As in the JAX package the frame count is padded to a few
length buckets with the tail masked (padded equals unpadded on the valid
prefix), because the noise a decode draws when no noise layers are given
depends on the bucket. The noise comes from numpy
(`np.random.default_rng(seed)`), the JAX package's generator, so both
packages decode with the same numbers.

Convolutions are float32 without TF32 (common.strict_fp32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple

import numpy as np
import torch

from ...common import default_device, strict_fp32
from ...gguf.reader import GGUFReader
from ...ops.conv import conv1d
from ...ops.dsp import snake_1d
from .dac import (CodecLayerWeights, QuantizeLayerWeights, ResidualUnitWeights,
                  _mask, codec_layer)


@dataclasses.dataclass(eq=False)
class SNACConfig:
    n_layers: int = 4
    n_heads: int = 3
    up_sampling_factor: int = 512
    embd: int = 768
    repeats: tuple = (4, 2, 1)
    noise_steps: tuple = (8, 64, 256, 512)
    strides: tuple = (8, 8, 4, 2)
    paddings: tuple = (4, 4, 2, 1)
    groupings: tuple = (1, 1, 1, 1)

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "SNACConfig":
        c = cls()
        c.n_heads = int(r.get("snac.audio_token_channels", c.n_heads))
        c.up_sampling_factor = int(r.get("snac.up_sampling_factor",
                                         c.up_sampling_factor))
        s, p, gr = [], [], []
        i = 0
        while True:
            sv = r.get(f"snac.snac_layer_stride_{i}")
            pv = r.get(f"snac.snac_layer_padding_{i}")
            gv = r.get(f"snac.snac_layer_grouping_{i}")
            if sv is None:
                break
            s.append(int(sv)); p.append(int(pv)); gr.append(int(gv))
            i += 1
        if s:
            c.strides, c.paddings, c.groupings = tuple(s), tuple(p), tuple(gr)
            c.n_layers = len(s)
            # per-layer noise length = layer output length = cumprod(strides)
            # (the reference hardcodes {8,64,256,512} for strides 8,8,4,2 —
            # snac_model.h:19)
            c.noise_steps = tuple(int(x) for x in np.cumprod(s))
        return c


class SNACWeights(NamedTuple):
    quantizers: List[QuantizeLayerWeights]
    in_w: Any; in_b: Any                 # depthwise k7
    up_w: Any; up_b: Any                 # 1x1
    layers: List[CodecLayerWeights]      # with noise_w set
    final_alpha: Any
    out_w: Any; out_b: Any


@torch.no_grad()
def snac_decode(cfg: SNACConfig, w: SNACWeights, codes_fine, codes_mid,
                codes_coarse, noise, valid=None) -> torch.Tensor:
    """codes_coarse (T/4,), codes_mid (T/2,), codes_fine (T,) -> waveform
    (T * up_sampling_factor,). noise (sum(noise_steps) * T,) standard
    normal, sliced per layer like the reference (snac_model.cpp:147-151).
    With `valid` (the true frame count) the decode of a padded T equals
    that of the first `valid` frames."""
    t = codes_fine.shape[0]
    x = 0
    for i, (q, codes) in enumerate(zip(w.quantizers,
                                       (codes_coarse, codes_mid, codes_fine))):
        z = conv1d(q.codebook[codes.long()].T, q.out_w, q.out_b)  # (embd, T/rep)
        if cfg.repeats[i] > 1:
            z = torch.repeat_interleave(z, cfg.repeats[i], dim=-1)
        x = x + z
    x = _mask(x, valid)
    x = _mask(conv1d(x, w.in_w, w.in_b, padding=3, groups=x.shape[0]), valid)
    x = _mask(conv1d(x, w.up_w, w.up_b), valid)
    off = 0
    v = valid
    for l, lw in enumerate(w.layers):
        ln = cfg.noise_steps[l] * t
        x, v = codec_layer(x, lw, cfg.strides[l], cfg.paddings[l],
                           noise=noise[off:off + ln][None, :], valid=v)
        off += ln
    x = snake_1d(x, w.final_alpha)
    x = _mask(conv1d(x, w.out_w, w.out_b, padding=3), v)
    return torch.tanh(x)[0]


def load_snac_weights(r: GGUFReader, cfg: SNACConfig, prefix: str = "snac.",
                      device=None) -> SNACWeights:
    """The decoder's weights on `device` (default cuda, see
    common.default_device). Residual units are read under either tensor-name
    layout the JAX package accepts: `residual_unit.{j}.res.{initial,final}.*`
    or the flat `{j}.{in,out}_*`."""
    device = default_device(device)
    names = r.tensors

    def get(name):
        return torch.from_numpy(np.array(r.array(name), dtype=np.float32)).to(device)

    def alpha(name):
        return get(name).reshape(-1, 1)

    def bias(name):
        return get(name).reshape(-1)

    quantizers = []
    for i in range(cfg.n_heads):
        b = f"{prefix}quantizers.{i}."
        quantizers.append(QuantizeLayerWeights(
            codebook=get(b + "codebook.weight"),
            out_w=get(b + "out_proj.weight"), out_b=bias(b + "out_proj.bias")))
    layers = []
    for i in range(cfg.n_layers):
        b = f"{prefix}layers.{i}."
        units = []
        for j in range(3):
            ub = b + f"residual_unit.{j}.res."
            if ub + "initial.alpha" in names:
                units.append(ResidualUnitWeights(
                    in_alpha=alpha(ub + "initial.alpha"),
                    in_w=get(ub + "initial.weight"),
                    in_b=bias(ub + "initial.bias"),
                    out_alpha=alpha(ub + "final.alpha"),
                    out_w=get(ub + "final.weight"),
                    out_b=bias(ub + "final.bias")))
            else:
                ub2 = b + f"{j}."
                units.append(ResidualUnitWeights(
                    in_alpha=alpha(ub2 + "in_alpha"),
                    in_w=get(ub2 + "in_weight"), in_b=bias(ub2 + "in_bias"),
                    out_alpha=alpha(ub2 + "out_alpha"),
                    out_w=get(ub2 + "out_weight"),
                    out_b=bias(ub2 + "out_bias")))
        flat = b + "alpha" in names
        noise_name = b + "noise_weight"
        layers.append(CodecLayerWeights(
            alpha=alpha(b + "alpha" if flat else b + "final.alpha"),
            up_w=get(b + "weight" if b + "weight" in names else b + "final.weight"),
            up_b=bias(b + "bias" if b + "bias" in names else b + "final.bias"),
            units=units,
            noise_w=get(noise_name) if noise_name in names else None))
    return SNACWeights(
        quantizers=quantizers,
        in_w=get(prefix + "in.weight"), in_b=bias(prefix + "in.bias"),
        up_w=get(prefix + "up.weight"), up_b=bias(prefix + "up.bias"),
        layers=layers, final_alpha=alpha(prefix + "alpha_out"),
        out_w=get(prefix + "final.weight"), out_b=bias(prefix + "final.bias"))


def make_noise_layers(cfg: SNACConfig, seed, t_max: int) -> list:
    """Per-layer noise arrays laid out by ABSOLUTE frame position: layer l
    holds noise_steps[l] values per fine frame, for t_max frames, so a
    segment decoded at a frame offset sees exactly the noise a full decode
    would (the JAX package's position-stable layout, same numpy draws)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(ns * t_max).astype(np.float32)
            for ns in cfg.noise_steps]


class SNACRunner:
    """Parity: snac_runner::run (snac_model.cpp:181-209): numpy token lists
    in, numpy waveform out, float32 convolutions on the weights' device."""

    def __init__(self, cfg: SNACConfig, weights: SNACWeights,
                 buckets=(32, 64, 128, 256, 512, 1200)):
        strict_fp32()
        self.cfg = cfg
        self.weights = weights
        self.buckets = buckets
        self.device = weights.in_w.device

    def decode(self, heads: list, seed=None, *, noise_layers=None,
               frame_offset: int = 0) -> np.ndarray:
        """heads = [coarse (T/4), mid (T/2), fine (T)] token id lists.

        noise_layers/frame_offset: position-stable noise (make_noise_layers)
        — a segment decoded at `frame_offset` reuses the noise a full decode
        from frame 0 gives those frames. Without them, the noise is drawn
        from `np.random.default_rng(seed)` for the padded length."""
        cfg = self.cfg
        t = len(heads[2])
        tb = next((b for b in self.buckets if t <= b), t)
        tb = max(tb - tb % 4, 4)
        if tb < t:
            tb = t + (-t) % 4
        fine = np.zeros(tb, np.int64); fine[:t] = heads[2]
        mid = np.zeros(tb // 2, np.int64); mid[: len(heads[1])] = heads[1]
        coarse = np.zeros(tb // 4, np.int64); coarse[: len(heads[0])] = heads[0]
        if noise_layers is not None:
            parts = []
            for ns, full in zip(cfg.noise_steps, noise_layers):
                seg = full[ns * frame_offset: ns * (frame_offset + tb)]
                if seg.shape[0] < ns * tb:
                    seg = np.concatenate(
                        [seg, np.zeros(ns * tb - seg.shape[0], np.float32)])
                parts.append(seg)
            noise = np.concatenate(parts)
        else:
            rng = np.random.default_rng(seed)
            noise = rng.standard_normal(
                sum(cfg.noise_steps) * tb).astype(np.float32)
        dev = self.device
        wav = snac_decode(cfg, self.weights, torch.from_numpy(fine).to(dev),
                          torch.from_numpy(mid).to(dev),
                          torch.from_numpy(coarse).to(dev),
                          torch.from_numpy(noise).to(dev), t)
        return wav[: t * cfg.up_sampling_factor].cpu().numpy()
