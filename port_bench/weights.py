"""Weights made on the card from the seed, in a few large calls, in the
types a Q4_0 checkpoint is served in: Q4_0 blocks as the port loads them
(codes nibble-packed in ggml's block order, (..., N, K/2) uint8; scales
with fp16 values held as float32, (..., N, K/32)) and float32 tensors.

The harness hands the same tensors to the program (wrapped in its
containers, no copy) and to the plain reference (which dequantizes the
blocks itself). `checksum` lets the judge see that nothing wrote to them.
"""
from __future__ import annotations

import torch


class Maker:
    """Draws from one torch.Generator on `device`, in call order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def q4(self, lead: tuple, n: int, k: int, lo: float = 0.002,
           hi: float = 0.006, zero_rows_from: int | None = None):
        """(codes, scales) of a stack of Q4_0 matrices (*lead, n, k)."""
        codes = torch.randint(0, 256, (*lead, n, k // 2), generator=self.gen,
                              device=self.device, dtype=torch.uint8)
        scales = (torch.rand((*lead, n, k // 32), generator=self.gen,
                             device=self.device) * (hi - lo) + lo)
        scales = scales.half().float()
        if zero_rows_from is not None:
            scales[..., zero_rows_from:, :] = 0.0
        return codes, scales

    def normal(self, shape: tuple, std: float, mean: float = 0.0):
        return torch.randn(shape, generator=self.gen,
                           device=self.device) * std + mean

    def fan_in(self, shape: tuple, fan: int, gain: float = 1.0):
        return self.normal(shape, gain / fan ** 0.5)


def make_dac(m: Maker, dac: dict) -> dict:
    """A DAC 44 kHz decoder's tensors at the published widths, float32,
    named as the port's loader names them under `audio_encoder.`. Kernels
    are scaled by their fan-in so that activations stay of order one
    through the stack, and the last convolution so that the waveform is of
    speech-like amplitude (~0.13 RMS, peaks ~0.5), inside tanh's range."""
    ch, latent = dac["decoder_channels"], dac["latent_dim"]
    t = {}

    def alpha(name, c):
        t[name] = m.normal((c, 1), 0.05).abs() + 0.5

    t["initial.weight"] = m.fan_in((ch[0], latent, 7), latent * 7)
    t["initial.bias"] = m.normal((ch[0],), 0.02)
    for i, s in enumerate(dac["upsampling_ratios"]):
        cin, cout = ch[i], ch[i + 1]
        b = f"decoder_block.{i + 1}."
        alpha(b + "final.alpha", cin)
        t[b + "final.weight"] = m.fan_in((cin, cout, 2 * s), 2 * cin)
        t[b + "final.bias"] = m.normal((cout,), 0.02)
        for j in range(3):
            ub = f"{b}residual_unit.{j}.res."
            alpha(ub + "initial.alpha", cout)
            t[ub + "initial.weight"] = m.fan_in((cout, cout, 7), cout * 7, 0.5)
            t[ub + "initial.bias"] = m.normal((cout,), 0.02)
            alpha(ub + "final.alpha", cout)
            t[ub + "final.weight"] = m.fan_in((cout, cout, 1), cout, 0.5)
            t[ub + "final.bias"] = m.normal((cout,), 0.02)
    alpha("final.alpha", ch[-1])
    t["final.weight"] = m.fan_in((1, ch[-1], 7), ch[-1] * 7, DAC_OUT_GAIN)
    t["final.bias"] = m.normal((1,), 0.01)
    for i in range(dac["n_codebooks"]):
        b = f"quantizers.{i}."
        t[b + "codebook.weight"] = m.normal(
            (dac["codebook_size"], dac["codebook_dim"]), 1.0)
        t[b + "out_proj.weight"] = m.fan_in(
            (latent, dac["codebook_dim"], 1), dac["codebook_dim"] * 9)
        t[b + "out_proj.bias"] = m.normal((latent,), 0.02)
    return t


DAC_OUT_GAIN = 0.05   # the last convolution's gain: waveform RMS ~0.13


def checksum(raw: dict) -> float:
    """A sum over every tensor of `raw` (blocks' codes and scales
    included), to see after the window that nothing wrote to them."""
    total = 0.0
    for v in raw.values():
        if isinstance(v, dict):
            total += checksum(v)
            continue
        for t in (v if isinstance(v, tuple) else (v,)):
            total += float(t.double().sum()) if t.is_floating_point() \
                else float(t.long().sum())
    return total
