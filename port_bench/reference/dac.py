"""The DAC 44 kHz decoder: codes (T, 9) -> waveform (T * 512,).

Each codebook's vectors through its 1x1 projection, summed; a k7
convolution; four blocks of snake, a transposed convolution (kernel 2s,
stride s, padding s/2) and three residual units (snake, k7 convolution at
dilation 1 / 3 / 9, snake, 1x1 convolution, added back); snake, a k7
convolution to one channel, tanh. Snake(x) = x + sin^2(alpha x) / alpha.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _snake(x, alpha):
    return x + torch.sin(alpha * x).square() / alpha


@torch.no_grad()
def decode(w: dict, dac: dict, frames: torch.Tensor) -> torch.Tensor:
    """w: the decoder's tensors (weights.make_dac's names); frames (T, 9)
    integer codes on w's device. float32 (TF32 as the caller set it)."""
    frames = frames.long()
    x = 0
    for i in range(dac["n_codebooks"]):
        b = f"quantizers.{i}."
        z = w[b + "codebook.weight"][frames[:, i]].T[None]      # (1, 8, T)
        x = x + F.conv1d(z, w[b + "out_proj.weight"], w[b + "out_proj.bias"])
    x = F.conv1d(x, w["initial.weight"], w["initial.bias"], padding=3)
    for i, s in enumerate(dac["upsampling_ratios"]):
        b = f"decoder_block.{i + 1}."
        x = _snake(x, w[b + "final.alpha"])
        x = F.conv_transpose1d(x, w[b + "final.weight"], w[b + "final.bias"],
                               stride=s, padding=s // 2)
        for j in range(3):
            u = f"{b}residual_unit.{j}.res."
            r = _snake(x, w[u + "initial.alpha"])
            r = F.conv1d(r, w[u + "initial.weight"], w[u + "initial.bias"],
                         padding=3 ** (j + 1), dilation=3 ** j)
            r = _snake(r, w[u + "final.alpha"])
            x = x + F.conv1d(r, w[u + "final.weight"], w[u + "final.bias"])
    x = _snake(x, w["final.alpha"])
    x = F.conv1d(x, w["final.weight"], w["final.bias"], padding=3)
    return torch.tanh(x)[0, 0]
