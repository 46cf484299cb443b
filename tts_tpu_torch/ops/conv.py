"""1-D convolutions with torch semantics, channels-first (C, T) or
(B, C, T), weights (C_out, C_in/groups, K) / (C_in, C_out/groups, K) as
torch.nn.Conv1d / ConvTranspose1d store them. Plain PyTorch: the JAX
package has no Pallas kernel here. Float32 convolutions run without TF32
(common.strict_fp32)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _batched(x):
    return (x[None], True) if x.dim() == 2 else (x, False)


def conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """torch.nn.functional.conv1d on (C_in, T) or (B, C_in, T)."""
    xb, squeeze = _batched(x)
    out = F.conv1d(xb.float(), w.float(), bias, stride=stride,
                   padding=padding, dilation=dilation, groups=groups)
    return out[0] if squeeze else out


def conv_transpose_1d(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None, stride: int = 1,
                      padding: int = 0, groups: int = 1,
                      output_padding: int = 0) -> torch.Tensor:
    """torch.nn.functional.conv_transpose1d on (C_in, T) or (B, C_in, T).
    Output length (T-1)*stride - 2*padding + K + output_padding."""
    xb, squeeze = _batched(x)
    out = F.conv_transpose1d(xb.float(), w.float(), bias, stride=stride,
                             padding=padding, output_padding=output_padding,
                             groups=groups)
    return out[0] if squeeze else out
