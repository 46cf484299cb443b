"""1-D convolutions with torch semantics, channels-first (C, T) or
(B, C, T), weights (C_out, C_in/groups, K) / (C_in, C_out/groups, K) as
torch.nn.Conv1d / ConvTranspose1d store them. Plain PyTorch: the JAX
package has no Pallas kernel here. Float32 convolutions run without TF32
(common.strict_fp32). With bf16 weights (the DAC's TTS_TPU_DAC_DTYPE=
bfloat16, models/codec/dac.bf16_conv_weights) the activations are cast to
bf16 and the convolution runs in bf16, as the JAX package's conv1d pulls
them to its weights' dtype; torch returns its output in bf16, which is
widened back to float32 before the float32 bias is added."""
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
    if w.dtype == torch.bfloat16:
        out = _bias(F.conv1d(xb.to(w.dtype), w, None, stride=stride,
                             padding=padding, dilation=dilation,
                             groups=groups), bias)
    else:
        out = F.conv1d(xb.float(), w.float(), bias, stride=stride,
                       padding=padding, dilation=dilation, groups=groups)
    return out[0] if squeeze else out


def _bias(out, bias):
    """A bf16 convolution's output in float32, plus the float32 bias."""
    out = out.float()
    return out if bias is None else out + bias.float()[None, :, None]


def conv_transpose_1d(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None, stride: int = 1,
                      padding: int = 0, groups: int = 1,
                      output_padding: int = 0) -> torch.Tensor:
    """torch.nn.functional.conv_transpose1d on (C_in, T) or (B, C_in, T).
    Output length (T-1)*stride - 2*padding + K + output_padding."""
    xb, squeeze = _batched(x)
    if w.dtype == torch.bfloat16:
        out = _bias(F.conv_transpose1d(xb.to(w.dtype), w, None, stride=stride,
                                       padding=padding,
                                       output_padding=output_padding,
                                       groups=groups), bias)
    else:
        out = F.conv_transpose1d(xb.float(), w.float(), bias, stride=stride,
                                 padding=padding,
                                 output_padding=output_padding, groups=groups)
    return out[0] if squeeze else out
