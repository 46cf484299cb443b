"""Q4_0 blocks to float32, and the lower precisions of the controls."""
from __future__ import annotations

import torch


def dequant(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """ggml Q4_0: codes (..., N, K/2) uint8, byte j of a 32-value block
    holding value j in its low nibble and value j + 16 in its high one;
    scales (..., N, K/32). Value = (nibble - 8) * scale, float32."""
    lead = codes.shape[:-1]
    c = codes.reshape(*lead, -1, 16)
    vals = torch.cat([c & 15, c >> 4], dim=-1).float() - 8.0
    return (vals * scales.float()[..., None]).reshape(*lead, -1)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 and back: the control's precision, the
    nearest below the bfloat16 that the program's GEMVs and caches use."""
    return x.to(torch.float8_e4m3fn).float()


ROUNDINGS = {"float32": identity, "fp8": fp8}


def strict_fp32() -> None:
    """Full float32 products and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
