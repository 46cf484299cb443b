"""Scaled dot-product attention in plain PyTorch (matmul + softmax), the
JAX package's `ops/attention.sdpa`. Used for prefill and the per-matmul
path's cross-attention; the decode step's attention is kernel K3
(ops/decode_attention.py)."""
from __future__ import annotations

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: torch.Tensor | None = None,
         scale: float | None = None) -> torch.Tensor:
    """q (..., H, Tq, D), k/v (..., H, Tk, D); bias broadcasts to
    (..., H, Tq, Tk) and is added to the scaled logits (-inf masks).
    Softmax in float32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float())
