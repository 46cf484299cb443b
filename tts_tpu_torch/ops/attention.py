"""Attention helpers in plain PyTorch: scaled dot-product attention (the JAX
package's `ops/attention.sdpa`), NeoX RoPE (`rope_freqs`,
`apply_rope_neox`), the llama prefill's GQA attention and T5's relative
position buckets (`t5_relative_buckets`, `t5_position_bias`). Used for
prefill, the T5 encoder and the per-matmul paths; the decode steps'
attention is kernel K3 (ops/decode_attention.py)."""
from __future__ import annotations

import math

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


def rope_freqs(dim: int, base: float = 10000.0,
               freq_factors: torch.Tensor | None = None,
               device=None) -> torch.Tensor:
    """Inverse frequencies (dim // 2,) float32. llama3-style per-frequency
    factors divide inv_freq (reference orpheus/model.cpp:274-277
    `rope_frequencies`)."""
    if freq_factors is not None:
        device = freq_factors.device
    exp = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv = 1.0 / (torch.tensor(base, dtype=torch.float32, device=device) ** exp)
    if freq_factors is not None:
        inv = inv / freq_factors.float()
    return inv


def apply_rope_neox(x: torch.Tensor, positions: torch.Tensor,
                    inv_freq: torch.Tensor) -> torch.Tensor:
    """NeoX/llama RoPE: rotate the (x[i], x[i + d/2]) pairs.

    x (..., T, D); positions (T,) (any integer or float dtype, on x's
    device); inv_freq (D/2,) from `rope_freqs`. Angles in float32."""
    d = x.shape[-1]
    ang = positions.float()[:, None] * inv_freq[None, :]       # (T, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def gqa_prefill(q: torch.Tensor, kv_k: torch.Tensor, kv_v: torch.Tensor,
                bias: torch.Tensor, scale: float) -> torch.Tensor:
    """The llama prefill's grouped-query attention over the whole cache, as
    the JAX package's `_llama_step` computes it for T > 1: q (Hq, T, D),
    kv_k/kv_v (Hkv, CTX, D), q head h reads kv head h // (Hq / Hkv); bias
    (T, CTX) is added to the scaled logits (the causal -inf mask). Softmax in
    float32. Returns (Hq, T, D) float32."""
    hq, t, d = q.shape
    hkv = kv_k.shape[0]
    qs = q.float().reshape(hkv, hq // hkv, t, d)
    logits = torch.einsum("hgqd,hkd->hgqk", qs, kv_k.float()) * scale + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hgqk,hkd->hgqd", probs,
                        kv_v.float()).reshape(hq, t, d)


def t5_relative_buckets(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        num_buckets: int = 32, max_distance: int = 128,
                        bidirectional: bool = True) -> torch.Tensor:
    """Log-binned relative-position bucket ids (Tq, Tk), HF T5's formula, as
    the JAX package computes it: float32 logs, truncated to integers."""
    rel = k_pos[None, :] - q_pos[:, None]
    buckets = torch.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        buckets = torch.where(rel > 0, n, 0).to(rel.dtype)
        rel = rel.abs()
    else:
        rel = -rel.clamp(max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact) * (n - max_exact)).to(rel.dtype)
    large = large.clamp(max=n - 1)
    return buckets + torch.where(is_small, rel, large)


def t5_position_bias(embed: torch.Tensor, tq: int, tk: int,
                     num_buckets: int = 32,
                     max_distance: int = 128) -> torch.Tensor:
    """(H, Tq, Tk) additive attention bias from the bucket embedding
    (buckets, H)."""
    dev = embed.device
    b = t5_relative_buckets(torch.arange(tq, device=dev),
                            torch.arange(tk, device=dev), num_buckets,
                            max_distance)
    return embed[b].permute(2, 0, 1)
