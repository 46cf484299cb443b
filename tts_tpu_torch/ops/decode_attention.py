"""Single-query decode attention over a KV cache: kernel K3.

q (Hq, D) attends cache rows [0, pos] of k/v (Hkv, CTX, D), GQA with
n_rep = Hq / Hkv (kv head j serves q heads [j*n_rep, (j+1)*n_rep)), softmax
in float32 whatever the cache dtype. On a CUDA tensor `decode_attention`
launches the hand-written kernel (csrc/decode_attention.cu), which reads
only the rows up to pos; on a CPU tensor it runs `decode_attention_plain`,
the masked softmax the JAX package's `_xla_fallback` computes.

`pos` is an int32 tensor on the device (or a Python int on the CPU path):
the kernel reads it from device memory, so the decode loop never syncs the
host on it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

PAGE = 256  # rows per block in the kernel; scratch is sized by it

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
KERNEL = _build.Kernel(
    "decode_attention", "tts_decode_attention",
    [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
     ctypes.c_float, _vp])


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def decode_attention_plain(q: torch.Tensor, kv_k: torch.Tensor,
                           kv_v: torch.Tensor, pos,
                           scale: float | None = None) -> torch.Tensor:
    """K3's plain PyTorch version -> (Hq, D) float32."""
    n_rep = q.shape[0] // kv_k.shape[0]
    kk = kv_k.float().repeat_interleave(n_rep, dim=0)
    vv = kv_v.float().repeat_interleave(n_rep, dim=0)
    logits = torch.einsum("hd,hkd->hk", q.float(), kk) * _scale(q, scale)
    mask = torch.arange(kv_k.shape[1], device=q.device) <= pos
    logits = logits.masked_fill(~mask[None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hk,hkd->hd", probs, vv)


def decode_attention_cuda(q: torch.Tensor, kv_k: torch.Tensor,
                          kv_v: torch.Tensor, pos: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """Launch K3 on the card. q (Hq, D) float32; kv_k/kv_v (Hkv, CTX, D)
    bfloat16 or float32, D 64 or 128; pos a one-element int32 tensor."""
    dev = q.device
    _build.require(q, "q", device=dev, dtypes=(torch.float32,), ndim=2)
    _build.require(kv_k, "kv_k", device=dev,
                   dtypes=(torch.bfloat16, torch.float32), ndim=3)
    _build.require(kv_v, "kv_v", device=dev, dtypes=(kv_k.dtype,), ndim=3)
    _build.require(pos, "pos", device=dev, dtypes=(torch.int32,), align=4)
    hq, d = q.shape
    hkv, ctx, dk = kv_k.shape
    if (dk != d or kv_v.shape != kv_k.shape or hq % hkv or d not in (64, 128)
            or pos.numel() != 1):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k/v {tuple(kv_k.shape)}, pos {tuple(pos.shape)}")
    n_pages = -(-ctx // PAGE)
    out = torch.empty((hq, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((hq, n_pages, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((hq, n_pages, d), dtype=torch.float32, device=dev)
    KERNEL(_build.ptr(q), _build.ptr(kv_k), _build.ptr(kv_v), _build.ptr(pos),
           _build.ptr(out), _build.ptr(part_ml), _build.ptr(part_acc), hq,
           hq // hkv, ctx, d, int(kv_k.dtype == torch.bfloat16),
           float(_scale(q, scale)), _build.stream_ptr(dev))
    return out


def decode_attention(q, kv_k, kv_v, pos, scale: float | None = None):
    """Dispatch: K3 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, kv_k, kv_v, pos, scale)
    return decode_attention_cuda(q, kv_k, kv_v, pos, scale)
