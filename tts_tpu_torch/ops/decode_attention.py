"""Single-query decode attention over a KV cache: kernels K3 and K4.

K3: q (Hq, D) attends cache rows [0, pos] of k/v (Hkv, CTX, D), GQA with
n_rep = Hq / Hkv (kv head j serves q heads [j*n_rep, (j+1)*n_rep)), softmax
in float32 whatever the cache dtype. K4 does the same for B sequences at
once, each at its own position: q (B, Hq, D), k/v (B, Hkv, CTX, D) (or one
(Hkv, CTX, D) cache shared by every slot), pos (B,). On CUDA tensors
`decode_attention` / `decode_attention_batched` launch the hand-written
kernel (csrc/decode_attention.cu, one kernel for both: K3 is K4 with B = 1),
which reads only the rows up to each pos; on CPU tensors they run
`decode_attention_plain` / `decode_attention_batched_plain`, the masked
softmax the JAX package's `_xla_fallback` computes (vmapped for K4).

`pos` is an int32 tensor on the device (or a Python int on the CPU path):
the kernel reads it from device memory, so the decode loop never syncs the
host on it. The same kernel serves the Dia steps' cross-attention (every
row of the bucketed encoder K/V, and the padded tail folded in) through
its own entry, launched from ops/dia_megastep.py.

A call is one launch: the block that finishes a (slot, kv head)'s pages
last merges them, counted on an arrival counter that it resets to 0
(`arrivals`: one zeroed buffer per stream, made once, so no call adds a
memset launch).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

PAGE = 256  # rows per block in the kernel; scratch is sized by it
MIN_ARRIVALS = 4096  # counters made at least, so that buffers rarely grow

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_ARGS = [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
         _i32, ctypes.c_longlong, ctypes.c_longlong, _i32, ctypes.c_float, _vp]
# One C entry serves both; each path counts its own launches.
KERNEL = _build.Kernel("decode_attention", "tts_decode_attention", _ARGS)          # K3
KERNEL_BATCHED = _build.Kernel("decode_attention", "tts_decode_attention", _ARGS)  # K4


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


def decode_attention_batched_plain(q: torch.Tensor, kv_k: torch.Tensor,
                                   kv_v: torch.Tensor, pos,
                                   scale: float | None = None) -> torch.Tensor:
    """K4's plain PyTorch version -> (B, Hq, D) float32: per slot, the masked
    softmax of `decode_attention_plain`. kv_k/kv_v (B, Hkv, CTX, D), or
    (Hkv, CTX, D) shared by every slot; pos (B,), or one position shared."""
    shared_kv = kv_k.dim() == 3
    p = torch.as_tensor(pos).reshape(-1)
    return torch.stack([
        decode_attention_plain(
            q[s], kv_k if shared_kv else kv_k[s], kv_v if shared_kv else kv_v[s],
            p[s if p.numel() > 1 else 0], scale)
        for s in range(q.shape[0])])


_ARRIVALS: dict = {}
_ARRIVALS_LOCK = threading.Lock()


def arrivals(device, n: int) -> torch.Tensor:
    """At least n zeroed int32 arrival counters for the kernels launched on
    `device`'s current stream (n = B * Hq covers any call). Every launch
    leaves them zero and launches on one stream run in order, so one buffer
    per (device, stream) serves every call; it is zeroed once, when made or
    grown."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        key = ("cuda", index, torch.cuda.current_stream(index).cuda_stream)
    else:
        key = (dev.type, dev.index, 0)
    with _ARRIVALS_LOCK:
        buf = _ARRIVALS.get(key)
        if buf is None or buf.numel() < n:
            size = max(n, MIN_ARRIVALS, 0 if buf is None else 2 * buf.numel())
            buf = _ARRIVALS[key] = torch.zeros(size, dtype=torch.int32,
                                               device=dev)
        return buf


def attention_scratch(b: int, hq: int, ctx: int, d: int, device):
    """The kernel's partial-state scratch for up to b slots of hq heads over
    ctx rows: (part_ml, part_acc). A caller that launches often allocates it
    once and passes it to every call."""
    n_pages = -(-ctx // PAGE)
    return (torch.empty((b * hq * n_pages * 2,), dtype=torch.float32, device=device),
            torch.empty((b * hq * n_pages * d,), dtype=torch.float32, device=device))


def _launch(kernel, q, kv_k, kv_v, pos, scale, out, scratch):
    """Validate and launch the kernel for q (B, Hq, D); see
    decode_attention_batched_cuda."""
    dev = q.device
    _build.require(kv_k, "kv_k", device=dev,
                   dtypes=(torch.bfloat16, torch.float32))
    _build.require(kv_v, "kv_v", device=dev, dtypes=(kv_k.dtype,))
    _build.require(pos, "pos", device=dev, dtypes=(torch.int32,), align=4)
    if q.dtype != torch.float32 or q.dim() != 3:
        raise ValueError(f"q must be (B, Hq, D) float32, got {q.dtype} "
                         f"{tuple(q.shape)}")
    b, hq, d = q.shape
    shared_kv = kv_k.dim() == 3
    hkv, ctx, dk = kv_k.shape[-3:]
    if (q.stride(2) != 1 or q.stride(1) != d or dk != d
            or kv_v.shape != kv_k.shape or kv_k.dim() not in (3, 4)
            or (not shared_kv and kv_k.shape[0] != b) or hq % hkv
            or d not in (64, 128) or pos.numel() not in (1, b)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} strides "
                         f"{q.stride()}, k/v {tuple(kv_k.shape)}, pos "
                         f"{tuple(pos.shape)}")
    if out is None:
        out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    elif out.shape != (b, hq, d) or not out.is_contiguous() or out.device != dev:
        raise ValueError(f"out must be a contiguous {(b, hq, d)} tensor on {dev}")
    part_ml, part_acc = scratch if scratch is not None else \
        attention_scratch(b, hq, ctx, d, dev)
    n_pages = -(-ctx // PAGE)
    if part_ml.numel() < b * hq * n_pages * 2 or \
            part_acc.numel() < b * hq * n_pages * d:
        raise ValueError("decode_attention: scratch too small")
    kernel(_build.ptr(q), _build.ptr(kv_k), _build.ptr(kv_v), _build.ptr(pos),
           _build.ptr(out), _build.ptr(part_ml), _build.ptr(part_acc),
           _build.ptr(arrivals(dev, b * hq)), b, hq,
           hq // hkv, ctx, d, int(kv_k.dtype == torch.bfloat16), q.stride(0),
           0 if shared_kv else hkv * ctx * d, int(pos.numel() > 1),
           float(_scale(q, scale)), _build.stream_ptr(dev))
    return out


def decode_attention_cuda(q: torch.Tensor, kv_k: torch.Tensor,
                          kv_v: torch.Tensor, pos: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """Launch K3 on the card. q (Hq, D) float32; kv_k/kv_v (Hkv, CTX, D)
    bfloat16 or float32, D 64 or 128; pos a one-element int32 tensor."""
    if q.dim() != 2 or kv_k.dim() != 3 or pos.numel() != 1:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, "
                         f"k/v {tuple(kv_k.shape)}, pos {tuple(pos.shape)}")
    return _launch(KERNEL, q[None], kv_k, kv_v, pos, scale, None, None)[0]


def decode_attention(q, kv_k, kv_v, pos, scale: float | None = None):
    """Dispatch: K3 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, kv_k, kv_v, pos, scale)
    return decode_attention_cuda(q, kv_k, kv_v, pos, scale)


def decode_attention_batched_cuda(q: torch.Tensor, kv_k: torch.Tensor,
                                  kv_v: torch.Tensor, pos: torch.Tensor,
                                  scale: float | None = None, *,
                                  out: torch.Tensor | None = None,
                                  scratch=None) -> torch.Tensor:
    """Launch K4 on the card. q (B, Hq, D) float32 whose slots may sit at any
    stride (each slot's heads contiguous: a view of a wider qkv row works);
    kv_k/kv_v (B, Hkv, CTX, D), or (Hkv, CTX, D) shared by every slot,
    bfloat16 or float32, D 64 or 128; pos (B,) int32, or one element shared.
    `out` (B, Hq, D) and `scratch` (attention_scratch) are allocated when
    not given."""
    return _launch(KERNEL_BATCHED, q, kv_k, kv_v, pos, scale, out, scratch)


def decode_attention_batched(q, kv_k, kv_v, pos, scale: float | None = None):
    """Dispatch: K4 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_batched_plain(q, kv_k, kv_v, pos, scale)
    return decode_attention_batched_cuda(q, kv_k, kv_v, pos, scale)
