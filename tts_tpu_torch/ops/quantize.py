"""GGUF block quantization (Q4_0 / Q5_0 / Q8_0) on the card.

`quantize_blocks(x, qtype)` turns float values into the raw bytes of ggml
blocks, as `gguf.quants.quantize` does in numpy: on a CUDA tensor it
launches the hand-written kernel (csrc/quantize.cu, one warp per 32-value
block); on a CPU tensor it runs `quantize_blocks_plain`, the same function
in plain PyTorch. F16 needs no kernel: it is a cast, on the tensor's
device.

The counterpart of the JAX package's host data path for its quantizer
(`tts_tpu/native.py` quantize, threaded host C++). Both follow numpy's
`quants.quantize`; the host C++ parts from it in a few blocks (Q8_0's
`roundf`, an FMA its compiler may form), the kernel and the plain version
do not. A kernel that fails to build or launch raises: nothing falls back
to the host.
"""
from __future__ import annotations

import ctypes

import torch

from ..gguf import quants
from . import _build

QK = quants.QK

KERNEL = _build.Kernel(
    "quantize", "tts_quantize_blocks",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_void_p])


def _blocks(x: torch.Tensor) -> torch.Tensor:
    if x.numel() % QK:
        raise ValueError(f"{x.numel()} values are not whole blocks of {QK}")
    return x.reshape(-1, QK)


def _scale_bytes(d: torch.Tensor) -> torch.Tensor:
    """(nb,) f32 scales -> (nb, 2) uint8: fp16, round to nearest even."""
    return d.to(torch.float16).view(torch.uint8).reshape(-1, 2)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b, one IEEE division an element. (On the card torch divides by
    a Python scalar as a times 1 / b, which rounds otherwise.)"""
    return torch.div(a, torch.full_like(a, b))


def _inverse(d: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """1 / d where `keep`, else 0 (numpy's `where(keep, 1 / where(d == 0, 1,
    d), 0)`), one IEEE division."""
    ones = torch.ones_like(d)
    return torch.where(keep, torch.div(ones, torch.where(d == 0, ones, d)),
                       torch.zeros_like(d))


def _nibbles(q: torch.Tensor) -> torch.Tensor:
    """(nb, 32) codes -> (nb, 16) bytes: low nibble q[j], high q[j + 16]."""
    return (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)


def quantize_blocks_plain(x: torch.Tensor, qtype: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: x (any shape, a whole number of
    32-value blocks) -> (n_blocks * block bytes,) uint8, on x's device.
    Each product and sum is a separate op (no FMA), the absmax's index the
    first maximum (torch.argmax)."""
    if not quants.is_quantized(qtype):
        raise ValueError(f"no block format for ggml type {qtype}")
    x = _blocks(x.float())
    if qtype == quants.GGML_TYPE_Q8_0:
        amax = x.abs().amax(dim=-1)
        d = _div(amax, 127.0)
        s = torch.mul(x, _inverse(d, d > 0)[:, None])
        q = torch.mul(torch.sign(s), torch.floor(torch.add(s.abs(), 0.5)))
        q = q.clamp(-128, 127).to(torch.int8).view(torch.uint8)
        return torch.cat([_scale_bytes(d), q], dim=1).reshape(-1)
    q4 = qtype == quants.GGML_TYPE_Q4_0
    idx = torch.argmax(x.abs(), dim=-1, keepdim=True)
    d = _div(x.gather(-1, idx)[:, 0], -8.0 if q4 else -16.0)
    s = torch.add(torch.mul(x, _inverse(d, d != 0)[:, None]), 8.5 if q4 else 16.5)
    q = s.clamp(0.0, 15.0 if q4 else 31.0).to(torch.uint8)
    if q4:
        return torch.cat([_scale_bytes(d), _nibbles(q)], dim=1).reshape(-1)
    bits = ((q >> 4) & 1).to(torch.int64) << torch.arange(32, device=x.device)
    qh = bits.sum(dim=-1, keepdim=True)
    qh = ((qh >> torch.arange(0, 32, 8, device=x.device)) & 0xFF).to(torch.uint8)
    return torch.cat([_scale_bytes(d), qh, _nibbles(q)], dim=1).reshape(-1)


def quantize_blocks_cuda(x: torch.Tensor, qtype: int) -> torch.Tensor:
    """Launch the kernel: x float32 contiguous on the card, a whole number of
    32-value blocks."""
    if not quants.is_quantized(qtype):
        raise ValueError(f"no block format for ggml type {qtype}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quantize_blocks_cuda: x is on {dev}, not on the card")
    _build.require(x, "x", device=dev, dtypes=(torch.float32,), align=4)
    nb = _blocks(x).shape[0]
    out = torch.empty(nb * quants.block_info(qtype)[1], dtype=torch.uint8,
                      device=dev)
    KERNEL(_build.ptr(x), _build.ptr(out), nb, qtype, _build.stream_ptr(dev))
    return out


def quantize_blocks(x: torch.Tensor, qtype: int) -> torch.Tensor:
    """x -> the raw bytes of ggml type `qtype` (Q4_0 / Q5_0 / Q8_0 blocks, or
    F16 values), (n_bytes,) uint8 on x's device: the kernel on the card, the
    plain version for CPU tensors."""
    if qtype == quants.GGML_TYPE_F16:
        return x.float().reshape(-1).to(torch.float16).view(torch.uint8)
    if x.device.type == "cpu":
        return quantize_blocks_plain(x, qtype)
    return quantize_blocks_cuda(x.float().contiguous(), qtype)
