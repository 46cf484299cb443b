"""Block-dequant matmul (Q4_0 / Q5_0 / Q8_0): QuantTensor and kernel K1.

`quant_matmul(x, w)` computes x @ W^T for a block-quantized weight W (N, K),
x (M, K) -> (M, N). On a CUDA tensor it launches the hand-written kernel
(csrc/quant_matmul.cu); on a CPU tensor it runs `quant_matmul_plain`, the
same function in plain PyTorch. As in the JAX package, M > 256 (prefill of
long prompts) goes to dequant + torch.matmul instead: those shapes are
compute-bound.

Layout (chosen for Hopper; the JAX package's transposed (K, N) layout and
2048-row half-split nibble packing were chosen for Mosaic): weights stay
row-major as ggml stores them, one row per output feature,
  codes  : (..., N, K) uint8 (Q4_0 0..15, Q5_0 0..31) or int8 (Q8_0), or
           Q4_0 nibble-packed (..., N, K/2) uint8 in ggml's own block_q4_0
           order (byte i of a 32-block: element i low, element i+16 high);
  scales : (..., N, K/32) float32 or bfloat16.
so a warp reads one weight row contiguously with 16-byte loads. The scale
dtype selects the numerics, as it does in the TPU kernel: float32 scales
give an exact f32 product; bfloat16 scales give the megastep `_dqdot`
rounding (weight dequantized in f32 and rounded to bf16, activation rounded
to bf16, f32 sums). Packing is exact: packed and unpacked give the same
values.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..common import default_device
from ..gguf import quants
from . import _build

QK = quants.QK
BIAS = {
    quants.GGML_TYPE_Q4_0: 8.0,
    quants.GGML_TYPE_Q5_0: 16.0,
    quants.GGML_TYPE_Q8_0: 0.0,
}
MAX_KERNEL_M = 256  # larger M goes to dequant + torch.matmul, as in JAX

# The JAX package's nibble packing splits K into 2048-row blocks (its
# quant_matmul.PACK_BLOCK); only `QuantTensor.from_transposed` reads it.
_TPU_PACK_BLOCK = 2048

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
KERNEL = _build.Kernel(
    "quant_matmul", "tts_quant_matmul",
    [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _vp])


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., N, K) Q4 codes 0..15 -> (..., N, K/2) uint8, ggml block order."""
    c = codes.to(torch.uint8).reshape(*codes.shape[:-1], -1, 2, QK // 2)
    return (c[..., 0, :] | (c[..., 1, :] << 4)).reshape(
        *codes.shape[:-1], codes.shape[-1] // 2)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_codes: (..., N, K/2) -> (..., N, K) uint8."""
    p = packed.reshape(*packed.shape[:-1], -1, QK // 2)
    return torch.stack([p & 15, p >> 4], dim=-2).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def is_packed(codes: torch.Tensor, scales: torch.Tensor) -> bool:
    return codes.shape[-1] * 2 == scales.shape[-1] * QK


def dequant(codes: torch.Tensor, scales: torch.Tensor, qtype: int,
            dtype=torch.float32) -> torch.Tensor:
    """Codes + scales -> dense W (..., N, K): (code - bias) * scale in f32.
    Bit-exact with the JAX package's `dequant_t` (transposed)."""
    if is_packed(codes, scales):
        codes = unpack_codes(codes)
    vals = codes.to(torch.float32) - BIAS[qtype]
    s = scales.to(torch.float32).repeat_interleave(QK, dim=-1)
    return (vals * s).to(dtype)


class QuantTensor:
    """A weight W (N, K) held block-quantized in the layout above.

    Leading dimensions stack layers or heads: codes (L, N, Kc), scales
    (L, N, K/32). `shape` is the logical (N, K) of one matrix.
    """

    __slots__ = ("codes", "scales", "qtype", "shape")

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, qtype: int):
        if qtype not in BIAS:
            raise ValueError(f"not a block-quantized type: {qtype}")
        self.codes = codes
        self.scales = scales
        self.qtype = qtype
        self.shape = (int(codes.shape[-2]), int(scales.shape[-1]) * QK)

    @property
    def is_packed(self) -> bool:
        return is_packed(self.codes, self.scales)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def __getitem__(self, i) -> "QuantTensor":
        """Index the leading (layer/head) dimensions."""
        return QuantTensor(self.codes[i], self.scales[i], self.qtype)

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.codes.to(device), self.scales.to(device),
                           self.qtype)

    @classmethod
    def from_planar(cls, codes: np.ndarray, scales: np.ndarray, qtype: int,
                    device=None) -> "QuantTensor":
        """From row-major planar arrays as gguf `unpack_planar` returns them
        (codes (N, K), fp16 scales (N, K/32)); scales become float32. On
        `device` (default cuda, see common.default_device)."""
        device = default_device(device)
        dt = np.int8 if qtype == quants.GGML_TYPE_Q8_0 else np.uint8
        return cls(torch.from_numpy(np.ascontiguousarray(codes.view(dt)))
                   .to(device),
                   torch.from_numpy(np.ascontiguousarray(
                       scales.astype(np.float32))).to(device),
                   qtype)

    @classmethod
    def from_transposed(cls, codes_t: np.ndarray, scales_t: np.ndarray,
                        qtype: int, device=None) -> "QuantTensor":
        """From the JAX package's device layout: codes_t (..., K, N) or Q4
        nibble-packed (..., K/2, N) in 2048-row half-split blocks; scales_t
        (..., K/32, N) float32 or bfloat16. Packed input comes back packed
        (in this layout's order), and the scale dtype is kept. On `device`
        (default cuda, see common.default_device)."""
        device = default_device(device)
        k = scales_t.shape[-2] * QK
        c = np.asarray(codes_t)
        packed = c.shape[-2] != k
        if packed:
            ci = c.view(np.uint8)
            parts = []
            for b0 in range(0, k, _TPU_PACK_BLOCK):
                h = min(_TPU_PACK_BLOCK, k - b0) // 2
                blk = ci[..., b0 // 2:b0 // 2 + h, :]
                parts += [blk & 15, blk >> 4]
            c = np.concatenate(parts, axis=-2)
        dt = np.int8 if qtype == quants.GGML_TYPE_Q8_0 else np.uint8
        codes = torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(c.astype(np.int8).view(dt), -1, -2)))
        s = np.ascontiguousarray(np.swapaxes(np.asarray(scales_t), -1, -2))
        if s.dtype.name == "bfloat16":   # numpy carries JAX's bf16 as ml_dtypes
            scales = torch.from_numpy(s.view(np.int16)).view(torch.bfloat16)
        else:
            scales = torch.from_numpy(s.astype(np.float32))
        qt = cls(codes.to(device), scales.to(device), qtype)
        return qt.pack() if packed else qt

    def pack(self) -> "QuantTensor":
        """Nibble-pack Q4_0 codes (2 per byte) — exact, halves the code
        bytes. No-op for other qtypes or codes already packed."""
        if self.qtype != quants.GGML_TYPE_Q4_0 or self.is_packed:
            return self
        return QuantTensor(pack_codes(self.codes), self.scales, self.qtype)

    def pad_n(self, align: int = 256) -> "QuantTensor":
        """Zero-pad N up to a multiple of `align`. Padded rows have zero
        scales -> exactly-zero outputs; callers slice them off."""
        pad = (-self.shape[0]) % align
        if pad == 0:
            return self
        return QuantTensor(
            torch.nn.functional.pad(self.codes, (0, 0, 0, pad)),
            torch.nn.functional.pad(self.scales, (0, 0, 0, pad)), self.qtype)

    def fast_lm_head(self, align: int = 256) -> "QuantTensor":
        """Prep an LM head for the decode loop, as the JAX package does: N
        padded to a multiple of `align` with zero scales (exactly-zero
        logits that callers slice off), bf16 scales (the `_dqdot`
        numerics), Q4 codes packed."""
        h = self.pad_n(align)
        return QuantTensor(h.codes, h.scales.to(torch.bfloat16),
                           h.qtype).pack()

    def fast_stacked_heads(self, n_heads: int, vocab: int,
                           align: int = 256) -> "QuantTensor":
        """Prep a stacked multi-codebook LM head (N = n_heads * vocab) for
        the decode loop, as the JAX package does: each head's vocab padded
        to `align` in place (so logits reshape to (n_heads, padded_vocab)
        and slice), bf16 scales (the `_dqdot` numerics), Q4 codes packed."""
        h = self
        if h.shape[0] == n_heads * vocab and vocab % align:
            vp = -(-vocab // align) * align

            def pad(t):
                t = t.reshape(n_heads, vocab, t.shape[-1])
                t = torch.nn.functional.pad(t, (0, 0, 0, vp - vocab))
                return t.reshape(n_heads * vp, t.shape[-1])

            h = QuantTensor(pad(h.codes), pad(h.scales), h.qtype)
        return QuantTensor(h.codes, h.scales.to(torch.bfloat16),
                           h.qtype).pack()

    def dense(self, dtype=torch.float32) -> torch.Tensor:
        """Materialize W (..., N, K)."""
        return dequant(self.codes, self.scales, self.qtype, dtype)

    def take_rows(self, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """W[ids, :] -> (len(ids), K), dequantizing only the gathered rows."""
        return dequant(self.codes[ids], self.scales[ids], self.qtype, dtype)


def quant_matmul_plain(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """K1's plain PyTorch version: x (M, K) -> (M, N) float32."""
    wd = w.dense()
    if w.scales.dtype == torch.bfloat16:
        return x.to(torch.bfloat16).float() @ wd.to(torch.bfloat16).float().T
    return x.float() @ wd.T


def quant_matmul_cuda(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """Launch K1 on the card: x (M, K) float32 contiguous, M <= 256."""
    dev = x.device
    _build.require(x, "x", device=dev, dtypes=(torch.float32,), ndim=2)
    _build.require(w.codes, "codes", device=dev,
                   dtypes=(torch.uint8, torch.int8), ndim=2)
    _build.require(w.scales, "scales", device=dev,
                   dtypes=(torch.float32, torch.bfloat16), ndim=2, align=2)
    m, k = x.shape
    n = w.shape[0]
    if k != w.shape[1] or w.scales.shape[0] != n or not 0 < m <= MAX_KERNEL_M:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs W {w.shape}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    KERNEL(_build.ptr(x), _build.ptr(w.codes), _build.ptr(w.scales),
           _build.ptr(out), m, n, k, w.qtype, int(w.is_packed),
           int(w.scales.dtype == torch.bfloat16), _build.stream_ptr(dev))
    return out


def quant_matmul(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """x (M, K) @ W^T -> (M, N) float32: K1 on the card, the plain version
    for CPU tensors, dequant + torch.matmul for M > 256."""
    if x.device.type == "cpu" or x.shape[0] > MAX_KERNEL_M:
        return quant_matmul_plain(x, w)
    return quant_matmul_cuda(x.float().contiguous(), w)
