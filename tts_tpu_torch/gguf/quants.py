"""GGML block-quantization formats: Q4_0 / Q5_0 / Q8_0 / F16 / F32.

Host-side (numpy) quantize/dequantize for the GGUF reader/writer, plus the
planar unpacking that the port's block-dequant matmul (ops/quant_matmul.py)
loads from. A copy of the JAX package's module: the port imports nothing
from it.

Format parity with ggml (reference uses `ggml_quantize_chunk`,
examples/quantize/quantize_impl.cpp:82-166). Block layouts:

  Q4_0: 32 elems/block; fp16 scale d + 16 bytes. nibble j -> elem j (low),
        elem j+16 (high); value = (q - 8) * d.
  Q5_0: 32 elems/block; fp16 d + u32 qh + 16 bytes qs. 5th bit of elem j is
        qh bit j; value = (q - 16) * d.
  Q8_0: 32 elems/block; fp16 d + 32 int8; value = q * d.

Quantization uses ggml's reference rounding: d = max_abs / {-8,-16,127} with
sign-carrying max (the element with the largest magnitude, keeping its sign),
q = round-to-nearest of x/d clamped to the quant range.
"""
from __future__ import annotations

import numpy as np

QK = 32  # block size for all Q*_0 formats

# ggml_type ids (subset we support), matching ggml's enum values so GGUF
# files round-trip with the reference toolchain.
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q8_0 = 8
GGML_TYPE_I8 = 24
GGML_TYPE_I16 = 25
GGML_TYPE_I32 = 26
GGML_TYPE_I64 = 27
GGML_TYPE_F64 = 28

TYPE_NAMES = {
    GGML_TYPE_F32: "F32",
    GGML_TYPE_F16: "F16",
    GGML_TYPE_Q4_0: "Q4_0",
    GGML_TYPE_Q5_0: "Q5_0",
    GGML_TYPE_Q8_0: "Q8_0",
    GGML_TYPE_I8: "I8",
    GGML_TYPE_I16: "I16",
    GGML_TYPE_I32: "I32",
    GGML_TYPE_I64: "I64",
    GGML_TYPE_F64: "F64",
}
NAME_TO_TYPE = {v: k for k, v in TYPE_NAMES.items()}

# (block_size_elems, block_size_bytes)
_BLOCK_INFO = {
    GGML_TYPE_F32: (1, 4),
    GGML_TYPE_F16: (1, 2),
    GGML_TYPE_Q4_0: (QK, 2 + QK // 2),   # 18 bytes
    GGML_TYPE_Q5_0: (QK, 2 + 4 + QK // 2),  # 22 bytes
    GGML_TYPE_Q8_0: (QK, 2 + QK),        # 34 bytes
    GGML_TYPE_I8: (1, 1),
    GGML_TYPE_I16: (1, 2),
    GGML_TYPE_I32: (1, 4),
    GGML_TYPE_I64: (1, 8),
    GGML_TYPE_F64: (1, 8),
}


def block_info(ggml_type: int) -> tuple[int, int]:
    return _BLOCK_INFO[ggml_type]


def nbytes_for(ggml_type: int, n_elems: int) -> int:
    bs, bb = _BLOCK_INFO[ggml_type]
    if n_elems % bs != 0:
        raise ValueError(f"{n_elems} elements not divisible by block size {bs}")
    return n_elems // bs * bb


def is_quantized(ggml_type: int) -> bool:
    return ggml_type in (GGML_TYPE_Q4_0, GGML_TYPE_Q5_0, GGML_TYPE_Q8_0)


def _signed_absmax(x: np.ndarray) -> np.ndarray:
    """Per-row element with the largest |value|, keeping its sign (ggml style)."""
    idx = np.argmax(np.abs(x), axis=-1)
    return np.take_along_axis(x, idx[..., None], axis=-1)[..., 0]


def _round_half_away(x: np.ndarray) -> np.ndarray:
    # ggml uses roundf() == round half away from zero, not numpy banker's.
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """float array (n,) with n % 32 == 0 -> raw Q8_0 bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    amax = np.max(np.abs(x), axis=-1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(_round_half_away(x * inv[:, None]), -128, 127).astype(np.int8)
    nb = x.shape[0]
    out = np.zeros((nb, 2 + QK), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blk = np.frombuffer(bytes(raw), dtype=np.uint8)[: n_elems // QK * 34].reshape(-1, 34)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32)
    q = blk[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)[:n_elems]


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    m = _signed_absmax(x)
    d = (m / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(x * inv[:, None] + 8.5, 0.0, 15.0).astype(np.uint8)  # ggml MIN(15, x+8.5) trunc
    nb = x.shape[0]
    out = np.zeros((nb, 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    return out.reshape(-1)


def dequantize_q4_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blk = np.frombuffer(bytes(raw), dtype=np.uint8)[: n_elems // QK * 18].reshape(-1, 18)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blk[:, 2:]
    lo = (qs & 0x0F).astype(np.int32) - 8
    hi = (qs >> 4).astype(np.int32) - 8
    vals = np.concatenate([lo, hi], axis=-1).astype(np.float32) * d
    return vals.reshape(-1)[:n_elems]


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    m = _signed_absmax(x)
    d = (m / -16.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(x * inv[:, None] + 16.5, 0.0, 31.0).astype(np.uint8)
    nb = x.shape[0]
    qh = np.zeros(nb, dtype=np.uint32)
    for j in range(16):
        qh |= ((q[:, j] >> 4).astype(np.uint32)) << j
        qh |= ((q[:, j + 16] >> 4).astype(np.uint32)) << (j + 16)
    out = np.zeros((nb, 22), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    out[:, 2:6] = qh.view(np.uint8).reshape(nb, 4)
    out[:, 6:] = ((q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)).astype(np.uint8)
    return out.reshape(-1)


def dequantize_q5_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    blk = np.frombuffer(bytes(raw), dtype=np.uint8)[: n_elems // QK * 22].reshape(-1, 22)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32)
    qh = blk[:, 2:6].copy().view(np.uint32)[:, 0]
    qs = blk[:, 6:]
    j = np.arange(16, dtype=np.uint32)
    hi_lo = ((qh[:, None] >> j) & 1).astype(np.int32) << 4
    hi_hi = ((qh[:, None] >> (j + 16)) & 1).astype(np.int32) << 4
    lo = ((qs & 0x0F).astype(np.int32) | hi_lo) - 16
    hi = ((qs >> 4).astype(np.int32) | hi_hi) - 16
    vals = np.concatenate([lo, hi], axis=-1).astype(np.float32) * d
    return vals.reshape(-1)[:n_elems]


def quantize(x: np.ndarray, ggml_type: int) -> np.ndarray:
    """Flattened float data -> raw bytes in the given ggml type."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if ggml_type == GGML_TYPE_F32:
        return flat.view(np.uint8).copy()
    if ggml_type == GGML_TYPE_F16:
        return flat.astype(np.float16).view(np.uint8).copy()
    if ggml_type == GGML_TYPE_Q8_0:
        return quantize_q8_0(flat)
    if ggml_type == GGML_TYPE_Q4_0:
        return quantize_q4_0(flat)
    if ggml_type == GGML_TYPE_Q5_0:
        return quantize_q5_0(flat)
    raise ValueError(f"cannot quantize to {TYPE_NAMES.get(ggml_type, ggml_type)}")


def dequantize(raw: np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    """Raw bytes -> float32 array of n_elems."""
    if ggml_type == GGML_TYPE_F32:
        return np.frombuffer(bytes(raw), dtype=np.float32, count=n_elems).copy()
    if ggml_type == GGML_TYPE_F16:
        return np.frombuffer(bytes(raw), dtype=np.float16, count=n_elems).astype(np.float32)
    if ggml_type == GGML_TYPE_F64:
        return np.frombuffer(bytes(raw), dtype=np.float64, count=n_elems).astype(np.float32)
    if ggml_type == GGML_TYPE_I32:
        return np.frombuffer(bytes(raw), dtype=np.int32, count=n_elems).astype(np.float32)
    if ggml_type == GGML_TYPE_Q8_0:
        return dequantize_q8_0(raw, n_elems)
    if ggml_type == GGML_TYPE_Q4_0:
        return dequantize_q4_0(raw, n_elems)
    if ggml_type == GGML_TYPE_Q5_0:
        return dequantize_q5_0(raw, n_elems)
    raise ValueError(f"cannot dequantize {TYPE_NAMES.get(ggml_type, ggml_type)}")


# ---------------------------------------------------------------------------
# Device-friendly "planar" layout.
#
# The interleaved ggml block layout (scale + packed nibbles per 18/22/34-byte
# block) mixes 2-byte scales into the code stream. For on-device dequant each
# quantized tensor is re-packed once at load time into parallel arrays:
#   Q4_0: codes  uint8  (rows, cols)   values 0..15 (bias 8 applied in kernel)
#   Q5_0: codes  uint8  (rows, cols)   values 0..31 (bias 16)
#   Q8_0: codes  int8   (rows, cols)
#   scales float (rows, cols // 32)  (one fp16-derived scale per block)
# This keeps the quantized payload intact bit-for-bit (codes+scales are a
# lossless unpacking of the blocks) while giving the kernels stride-1,
# 16-byte-aligned access. See ops/quant_matmul.py.
# ---------------------------------------------------------------------------


def unpack_planar(raw: np.ndarray, ggml_type: int, shape: tuple[int, ...]):
    """Raw ggml blocks -> (codes, scales) planar arrays.

    shape is the logical tensor shape with the contiguous (row) dimension
    LAST (numpy convention). Returns codes with that same shape and scales
    with shape[:-1] + (shape[-1] // 32,).
    """
    n_elems = int(np.prod(shape))
    cols = shape[-1]
    if cols % QK != 0:
        raise ValueError(f"row length {cols} not divisible by {QK}")
    if ggml_type == GGML_TYPE_Q8_0:
        blk = np.frombuffer(bytes(raw), dtype=np.uint8)[: n_elems // QK * 34].reshape(-1, 34)
        d = blk[:, :2].copy().view(np.float16)
        codes = blk[:, 2:].copy().view(np.int8).reshape(shape)
    elif ggml_type == GGML_TYPE_Q4_0:
        blk = np.frombuffer(bytes(raw), dtype=np.uint8)[: n_elems // QK * 18].reshape(-1, 18)
        d = blk[:, :2].copy().view(np.float16)
        qs = blk[:, 2:]
        codes = np.concatenate([qs & 0x0F, qs >> 4], axis=-1).astype(np.uint8).reshape(shape)
    elif ggml_type == GGML_TYPE_Q5_0:
        blk = np.frombuffer(bytes(raw), dtype=np.uint8)[: n_elems // QK * 22].reshape(-1, 22)
        d = blk[:, :2].copy().view(np.float16)
        qh = blk[:, 2:6].copy().view(np.uint32)[:, 0]
        qs = blk[:, 6:]
        j = np.arange(16, dtype=np.uint32)
        hi_lo = (((qh[:, None] >> j) & 1) << 4).astype(np.uint8)
        hi_hi = (((qh[:, None] >> (j + 16)) & 1) << 4).astype(np.uint8)
        codes = np.concatenate([(qs & 0x0F) | hi_lo, (qs >> 4) | hi_hi], axis=-1)
        codes = codes.astype(np.uint8).reshape(shape)
    else:
        raise ValueError(f"not a block-quantized type: {ggml_type}")
    scales = d.reshape(shape[:-1] + (cols // QK,))
    return codes, scales


def pack_planar(codes: np.ndarray, scales: np.ndarray, ggml_type: int) -> np.ndarray:
    """Inverse of unpack_planar — planar arrays -> raw ggml blocks."""
    shape = codes.shape
    nb = int(np.prod(shape)) // QK
    c = codes.reshape(nb, QK)
    d = scales.astype(np.float16).reshape(nb)
    if ggml_type == GGML_TYPE_Q8_0:
        out = np.zeros((nb, 34), dtype=np.uint8)
        out[:, :2] = d.view(np.uint8).reshape(nb, 2)
        out[:, 2:] = c.astype(np.int8).view(np.uint8)
    elif ggml_type == GGML_TYPE_Q4_0:
        out = np.zeros((nb, 18), dtype=np.uint8)
        out[:, :2] = d.view(np.uint8).reshape(nb, 2)
        q = c.astype(np.uint8)
        out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    elif ggml_type == GGML_TYPE_Q5_0:
        out = np.zeros((nb, 22), dtype=np.uint8)
        out[:, :2] = d.view(np.uint8).reshape(nb, 2)
        q = c.astype(np.uint8)
        qh = np.zeros(nb, dtype=np.uint32)
        for j in range(16):
            qh |= ((q[:, j] >> 4).astype(np.uint32)) << j
            qh |= ((q[:, j + 16] >> 4).astype(np.uint32)) << (j + 16)
        out[:, 2:6] = qh.view(np.uint8).reshape(nb, 4)
        out[:, 6:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    else:
        raise ValueError(f"not a block-quantized type: {ggml_type}")
    return out.reshape(-1)


def unpack_planar_transposed(raw: np.ndarray, qtype: int, shape):
    """Raw ggml blocks -> (codes_t (K, N) int8, scales_t (K//32, N) f32), the
    JAX package's transposed device layout (its native-library fallback).
    The port holds weights row-major (see ops/quant_matmul.py); this is kept
    for converting between the two layouts."""
    rows = int(np.prod(shape[:-1]))
    cols = int(shape[-1])
    codes, scales = unpack_planar(raw, qtype, (rows, cols))
    return (np.ascontiguousarray(codes.astype(np.int8).T),
            np.ascontiguousarray(scales.astype(np.float32).T))
