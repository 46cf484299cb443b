"""Block-dequant matmul (Q4_0 / Q5_0 / Q8_0): QuantTensor and kernel K1.

`quant_matmul(x, w)` computes x @ W^T for a block-quantized weight W (N, K),
x (M, K) -> (M, N). On a CUDA tensor it launches the hand-written kernel
(csrc/quant_matmul.cu: tensor cores, the weights read once per call, the
activations staged once per block); on a CPU tensor it runs
`quant_matmul_plain`, the same function in plain PyTorch. As in the JAX
package, M > 256 (prefill of long prompts) goes to dequant + torch.matmul
instead.

The kernel's plan (`k1_plan`: 64-feature tiles, K split over a cluster of
1-8 blocks) is a function of N, K and the card's SM count, never of M, so
that a row's outputs have the same bits in a call of any number of rows;
`k1_unit` and `k1_stages` size its ring by M, which moves no sum.

Layout (chosen for Hopper; the JAX package's transposed (K, N) layout and
2048-row half-split nibble packing were chosen for Mosaic): weights stay
row-major as ggml stores them, one row per output feature,
  codes  : (..., N, K) uint8 (Q4_0 0..15, Q5_0 0..31) or int8 (Q8_0), or
           Q4_0 nibble-packed (..., N, K/2) uint8 in ggml's own block_q4_0
           order (byte i of a 32-block: element i low, element i+16 high);
  scales : (..., N, K/32) float32 or bfloat16.
so a block copies its 64 rows' stage of K with 16-byte copies, each row's
part contiguous. The scale
dtype selects the numerics, as it does in the TPU kernel: float32 scales
give an exact f32 product; bfloat16 scales give the megastep `_dqdot`
rounding (weight dequantized in f32 and rounded to bf16, activation rounded
to bf16, f32 sums). Packing is exact: packed and unpacked give the same
values.
"""
from __future__ import annotations

import collections
import ctypes
import threading

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
    [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32,
     _i32, _vp])
# K1's launches by shape, beside KERNEL.launches: (M, N, K, qtype, scale
# dtype "bf16" / "f32", packed) -> launches; cleared with the counter by
# whoever reads it.
SHAPES: collections.Counter = collections.Counter()
_SHAPES_LOCK = threading.Lock()

TILE_N = 64          # output features of a block (csrc/quant_matmul.cu BN)
STAGE_K = 64         # K elements of the narrowest ring stage (2 blocks)
MAX_SPLIT = 8        # blocks of a cluster (the portable maximum)
MIN_SPLIT_K = 256    # K elements a rank keeps at least
RING_BYTES = 96 * 1024
RING_BYTES_SMALL = 54 * 1024   # up to 8 rows: 4 blocks an SM
MIN_STAGES, MAX_STAGES = 2, 12


def k1_plan(n: int, k: int, sms: int) -> tuple[int, int]:
    """(tiles, ks): K1's 64-feature tiles and the ranks of a cluster that
    split K, doubled while the blocks are fewer than the SMs and each rank
    keeps a whole number of stages and at least MIN_SPLIT_K (the ranks'
    meeting costs a few microseconds, more than a second block an SM
    gains). A function of N, K and the SM count only: an output's order of
    sums follows ks, so it must not follow M."""
    if k % STAGE_K:
        raise ValueError(f"quant_matmul: K {k} is not a multiple of {STAGE_K}")
    tiles = -(-n // TILE_N)
    ks = 1
    while (ks < MAX_SPLIT and tiles * ks < sms
           and k % (STAGE_K * 2 * ks) == 0 and k // (2 * ks) >= MIN_SPLIT_K):
        ks *= 2
    return tiles, ks


def k1_unit(m: int, kr: int) -> int:
    """32-weight blocks of a row in one ring stage: 8 (a whole 128-byte
    line of packed codes) for up to 16 rows, where the weights' bytes bound
    the call, 4 for up to 32, else 2 (the rows' activations fill the
    stage); 2 where a rank's kr elements do not divide. It moves no sum:
    each block's products are added in block order whatever the stage."""
    ub = 8 if m <= 16 else 4 if m <= 32 else 2
    return ub if kr % (32 * ub) == 0 else 2


def k1_stage_bytes(m: int, ub: int, packed: bool, bf16: bool) -> int:
    """Shared-memory bytes of one ring stage (csrc/quant_matmul.cu Ring):
    `ub` 32-weight blocks of 64 features (codes and scales) and the M rows'
    32 ub activations in one bf16 part (bf16 mode) or three (f32 mode)."""
    codes = TILE_N * ub * (16 if packed else 32)
    scales = TILE_N * ub * (2 if bf16 else 4)
    acts = (1 if bf16 else 3) * m * ub * 64
    return -(-(codes + scales + acts) // 128) * 128


def k1_stages(m: int, ub: int, packed: bool, bf16: bool) -> int:
    """The ring's depth: as many stages as fit RING_BYTES (RING_BYTES_SMALL
    for up to 8 rows, whose blocks of 4 warps run 4 an SM), 2 to 12. It
    decides how much is in flight, not the order of any sum."""
    per = k1_stage_bytes(m, ub, packed, bf16)
    budget = RING_BYTES_SMALL if m <= 8 else RING_BYTES
    return max(MIN_STAGES, min(MAX_STAGES, budget // per))


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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
    """Launch K1 on the card: x (M, K) float32 contiguous, M <= 256, K a
    multiple of 64."""
    dev = x.device
    _build.require(x, "x", device=dev, dtypes=(torch.float32,), ndim=2)
    _build.require(w.codes, "codes", device=dev,
                   dtypes=(torch.uint8, torch.int8), ndim=2)
    m, k = x.shape
    n = w.shape[0]
    if k != w.shape[1] or w.scales.shape[0] != n or not 0 < m <= MAX_KERNEL_M:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs W {w.shape}")
    bf16 = w.scales.dtype == torch.bfloat16
    packed = w.is_packed
    _, ks = k1_plan(n, k, _sm_count(dev))
    ub = k1_unit(m, k // ks)
    stages = k1_stages(m, ub, packed, bf16)
    # a feature's scales of a stage are one copy of 4 or 8 bytes, or
    # 16-byte copies
    _build.require(w.scales, "scales", device=dev,
                   dtypes=(torch.float32, torch.bfloat16), ndim=2,
                   align=min(16, ub * (2 if bf16 else 4)))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    xp = torch.empty((1 if bf16 else 3, m, k), dtype=torch.bfloat16,
                     device=dev)
    KERNEL(_build.ptr(x), _build.ptr(w.codes), _build.ptr(w.scales),
           _build.ptr(xp), _build.ptr(out), m, n, k, w.qtype, int(packed),
           int(bf16), ub, ks, stages, _build.stream_ptr(dev))
    with _SHAPES_LOCK:
        SHAPES[(m, n, k, w.qtype, "bf16" if bf16 else "f32", packed)] += 1
    return out


def quant_matmul(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """x (M, K) @ W^T -> (M, N) float32: K1 on the card, the plain version
    for CPU tensors, dequant + torch.matmul for M > 256."""
    if x.device.type == "cpu" or x.shape[0] > MAX_KERNEL_M:
        return quant_matmul_plain(x, w)
    return quant_matmul_cuda(x.float().contiguous(), w)
