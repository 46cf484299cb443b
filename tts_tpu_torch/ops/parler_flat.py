"""The Parler decode step over all L layers as one launch: kernel K12.

The port of the JAX package's `ops/parler_flat.py` (`ParlerFlatMega`,
`prep_parler_flat`, `parler_flat_megastep`). K12 computes K2's function
(ops/parler_megastep.py; spec `parler_megastep_reference`): per layer
LN -> qkv -> self-attention over the cache -> o -> LN -> cross-q ->
cross-attention over the precomputed (heads, Tc, D) K/V -> co -> LN -> fc1
-> tanh-GELU -> fc2, block-quantized weights at `_dqdot` numerics, with
the cross block dropped when `use_cross` is off. It returns the
pre-final-norm x and each layer's k_new / v_new; the LM heads stay outside.

On the card it is one cooperative launch of a persistent kernel
(csrc/parler_flat.cu, its header says why) that runs K2's eight phases per
layer with grid-wide barriers between them, through the same device code
as K2 and K3 (the tensor-core GEMV of csrc/parler_gemv.cuh, the page
attention), so K12 equals K2 bit for bit. The JAX kernel's flat tile
stream, half-split nibble packing and schedule fed the TPU's VMEM pipeline
and have no counterpart: K12 reads K2's tiled `MegaLayers` as they are. Its
contract is the port's K2 contract, not the TPU kernel's: the step writes
this token's k / v into cache row `pos` in place, then attends rows
[0, pos], so the runner can swap one route for the other.

On CPU tensors `parler_flat_megastep_plain` computes the same in plain
PyTorch. The runner keeps K2 by default, as the JAX runner does; assign
`runner.mega = maybe_prep_parler_flat(cfg, weights)` (models/parler) to
take this route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..gguf import quants
from . import _build
from .llama_megastep import tiles_packed
from .parler_megastep import (GEMV_SMEM_LIMIT, GEMV_UNIT_K, MegaLayers,
                              gemv_smem_bytes, mega_dims, parler_megastep_plain,
                              require_mega)
from .quant_matmul import BIAS

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_ARGS = [_vp] * 16 + [ctypes.c_longlong] + [_i32] * 10 + [ctypes.c_float,
                                                           _vp, _vp]
KERNEL = _build.Kernel("parler_flat", "tts_parler_flat", _ARGS)   # K12
HEAD_D = 64   # the head size the kernel is built for (Parler's)
PAGE = 256    # the attention's page, as in ops/decode_attention.py
launched_blocks = 0   # the grid of the last launch (SMs x blocks per SM)


class ParlerFlat(NamedTuple):
    """K12's weights: K2's MegaLayers, their block qtype, whether the step
    runs the cross-attention block, the head count and the cache rows the
    decode runs with. The counterpart of the JAX `ParlerFlatMega`."""

    layers: MegaLayers
    qtype: int
    use_cross: bool
    n_heads: int
    ctx: int


def prep_parler_flat(mega: MegaLayers, qtype: int, ctx: int,
                     use_cross: bool = True) -> ParlerFlat:
    """K12's weights from K2's `MegaLayers` (nothing is copied). `ctx` is
    the KV cache's row count. Raises ValueError on shapes the kernel does
    not take (heads of another size than 64, dims that are not whole
    128-weight stages, a GEMV whose shared memory would not fit), as the
    JAX `prep_parler_flat` does on shapes without a uniform tile; the
    caller then keeps K2."""
    n_layers, heads, tc, d = mega.cross_k.shape
    _, hidden, ffn = mega_dims(mega)
    packed = tiles_packed(mega.qkv_codes)
    if (d != HEAD_D or hidden != heads * d or hidden % GEMV_UNIT_K
            or ffn % GEMV_UNIT_K or qtype not in BIAS or tc < 1 or ctx < 1
            or gemv_smem_bytes(1, max(hidden, ffn), packed) > GEMV_SMEM_LIMIT):
        raise ValueError(f"K12 takes heads of {HEAD_D} and whole stages: "
                         f"H={hidden} heads={heads} D={d} F={ffn} Tc={tc} "
                         f"ctx={ctx} qtype={qtype}")
    if packed != (qtype == quants.GGML_TYPE_Q4_0):
        raise ValueError("K12 takes packed Q4_0 codes or byte Q5_0 / Q8_0 codes")
    return ParlerFlat(mega, qtype, bool(use_cross), heads, ctx)


def parler_flat_megastep_plain(flat: ParlerFlat, x, kv_k, kv_v, pos, *,
                               qtype: int, n_heads: int):
    """K12's plain PyTorch version. It is K2's function, so it runs
    `parler_megastep_plain` with the flat's `use_cross`: x (1, H); kv_k /
    kv_v (L, heads, CTX, D), written in place at row pos; pos an int or a
    one-element int tensor. Returns (x_out (1, H) f32, k_new (L, H),
    v_new (L, H))."""
    return parler_megastep_plain(flat.layers, x, kv_k, kv_v, pos, qtype=qtype,
                                 use_cross=flat.use_cross, n_heads=n_heads)


def scratch_floats(n_layers: int, hidden: int, ffn: int, heads: int,
                   ctx: int, tc: int) -> int:
    """Floats of scratch one step needs, laid out as
    csrc/parler_flat.cu:tts_parler_flat_scratch says: qkv (L, 3H) first,
    then the attention output, cross q, GELU output, page partials and the
    barrier words."""
    pages = -(-max(ctx, tc) // PAGE)
    return n_layers * 3 * hidden + 2 * hidden + ffn + \
        heads * pages * (2 + HEAD_D) + 4


def parler_flat_megastep_cuda(flat: ParlerFlat, x, kv_k, kv_v, pos, *,
                              qtype: int, n_heads: int):
    """K12 on the card: one cooperative launch on the current stream. Same
    contract as `parler_flat_megastep_plain`, with pos a one-element int32
    CUDA tensor."""
    global launched_blocks
    m = flat.layers
    dev = x.device
    n_layers, hidden, ffn = mega_dims(m)
    tc = m.cross_k.shape[2]
    _build.require(kv_k, "kv_k", device=dev,
                   dtypes=(torch.bfloat16, torch.float32), ndim=4)
    ctx = kv_k.shape[2]
    _build.require(kv_v, "kv_v", device=dev, dtypes=(kv_k.dtype,), ndim=4)
    _build.require(pos, "pos", device=dev, dtypes=(torch.int32,), align=4)
    for name in ("cross_k", "cross_v"):
        _build.require(getattr(m, name), name, device=dev,
                       dtypes=(torch.float32,), ndim=4)
    require_mega(m, dev)
    if (qtype != flat.qtype or n_heads != flat.n_heads or ctx != flat.ctx
            or x.numel() != hidden or pos.numel() != 1
            or kv_k.shape != (n_layers, n_heads, ctx, HEAD_D)
            or kv_v.shape != kv_k.shape):
        raise ValueError(f"parler_flat_megastep: x {tuple(x.shape)}, kv "
                         f"{tuple(kv_k.shape)}, pos {tuple(pos.shape)}, "
                         f"qtype {qtype}, {n_heads} heads; prepared for "
                         f"qtype {flat.qtype}, {flat.n_heads} heads, ctx "
                         f"{flat.ctx}, L={n_layers} H={hidden}")
    xw = x.float().reshape(1, hidden).clone()
    n_scratch = scratch_floats(n_layers, hidden, ffn, n_heads, ctx, tc)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev)
    grid = ctypes.c_int(0)
    p = _build.ptr
    KERNEL(p(xw), p(m.norms), p(m.qkv_codes), p(m.qkv_scales), p(m.occ_codes),
           p(m.occ_scales), p(m.fc1_codes), p(m.fc1_scales), p(m.fc2_codes),
           p(m.fc2_scales), p(m.cross_k), p(m.cross_v), p(kv_k), p(kv_v),
           p(pos), p(scratch), n_scratch, qtype,
           int(tiles_packed(m.qkv_codes)), n_layers, hidden, ffn,
           n_heads, ctx, tc, int(kv_k.dtype == torch.bfloat16),
           int(flat.use_cross), float(HEAD_D ** -0.5), ctypes.byref(grid),
           _build.stream_ptr(dev))
    launched_blocks = grid.value
    qkv = scratch[:n_layers * 3 * hidden].view(n_layers, 3 * hidden)
    return xw, qkv[:, hidden:2 * hidden], qkv[:, 2 * hidden:]


def parler_flat_megastep(flat: ParlerFlat, x, kv_k, kv_v, pos, *, qtype: int,
                         n_heads: int):
    """Dispatch: K12 for CUDA tensors, the plain version for CPU tensors. See
    `parler_flat_megastep_plain` for the contract."""
    fn = parler_flat_megastep_plain if x.device.type == "cpu" \
        else parler_flat_megastep_cuda
    return fn(flat, x, kv_k, kv_v, pos, qtype=qtype, n_heads=n_heads)
