"""The persistent K10: the Dia decode step as one cooperative launch.

`csrc/dia_flat.cu` runs the L decoder layers of one CFG pair in one launch
of (SMs x the blocks per SM that fit) blocks of 8 warps, eight phases a
layer with a grid barrier after each (143 barriers at 18 layers). Its
GEMV phases run the launch sequence's device code (csrc/gemv.cuh), a
tile's k_split(K) K ranges on as many warps of one block, summed in range
order, so the step equals the launch sequence bit for bit. This module
holds its host-side reckoning, which the wrapper in ops/dia_megastep.py
uses and the C entry checks against its own (the block's dynamic shared
memory, the scratch), the launch itself, and each phase's work items,
which chip_smoke logs. `ops/dia_megastep.py` keeps the contract, the plain version
and the counter (`KERNEL`).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from . import _build
from .llama_megastep import (GEMV_TILE_PAIRS, GEMV_UNIT_K, GEMV_WARPS,
                             gemv_k_split, gemv_stage_bytes)

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
ARGS = ([_vp] * 12 + [_i64, _vp, _vp, _i64, _vp, _i64, ctypes.c_float]
        + [_vp] * 4 + [_i64, _vp, _i32] + [_i32] * 12 + [_vp, _vp, _vp])
ROWS = 2          # the CFG pair
RING_STAGES = 8   # a warp's ring: a whole (tile, K range) item at K 2048
PAGE = 256        # the attention's page, as in ops/decode_attention.py
SMEM_LIMIT = 227 * 1024   # shared memory a block may have on the H100
# the last launch's grid and the blocks an SM held (chip_smoke logs them)
launched_blocks = 0
blocks_per_sm = 0


class GemvPhase(NamedTuple):
    """One GEMV phase of a layer: its tiles of 8 feature pairs, the K
    ranges a tile's sum is split into, and the (tile, K range) items, each
    `stages` ring stages of one warp."""

    name: str
    pairs: int
    k: int
    tiles: int
    k_split: int
    items: int
    stages: int


def gemv_phases(hidden: int, ffn: int, n_heads: int, n_kv: int) -> list:
    """The six GEMV phases of a layer (qkv, o, cq, co, gate_up, down) at
    these widths."""
    kvh = n_kv * (hidden // n_heads)
    out = []
    for name, pairs, k in (("qkv", (hidden + 2 * kvh) // 2, hidden),
                           ("o", hidden // 2, hidden), ("cq", hidden // 2, hidden),
                           ("co", hidden // 2, hidden), ("gate_up", ffn, hidden),
                           ("down", hidden // 2, ffn)):
        tiles, ks = -(-pairs // GEMV_TILE_PAIRS), gemv_k_split(k)
        out.append(GemvPhase(name, pairs, k, tiles, ks, tiles * ks,
                             k // GEMV_UNIT_K // ks))
    return out


def warps_with_items(phase: GemvPhase, grid: int) -> int:
    """Warps that have at least one item in a phase on `grid` blocks: a
    block's 8 warps hold 8 / k_split tiles at a time, the tiles spread over
    the blocks first."""
    slots = grid * (GEMV_WARPS // phase.k_split)
    return min(phase.tiles, slots) * phase.k_split


def smem_bytes(hidden: int, ffn: int, packed: bool = True) -> int:
    """A block's dynamic shared memory (csrc/dia_flat.cu flat_smem_bytes):
    8 warps' rings of RING_STAGES stages, the double-buffered range sums (a
    float4 a lane a warp), the f32 copies of the two rows and the norm
    weights for an RMS prologue (3 H floats) and the two rows staged as
    bf16 at the larger K, each row padded as xs_stride pads it."""
    k = max(hidden, ffn)
    xs_stride = (k * 2 + 127) // 128 * 128 + 32
    return (GEMV_WARPS * RING_STAGES * gemv_stage_bytes(packed)
            + 2 * GEMV_WARPS * 32 * 16 + (ROWS + 1) * hidden * 4
            + ROWS * xs_stride)


def n_pages(ctx: int, sb: int) -> int:
    return -(-max(ctx, sb) // PAGE)


def scratch_floats(hidden: int, ffn: int, n_heads: int, d: int, ctx: int,
                   sb: int) -> int:
    """Floats of scratch one step needs (csrc/dia_flat.cu
    tts_dia_flat_scratch): the attention output and cross q (2H each), the
    SiLU output (2F) and the page partials (2 heads, pages, 2 + D)."""
    return 4 * hidden + 2 * ffn + 2 * n_heads * n_pages(ctx, sb) * (2 + d)


def scratch_words(n_heads: int) -> int:
    """uint32 words the step keeps zeroed: an arrival counter per (row,
    head) and the grid barrier's two (csrc/grid_sync.cuh)."""
    return 2 * n_heads + 2


def attention_items(n_heads: int, n_kv: int, pos: int, ctx: int,
                    sb: int) -> tuple[int, int]:
    """(self-attention, cross-attention) page items of a layer: (row, group
    of q heads sharing a kv head, 2 when they pair up, else 1) x the live
    256-row pages up to pos; (row, head) x the bucket's pages."""
    g = 2 if (n_heads // n_kv) % 2 == 0 else 1
    live = min(pos, ctx - 1) // PAGE + 1
    return ROWS * (n_heads // g) * live, ROWS * n_heads * (-(-sb // PAGE))


_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def scratch(device, floats: int, words: int):
    """(floats, words) for the steps launched on `device`'s current stream:
    the f32 scratch, and the zeroed words every launch leaves zeroed.
    Launches on one stream run in order, so one pair per (device, stream)
    serves every step; made once, grown (zeroed anew) when too small."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    with _SCRATCH_LOCK:
        have = _SCRATCH.get(key)
        if have is None or have[0].numel() < floats or have[1].numel() < words:
            have = _SCRATCH[key] = (
                torch.empty((floats,), dtype=torch.float32, device=dev),
                torch.zeros((words,), dtype=torch.int32, device=dev))
        return have


def launch(kernel, mega, x, kv_k, kv_v, pos, ck, cv, vtail, n_tail: int, inv,
           *, qtype: int, packed: bool, n_heads: int):
    """One persistent K10 launch through `kernel` on the current stream,
    tensors validated by the caller: x (2, H) f32, updated in place; kv_k /
    kv_v (L, 2, n_kv, CTX, D), the layer axis at any stride; ck / cv (L, 2,
    heads, Sb, D) bf16 and vtail (L, 2, heads, D) f32 likewise. Returns qkv
    (L, 2, H + 2 KV): q, k_new and v_new of every layer."""
    global launched_blocks, blocks_per_sm
    dev = x.device
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    n_kv, ctx, d = kv_k.shape[2], kv_k.shape[3], kv_k.shape[4]
    sb = ck.shape[3]
    floats = scratch_floats(hidden, ffn, n_heads, d, ctx, sb)
    words = scratch_words(n_heads)
    sc, w = scratch(dev, floats, words)
    qkv = torch.empty((n_layers, ROWS, hidden + 2 * n_kv * d),
                      dtype=torch.float32, device=dev)
    grid, per_sm = _i32(0), _i32(0)
    p = _build.ptr
    tail = n_tail > 0
    kernel(p(x), p(mega.norms), p(mega.qkv_codes), p(mega.qkv_scales),
           p(mega.occ_codes), p(mega.occ_scales), p(mega.gate_up_codes),
           p(mega.gate_up_scales), p(mega.down_codes), p(mega.down_scales),
           p(kv_k), p(kv_v), kv_k.stride(0), p(ck), p(cv), ck.stride(0),
           p(vtail) if tail else _vp(0), vtail.stride(0), float(n_tail),
           p(pos), p(inv), p(qkv), p(sc), sc.numel(), p(w), w.numel(), qtype,
           int(packed), n_layers, hidden, ffn, n_heads, n_kv, d, ctx, sb,
           int(kv_k.dtype == torch.bfloat16), smem_bytes(hidden, ffn, packed),
           ctypes.byref(grid), ctypes.byref(per_sm), _build.stream_ptr(dev))
    launched_blocks, blocks_per_sm = grid.value, per_sm.value
    return qkv
