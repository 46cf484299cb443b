"""The persistent K8 and K6, and K9 and K7's layer stack: the Orpheus
decode step as one cooperative launch, for one sequence or a group of
slots.

`csrc/llama_flat.cu` runs the L layers of one sequence in one launch of
(SMs x the blocks per SM that fit) blocks of 8 warps, five phases a layer
(qkv, attention, o, gate / up, down) with a grid barrier after each (5 L -
1 barriers), and for K6 one more phase, RMS(out_norm) -> the padded head.
Its GEMV phases run the launch sequence's device code (csrc/gemv.cuh
through csrc/flat_gemv.cuh), a tile's k_split(K) K ranges on as many warps
of one block, summed in range order, so the step equals the launch
sequence (`llama_megastep.layers_cuda`) bit for bit. This module holds its
host-side reckoning, which the wrappers (`llama_megastep_cuda`,
`llama_flat_megastep_cuda`) use and the C entry checks against its own
(the block's dynamic shared memory, the scratch), each phase's work
items, which chip_smoke logs and the CPU tests check, and the launch.
The wrappers keep the contract, the plain versions and the counters.

`csrc/llama_flat_batched.cu` is the same step over B <= R slot rows, each
at its own position with its own cache (K9, and K7's layers before its
head GEMV): the same five phases and barriers, the attention's items
(slot, group of q heads, live page) merged per (slot, group) by arrival.
Its shared memory holds no f32 copy of the rows and a shorter ring, so
that 8 rows of Orpheus-3B width fit a block; `max_rows` reckons R, and
`llama_megastep.takes_persistent_batched` is the route gate (heads of 64 /
128) the wrappers apply before a launch. Each of its slots equals K8 on
that slot's state bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import PAGE, STEP_HEAD_SIZES
from .dia_flat import GemvPhase, scratch
from .llama_megastep import (GEMV_TILE_PAIRS, GEMV_UNIT_K, GEMV_WARPS,
                             gemv_k_split, gemv_stage_bytes, tiles_packed)

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
# the batched step's C entry (csrc/llama_flat_batched.cu); its launches
# count on K9's or K7's counter (`_build.Kernel.through`)
BATCHED_ARGS = ([_vp] * 4 + [_i32] + [_vp] * 8 + [_i64, _i64, _vp, _vp,
                 ctypes.c_float, _vp, _vp, _i64, _vp, _i32] + [_i32] * 12
                + [_vp] * 3)
STEP_BATCHED = _build.Kernel("llama_flat_batched", "tts_llama_flat_batched",
                             BATCHED_ARGS)
RING_STAGES = 8        # a warp's ring (csrc/llama_flat.cu FLAT_STAGES)
BATCHED_RING_BYTES = 7680   # the batched step's ring a warp (csrc/llama_flat_batched.cu)
MAX_SLOTS = 8          # rows of the mma's one n-tile (FLAT_NT * 8)
SMEM_LIMIT = 227 * 1024   # shared memory a block may have on the H100
# static shared memory of the kernel past its dynamic part, at most: the
# attention pages' state for heads of 64 and 128, one or two heads a block,
# over both cache dtypes (4 warps x 2 x (1 + 2) x (2 + D) floats a dtype,
# 18,816 bytes), the RMS sums, pos and the RoPE frequencies
STATIC_SMEM = 20 * 1024
# the last launch's grid and the blocks an SM held (chip_smoke logs them)
launched_blocks = 0
blocks_per_sm = 0


def gemv_phases(hidden: int, ffn: int, n_heads: int, n_kv: int,
                vocab: int = 0) -> list:
    """The GEMV phases of a layer (qkv, o, gate_up, down) at these widths,
    and K6's head of `vocab` rows when vocab > 0."""
    kvh = n_kv * (hidden // n_heads)
    phases = [("qkv", (hidden + 2 * kvh) // 2, hidden), ("o", hidden // 2, hidden),
              ("gate_up", ffn, hidden), ("down", hidden // 2, ffn)]
    if vocab:
        phases.append(("head", vocab // 2, hidden))
    out = []
    for name, pairs, k in phases:
        tiles, ks = -(-pairs // GEMV_TILE_PAIRS), gemv_k_split(k)
        out.append(GemvPhase(name, pairs, k, tiles, ks, tiles * ks,
                             k // GEMV_UNIT_K // ks))
    return out


def barriers(n_layers: int, head: bool) -> int:
    """Grid barriers a step passes: one after each of a layer's five phases
    but the last layer's last, and one before K6's head."""
    return 5 * n_layers - 1 + int(head)


def smem_bytes(hidden: int, ffn: int, packed: bool = True,
               qkv_bf16: bool = True) -> int:
    """A block's dynamic shared memory (csrc/llama_flat.cu
    flat_smem_bytes): 8 warps' rings of RING_STAGES of the larger stage
    (K8's qkv stages carry f32 scales), the double-buffered range sums (a
    float4 a lane a warp), the f32 row and norm weights of an RMS prologue
    (2 H floats) and the row staged as bf16 at the larger K, padded as
    xs_stride pads it."""
    k = max(hidden, ffn)
    stage = max(gemv_stage_bytes(packed, qkv_bf16), gemv_stage_bytes(packed))
    return (GEMV_WARPS * RING_STAGES * stage + 2 * GEMV_WARPS * 32 * 16
            + 2 * hidden * 4 + (k * 2 + 127) // 128 * 128 + 32)


def n_pages(ctx: int) -> int:
    return -(-ctx // PAGE)


def scratch_floats(hidden: int, ffn: int, n_heads: int, d: int, ctx: int) -> int:
    """Floats of scratch one step needs (csrc/llama_flat.cu
    tts_llama_flat_scratch): the attention output (H), the SiLU output (F)
    and the page partials (heads, pages, 2 + D)."""
    return hidden + ffn + n_heads * n_pages(ctx) * (2 + d)


def scratch_words(n_heads: int) -> int:
    """uint32 words the step keeps zeroed: an arrival counter per q head
    and the grid barrier's two (csrc/grid_sync.cuh)."""
    return n_heads + 2


def attention_items(n_heads: int, pos: int, ctx: int, grid: int) -> int:
    """Page items of a layer's attention phase on `grid` blocks: (group of
    q heads) x the live 256-row pages up to pos, one head a group while
    that fits the grid in one round, else two where the heads pair up
    (csrc/llama_flat.cu attention_of)."""
    live = min(pos, ctx - 1) // PAGE + 1
    g = 2 if n_heads % 2 == 0 and n_heads * live > grid else 1
    return n_heads // g * live


def launch(kernel, layers, x, kv_k, kv_v, pos, inv_freq, *, qtype: int,
           n_heads: int, head=None, out_norm=None):
    """One persistent launch through `kernel` on the current stream, tensors
    validated by the caller: x (1, H) f32, updated in place; kv_k / kv_v
    (L, n_kv, CTX, D) with D in STEP_HEAD_SIZES; with `head` (K6's Tiles,
    bf16 scales) and `out_norm` (H,), the head phase. Returns (qkv (L, 1,
    H + 2 KV): q, k_new and v_new of every layer; logits (1, vocab_pad) or
    None)."""
    global launched_blocks, blocks_per_sm
    dev = x.device
    n_layers, hidden = layers.norms.shape[0], layers.norms.shape[2]
    ffn = layers.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    n_kv, ctx, d = kv_k.shape[1], kv_k.shape[2], kv_k.shape[3]
    if d not in STEP_HEAD_SIZES:
        raise ValueError(f"the persistent llama step takes heads of "
                         f"{STEP_HEAD_SIZES}, not {d}")
    packed = tiles_packed(layers.qkv_codes)
    qkv_bf16 = layers.qkv_scales.dtype == torch.bfloat16
    smem = smem_bytes(hidden, ffn, packed, qkv_bf16)
    if smem + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"the persistent llama step at H {hidden}, F {ffn} "
                         f"needs {smem} bytes of shared memory a block")
    sc, w = scratch(dev, scratch_floats(hidden, ffn, n_heads, d, ctx),
                    scratch_words(n_heads))
    qkv = torch.empty((n_layers, 1, hidden + 2 * n_kv * d), dtype=torch.float32,
                      device=dev)
    p, null = _build.ptr, _vp(0)
    logits = None
    if head is not None:
        logits = torch.empty((1, head.shape[0]), dtype=torch.float32, device=dev)
    grid, per_sm = _i32(0), _i32(0)
    kernel(p(x), p(layers.norms), p(layers.qkv_codes), p(layers.qkv_scales),
           int(qkv_bf16), p(layers.o_codes), p(layers.o_scales),
           p(layers.gate_up_codes), p(layers.gate_up_scales),
           p(layers.down_codes), p(layers.down_scales),
           null if head is None else p(head.codes),
           null if head is None else p(head.scales),
           null if head is None else p(out_norm),
           null if head is None else p(logits),
           0 if head is None else head.shape[0],
           p(kv_k), p(kv_v), kv_k.stride(0), p(pos), p(inv_freq),
           float(d ** -0.5), p(qkv), p(sc), sc.numel(), p(w), w.numel(), qtype,
           int(packed), n_layers, hidden, ffn, n_heads, n_kv, d, ctx,
           int(kv_k.dtype == torch.bfloat16), smem, ctypes.byref(grid),
           ctypes.byref(per_sm), _build.stream_ptr(dev))
    launched_blocks, blocks_per_sm = grid.value, per_sm.value
    return qkv, logits


def batched_stages(packed: bool = True, qkv_bf16: bool = True) -> int:
    """Ring stages a warp keeps in the batched step: BATCHED_RING_BYTES of
    the larger stage (6 for Q4_0, 3 for Q5_0 / Q8_0), at least 2."""
    stage = max(gemv_stage_bytes(packed, qkv_bf16), gemv_stage_bytes(packed))
    return max(2, BATCHED_RING_BYTES // stage)


def batched_smem_bytes(rows: int, hidden: int, ffn: int, packed: bool = True,
                       qkv_bf16: bool = True) -> int:
    """A block's dynamic shared memory in the batched step for `rows` slots
    (csrc/llama_flat_batched.cu batched_smem_bytes): 8 warps' rings of
    batched_stages of the larger stage, the double-buffered range sums and
    the rows staged as bf16 at the larger K (no f32 copy of the rows: the
    RMS sums read x in device memory)."""
    k = max(hidden, ffn)
    stage = max(gemv_stage_bytes(packed, qkv_bf16), gemv_stage_bytes(packed))
    return (GEMV_WARPS * batched_stages(packed, qkv_bf16) * stage
            + 2 * GEMV_WARPS * 32 * 16 + rows * ((k * 2 + 127) // 128 * 128 + 32))


def max_rows(hidden: int, ffn: int, packed: bool = True,
             qkv_bf16: bool = True) -> int:
    """R, the slot rows one batched launch takes at these widths: the most
    rows, up to MAX_SLOTS, whose shared memory (batched_smem_bytes plus
    STATIC_SMEM) fits a block; 0 where not one row fits."""
    return max((r for r in range(1, MAX_SLOTS + 1)
                if batched_smem_bytes(r, hidden, ffn, packed, qkv_bf16)
                + STATIC_SMEM <= SMEM_LIMIT), default=0)


def batched_scratch_floats(rows: int, hidden: int, ffn: int, n_heads: int,
                           d: int, ctx: int) -> int:
    """Floats of scratch a batched step of `rows` slots needs
    (csrc/llama_flat_batched.cu tts_llama_flat_batched_scratch)."""
    return rows * scratch_floats(hidden, ffn, n_heads, d, ctx)


def batched_scratch_words(rows: int, n_heads: int) -> int:
    """uint32 words the batched step keeps zeroed: an arrival counter per
    (slot, q head) and the grid barrier's two."""
    return rows * n_heads + 2


def batched_attention_items(n_heads: int, positions, ctx: int,
                            grid: int) -> tuple[int, list]:
    """(G, items per slot) of a layer's attention phase in the batched step
    on `grid` blocks: slot s has (n_heads / G) x its live 256-row pages up
    to min(pos[s], ctx - 1); G is 2 (two q heads a block) where the heads
    pair up and one head a block would take more than one round of the
    grid, else 1. Each (slot, group) whose pages are more than one is merged
    by arrival, on its counter s * n_heads / G + group."""
    live = [min(p, ctx - 1) // PAGE + 1 for p in positions]
    g = 2 if n_heads % 2 == 0 and n_heads * sum(live) > grid else 1
    return g, [n_heads // g * n for n in live]


def launch_batched(counter, layers, x, kv_k, kv_v, pos, inv_freq, *,
                   qtype: int, n_heads: int):
    """One batched launch (csrc/llama_flat_batched.cu) on the current
    stream, counted on `counter` (K9's or K7's), tensors validated by the
    caller: x (B, H) f32 with B <= max_rows, updated in place; kv_k / kv_v
    (L, B, n_kv, CTX, D), the layer axis at any stride, each slot's cache
    dense; pos (B,) int32. Returns qkv (L, B, H + 2 KV): q, k_new and v_new
    of every layer. Raises where the card refuses the launch."""
    global launched_blocks, blocks_per_sm
    dev = x.device
    b = x.shape[0]
    n_layers, hidden = layers.norms.shape[0], layers.norms.shape[2]
    ffn = layers.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    n_kv, ctx, d = kv_k.shape[2], kv_k.shape[3], kv_k.shape[4]
    packed = tiles_packed(layers.qkv_codes)
    qkv_bf16 = layers.qkv_scales.dtype == torch.bfloat16
    cap = max_rows(hidden, ffn, packed, qkv_bf16)
    if d not in STEP_HEAD_SIZES or not 0 < b <= cap:
        raise ValueError(f"the batched llama step takes heads of "
                         f"{STEP_HEAD_SIZES} and 1-{cap} rows at H {hidden}, "
                         f"F {ffn}: heads of {d}, {b} rows")
    for name in ("o", "gate_up", "down"):
        if getattr(layers, name + "_scales").dtype != torch.bfloat16:
            raise ValueError(f"llama step: {name} scales must be bfloat16")
    sc, w = scratch(dev, batched_scratch_floats(b, hidden, ffn, n_heads, d, ctx),
                    batched_scratch_words(b, n_heads))
    qkv = torch.empty((n_layers, b, hidden + 2 * n_kv * d), dtype=torch.float32,
                      device=dev)
    p = _build.ptr
    grid, per_sm = _i32(0), _i32(0)
    counter.through(
        STEP_BATCHED, p(x), p(layers.norms), p(layers.qkv_codes),
        p(layers.qkv_scales), int(qkv_bf16), p(layers.o_codes),
        p(layers.o_scales), p(layers.gate_up_codes), p(layers.gate_up_scales),
        p(layers.down_codes), p(layers.down_scales), p(kv_k), p(kv_v),
        kv_k.stride(0), kv_k.stride(1), p(pos), p(inv_freq), float(d ** -0.5),
        p(qkv), p(sc), sc.numel(), p(w), w.numel(), qtype, int(packed), b,
        n_layers, hidden, ffn, n_heads, n_kv, d, ctx,
        int(kv_k.dtype == torch.bfloat16),
        batched_smem_bytes(b, hidden, ffn, packed, qkv_bf16),
        ctypes.byref(grid), ctypes.byref(per_sm), _build.stream_ptr(dev))
    launched_blocks, blocks_per_sm = grid.value, per_sm.value
    return qkv
