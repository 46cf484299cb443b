"""The persistent K8 and K6: the Orpheus decode step as one cooperative
launch.

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
RING_STAGES = 8        # a warp's ring (csrc/llama_flat.cu FLAT_STAGES)
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
