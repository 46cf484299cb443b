"""One Orpheus (llama-family) decode step over all L layers: kernel K8, and
kernel K9 for B batch slots.

Computes the JAX package's `llama_megastep` (reference
`llama_megastep_reference`): per layer RMS -> qkv -> NeoX RoPE with the
llama3 frequency factors -> GQA attention over the cache -> o -> RMS ->
SiLU(gate) * up -> down, with block-quantized weights at bf16-rounded
dequant and bf16-rounded activations, f32 sums (`_dqdot` numerics, whatever
the scale dtype). Returns the pre-final-norm x and each layer's k_new /
v_new; the caller applies the final norm and the LM head. K9 computes
`llama_megastep_batched` (reference `llama_megastep_batched_reference`, the
single-stream reference per slot): one row per slot, each slot at its own
position with its own cache.

On the card K8 is one cooperative launch of a persistent kernel a step
(csrc/llama_flat.cu, its header says why; ops/llama_persistent.py reckons
its plan): per layer five phases with a grid barrier after each. K9 is the
same step over a group of at most R slot rows (csrc/llama_flat_batched.cu,
`persistent_batched`): one cooperative launch a group, one weight read
for every slot of it. For heads of other sizes than 64 / 128 K9 runs the
launch sequence (`layers_cuda`, csrc/llama_megastep.cu): per layer 4
launches of the dequant GEMV, which fuses the RMS norm before it and the
RoPE + KV-row write, SiLU(gate) * up or residual add after it, and 1
launch of the decode attention (K4, ops/decode_attention.py); it stays the
yardstick the persistent steps equal bit for bit
(`llama_megastep_batched_sequence`). Every route runs the same per-item
device code, so each K9 slot equals K8 on that slot's state bit for bit.
K6 and K7 (ops/llama_flat.py) run the same layers and add the LM head. On CPU tensors `llama_megastep_plain` and
`llama_megastep_batched_plain` compute the same in plain PyTorch.

The prep (`prep_llama_mega`) lays each projection out in the order the
GEMV streams it (`gemv_tile`: tiles of 8 feature pairs, each a run of
stages of 128 weights of its 16 rows), so that each warp reads contiguous
runs; the plain versions read the same tiles back in row order
(`weight_rows`).

K9 departs from the TPU batched kernel in one rounding: that kernel rounds
q, K/V and the softmax probabilities to bf16 for its attention dots, which
the single-stream kernel does not; here K4 keeps K3's f32 softmax, so that
a slot equals K8.

Unlike the TPU kernel, which folds the current token's f32 k/v into the
softmax and leaves the cache write to its caller, this step writes k/v into
cache row `pos` IN PLACE first and then attends rows [0, pos], as K2 does.
That is exact in f32; on a bf16 cache the current row is rounded to bf16
before it is attended (the plain version does the same).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._build import addr
from . import decode_attention as da
from .decode_attention import decode_attention_plain
from .quant_matmul import BIAS, QuantTensor, dequant

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
ARGS = [_vp, _vp, _i32, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32,
        _vp, _vp, _i32, _vp, _vp, _i32, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
        _i64, _vp]
# the persistent step's C entry (csrc/llama_flat.cu tts_llama_flat), K8's and
# K6's; ops/llama_persistent.py reckons its plan and launches it
STEP_ARGS = ([_vp, _vp, _vp, _vp, _i32] + [_vp] * 6 + [_vp, _vp, _vp, _vp, _i32]
             + [_vp, _vp, _i64, _vp, _vp, ctypes.c_float, _vp, _vp, _i64, _vp,
                _i32] + [_i32] * 11 + [_vp, _vp, _vp])
# K8 is one persistent launch a step. K9's counter counts its batched
# persistent launches (ops/llama_persistent.py STEP_BATCHED's entry) and, on
# the launch sequence, its GEMV launches (whose attention launches count on
# K4's); KERNEL_BATCHED's own entry is the launch sequence's GEMV.
KERNEL = _build.Kernel("llama_flat", "tts_llama_flat", STEP_ARGS)          # K8
KERNEL_BATCHED = _build.Kernel("llama_megastep", "tts_llama_gemv", ARGS)   # K9
EPI_STORE, EPI_RESIDUAL, EPI_SILU_MUL, EPI_ROPE_QKV = 0, 1, 2, 3
RMS_EPS = 1e-5
MAX_BATCH = 16   # rows one GEMV launch takes (csrc/llama_megastep.cu MAX_ROWS);
                 # larger batches run in groups
# csrc/gemv.cuh's launch shape: clusters of gemv_k_split(K) blocks of
# GEMV_WARPS warps, one block per SM (two for the head), each block taking a K range of
# every row; a warp's tile is GEMV_TILE_PAIRS feature pairs (16 weight rows)
# streamed through a ring of stages of GEMV_UNIT_K weights a row; the
# input rows' bf16 copy, the ring and the slots where rank 0 gathers the
# other ranks' sums share the block's dynamic shared memory, at most
# GEMV_SMEM_LIMIT bytes. An SM has GEMV_SM_SMEM, and each resident block
# takes 1 KB more than it asks for.
GEMV_WARPS, GEMV_TILE_PAIRS, GEMV_UNIT_K, GEMV_NBUF = 8, 8, 128, 2
GEMV_STAGE_BLOCKS = GEMV_UNIT_K // 32
GEMV_SMEM_LIMIT = 226 * 1024
GEMV_SM_SMEM = 228 * 1024


def gemv_k_split(k: int) -> int:
    """Blocks of a cluster, each taking k / gemv_k_split(k) of every row:
    fixed by k alone (csrc/gemv.cuh k_split)."""
    return 2 if k <= 4096 else 4


def gemv_n_tiles(b: int) -> int:
    """n-tiles of 8 input rows a launch of b rows computes (1 or 2)."""
    return 1 if b <= 8 else 2


def gemv_stage_bytes(packed: bool = True, scale_bf16: bool = True) -> int:
    """One ring stage: 4 blocks of 32 weights of 16 rows, codes and scales."""
    return 4 * 16 * (16 if packed else 32) + 16 * 4 * (2 if scale_bf16 else 4)


def gemv_ring_stages(b: int, packed: bool = True, scale_bf16: bool = True) -> int:
    """Stages a warp keeps in flight (csrc/gemv.cuh ring_stages): about 7 KB
    at one n-tile, 4.5 KB at two."""
    budget = 7168 if gemv_n_tiles(b) == 1 else 4608
    return max(2, budget // gemv_stage_bytes(packed, scale_bf16))


def gemv_smem_bytes(b: int, k: int, packed: bool = True,
                    scale_bf16: bool = True) -> int:
    """A block's dynamic shared memory (csrc/gemv.cuh smem_bytes): the
    warps' rings, rank 0's slots for the other ranks' sums, and b input
    rows of its K range as bf16, each padded to 32 bytes past a multiple of
    128."""
    ks, nt = gemv_k_split(k), gemv_n_tiles(b)
    ring = GEMV_WARPS * gemv_ring_stages(b, packed, scale_bf16) * \
        gemv_stage_bytes(packed, scale_bf16)
    slots = (ks - 1) * GEMV_WARPS * GEMV_NBUF * nt * 32 * 16
    return ring + slots + b * (-(-(k // ks) * 2 // 128) * 128 + 32)


def gemv_blocks_per_sm(pairs: int, k: int, sms: int) -> int:
    """Blocks of one launch an SM takes (csrc/gemv.cuh launch_one): two
    where the launch's (tile, K range) items are at least twice the warps
    of one block an SM (the LM head), else one."""
    items = -(-pairs // GEMV_TILE_PAIRS) * gemv_k_split(k)
    return 2 if items >= 2 * GEMV_WARPS * sms else 1


def gemv_clusters(pairs: int, k: int, sms: int) -> int:
    """Clusters of a launch over `pairs` feature pairs on `sms` SMs:
    gemv_blocks_per_sm blocks an SM at most, no more clusters than tiles
    (the driver's count of clusters that fit at once can only lower it)."""
    return min(-(-pairs // GEMV_TILE_PAIRS),
               gemv_blocks_per_sm(pairs, k, sms) * sms // gemv_k_split(k))


def gemv_schedule(pairs: int, k: int, sms: int):
    """How many times the launch copies each (tile, 32-weight block) of its
    weights, as an int array (tiles, k / 32), by csrc/gemv.cuh's loops:
    warp w of block rank r of cluster c takes tiles c + C (w + 8 j) and,
    of each, blocks r k / (32 ks) onward, one stage of 4 at a time."""
    import numpy as np
    ks, n_cl = gemv_k_split(k), gemv_clusters(pairs, k, sms)
    tiles, nb = -(-pairs // GEMV_TILE_PAIRS), k // 32
    kr_blocks = nb // ks
    count = np.zeros((tiles, nb), dtype=np.int64)
    for c in range(n_cl):
        for w in range(GEMV_WARPS):
            for tile in range(c + n_cl * w, tiles, n_cl * GEMV_WARPS):
                for r in range(ks):
                    for st in range(kr_blocks * 32 // GEMV_UNIT_K):
                        b0 = r * kr_blocks + st * GEMV_UNIT_K // 32
                        count[tile, b0:b0 + GEMV_UNIT_K // 32] += 1
    return count


def gemv_staging_bytes(b: int, n: int, k: int, *, rms: bool, silu: bool,
                       sms: int) -> int:
    """Bytes a GEMV launch reads from L2 to stage its b f32 input rows of k:
    each block reads its K range of each row once (twice with an RMS
    prologue: its sum of squares, then the staging), so each cluster reads
    each row once or twice. n output features; SiLU(gate) * up pairs gate
    row j with up row j (n pairs), the other epilogues rows 2p, 2p+1."""
    clusters = gemv_clusters(n if silu else n // 2, k, sms)
    return clusters * b * k * 4 * (2 if rms else 1)


def gemv_pair_rows(kind: str, pairs: int, d: int = 0, device=None):
    """The two weight rows of each feature pair, as the GEMV's epilogues
    pair them (csrc/gemv.cuh pair_rows): "rope", features i and i + d/2 of
    each head of d; "silu", row p of gate and row p of up; "pairs", rows 2p
    and 2p + 1. Returns (rows_a, rows_b), int64 (pairs,)."""
    p = torch.arange(pairs, device=device)
    if kind == "rope":
        a = (p // (d // 2)) * d + p % (d // 2)
        return a, a + d // 2
    if kind == "silu":
        return p, p
    return 2 * p, 2 * p + 1


def gemv_tile(codes_a, scales_a, rows_a, rows_b, codes_b=None, scales_b=None):
    """One projection's weights in the order the GEMV reads them: tile t is
    pairs 8t..8t+7, its 16 rows the pairs' "a" rows (rows_a, of codes_a)
    then their "b" rows (rows_b, of codes_b, default codes_a); each tile is
    K / 128 stages of 4 blocks of 32 weights, stage s holding the codes of
    blocks 4s..4s+3 of the 16 rows, block-major ([block][row][bytes]), and
    their scales row-major ([row][block]). So a warp's stage is one
    contiguous run of codes and one of scales, and a tile's stages follow
    each other. codes (..., N, Kc) row-major as ops/quant_matmul.py keeps
    them, scales (..., N, K/32); a last tile short of 8 pairs is padded with
    zero rows. Returns (codes (..., T, K/128, 64 x bytes a block), scales
    (..., T, K/128, 64)), contiguous, in the input dtypes."""
    codes_b = codes_a if codes_b is None else codes_b
    scales_b = scales_a if scales_b is None else scales_b
    pairs, nb = rows_a.numel(), scales_a.shape[-1]
    if nb % GEMV_STAGE_BLOCKS or codes_a.shape[-1] % nb:
        raise ValueError(f"gemv_tile: K {nb * 32} is not a multiple of "
                         f"{GEMV_UNIT_K}")
    tiles, cb = -(-pairs // GEMV_TILE_PAIRS), codes_a.shape[-1] // nb

    def gather(t, rows):
        g = t.index_select(t.dim() - 2, rows.to(t.device))
        pad = tiles * GEMV_TILE_PAIRS - pairs
        if pad:
            g = torch.cat([g, g.new_zeros((*g.shape[:-2], pad, g.shape[-1]))], -2)
        return g.reshape(*g.shape[:-2], tiles, GEMV_TILE_PAIRS, g.shape[-1])

    c = torch.cat([gather(codes_a, rows_a), gather(codes_b, rows_b)], -2)
    c = c.reshape(*c.shape[:-1], nb // GEMV_STAGE_BLOCKS, GEMV_STAGE_BLOCKS, cb)
    c = c.movedim(-4, -2).reshape(*c.shape[:-4], nb // GEMV_STAGE_BLOCKS, -1)
    sc = torch.cat([gather(scales_a, rows_a), gather(scales_b, rows_b)], -2)
    sc = sc.reshape(*sc.shape[:-1], nb // GEMV_STAGE_BLOCKS, GEMV_STAGE_BLOCKS)
    sc = sc.movedim(-3, -2).reshape(*sc.shape[:-3], nb // GEMV_STAGE_BLOCKS, -1)
    return c.contiguous(), sc.contiguous()


def gemv_untile(codes_t, scales_t, rows_a, rows_b, n: int, apart: bool = False):
    """gemv_tile's inverse: the codes (..., n, Kc) and scales (..., n, K/32)
    of a tiled projection in row order; with `apart`, the "a" rows' tensor
    and the "b" rows' tensor as two such pairs (SiLU(gate) * up's gate and
    up)."""
    tiles, pairs = codes_t.shape[-3], rows_a.numel()
    c = codes_t.reshape(*codes_t.shape[:-1], GEMV_STAGE_BLOCKS, 16, -1)
    c = c.movedim(-2, -4).reshape(*codes_t.shape[:-2], 16, -1)
    sc = scales_t.reshape(*scales_t.shape[:-1], 16, GEMV_STAGE_BLOCKS)
    sc = sc.movedim(-2, -3).reshape(*scales_t.shape[:-2], 16, -1)

    def half(t, h):
        t = t[..., GEMV_TILE_PAIRS * h:GEMV_TILE_PAIRS * (h + 1), :]
        return t.reshape(*t.shape[:-3], tiles * GEMV_TILE_PAIRS, -1)[..., :pairs, :]

    def place(t, parts):
        out = t.new_zeros((*t.shape[:-3], n, t.shape[-1]))
        for rows, h in parts:
            out.index_copy_(out.dim() - 2, rows.to(t.device), half(t, h))
        return out

    if apart:
        return ((place(c, [(rows_a, 0)]), place(sc, [(rows_a, 0)])),
                (place(c, [(rows_b, 1)]), place(sc, [(rows_b, 1)])))
    parts = [(rows_a, 0), (rows_b, 1)]
    return place(c, parts), place(sc, parts)


def weight_rows(codes_t, scales_t, kind: str, n: int, d: int = 0):
    """A tiled projection (gemv_tile) in row order, for the plain versions:
    (codes, scales) of its n rows; for "silu" (n pairs of gate and up) the
    pair ((gate codes, scales), (up codes, scales))."""
    rows = gemv_pair_rows(kind, n if kind == "silu" else n // 2, d)
    return gemv_untile(codes_t, scales_t, *rows, n, apart=kind == "silu")


class LlamaMegaLayers(NamedTuple):
    """Per-layer weights in the megastep layout (all stacked on L).

    Each projection tiled for the GEMV (gemv_tile: (L, tiles, K/128, ...)
    codes and scales), Q4 nibble-packed: qkv = concat(q, k, v) on N, its
    pairs RoPE's (features i and i + d/2 of a head); o and down pair rows
    2p, 2p + 1; gate_up pairs gate row p with up row p. Scales as the TPU
    kernel's prep keeps them: qkv float32, the others bfloat16 (K6's copy,
    `ops/llama_flat.prep_llama_flat`, has every scale in bfloat16). norms
    packs (in_norm, post_norm).
    """

    qkv_codes: torch.Tensor       # (L, (H + 2 KV) / 16, H / 128, 64 Cb)
    qkv_scales: torch.Tensor      # (L, (H + 2 KV) / 16, H / 128, 64)
    o_codes: torch.Tensor         # (L, H / 16, H / 128, 64 Cb)
    o_scales: torch.Tensor
    gate_up_codes: torch.Tensor   # (L, F / 8, H / 128, 64 Cb)
    gate_up_scales: torch.Tensor
    down_codes: torch.Tensor      # (L, H / 16, F / 128, 64 Cb)
    down_scales: torch.Tensor     # (L, H / 16, F / 128, 64)
    norms: torch.Tensor           # (L, 2, H) f32


def gemv_k_ok(k: int) -> bool:
    """K the GEMV takes: whole stages on each block of its cluster."""
    return k > 0 and k % (GEMV_UNIT_K * gemv_k_split(k)) == 0


def prep_llama_mega(layers, head_dim: int) -> tuple[LlamaMegaLayers, int]:
    """LlamaMegaLayers from stacked OrpheusLayer weights whose 7 projections
    are QuantTensors of one block qtype, heads of `head_dim`. Raises
    ValueError otherwise, or where a width is not one the GEMV takes (the
    caller then takes the per-matmul path)."""
    mats = [layers.q, layers.k, layers.v, layers.o, layers.gate, layers.up,
            layers.down]
    if not all(isinstance(m, QuantTensor) for m in mats):
        raise ValueError("llama megastep needs all projections quantized")
    qtypes = {m.qtype for m in mats}
    if len(qtypes) != 1 or next(iter(qtypes)) not in BIAS:
        raise ValueError(f"llama megastep needs one uniform qtype, got {qtypes}")
    qtype = next(iter(qtypes))
    q, k, v, o, gate, up, down = [m.pack() for m in mats]
    hidden, ffn = o.shape[0], gate.shape[0]
    if not (gemv_k_ok(hidden) and gemv_k_ok(ffn) and head_dim % 2 == 0
            and hidden % head_dim == 0):
        raise ValueError(f"llama megastep: H {hidden}, F {ffn}, heads of "
                         f"{head_dim} are not widths the GEMV takes")

    def bf16(m):
        return m.scales.to(torch.bfloat16)

    qkv_c = torch.cat([q.codes, k.codes, v.codes], dim=-2)
    qkv_s = torch.cat([q.scales, k.scales, v.scales], dim=-2).float()
    qkv = gemv_tile(qkv_c, qkv_s, *gemv_pair_rows("rope", qkv_c.shape[-2] // 2,
                                                   head_dim))
    o_t = gemv_tile(o.codes, bf16(o), *gemv_pair_rows("pairs", hidden // 2))
    gu = gemv_tile(gate.codes, bf16(gate), *gemv_pair_rows("silu", ffn),
                   codes_b=up.codes, scales_b=bf16(up))
    down_t = gemv_tile(down.codes, bf16(down), *gemv_pair_rows("pairs", hidden // 2))
    mega = LlamaMegaLayers(
        *qkv, *o_t, *gu, *down_t,
        norms=torch.stack([layers.in_norm, layers.post_norm],
                          dim=1).float().contiguous())
    return mega, qtype


def rms_norm(x, w, eps: float = RMS_EPS):
    """x * rsqrt(mean(x^2) + eps) * w over the last axis, as the TPU kernel's
    `_rms` writes it."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def dqdot(x, codes, scales, qtype):
    """The `_dqdot` product x (M, K) @ W^T whatever the scale dtype: W
    dequantized in f32 and rounded to bf16, x rounded to bf16, f32 sums."""
    w = dequant(codes, scales, qtype).to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w.T


def _rope(y, cos, sin):
    """NeoX rotation of y (heads, d) with cos/sin (d/2,)."""
    h = y.shape[-1] // 2
    y1, y2 = y[:, :h], y[:, h:]
    return torch.cat([y1 * cos - y2 * sin, y2 * cos + y1 * sin], dim=1)


def _write_row(cache, p, rows, n_heads):
    """cache (heads, CTX, D)[:, p, :] = rows (heads * D,) — in place."""
    cache.index_copy_(1, p, rows.reshape(n_heads, 1, -1).to(cache.dtype))


def llama_megastep_plain(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                         qtype: int, n_heads: int, n_kv: int, inv_freq):
    """K8's plain PyTorch version. x (1, H); kv_k/kv_v (L, n_kv, CTX, D),
    written in place at row pos; pos an int or one-element int tensor;
    inv_freq (D/2,) float32 (`ops/attention.rope_freqs`). Returns
    (x_out (1, H) f32 before the final norm, k_new (L, KV), v_new (L, KV))."""
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    d = hidden // n_heads
    kvh = n_kv * d
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    ctx = kv_k.shape[2]
    p = torch.as_tensor(pos, device=x.device).reshape(1).long()
    ang = p.float() * inv_freq.float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    p = p.clamp(max=ctx - 1)
    x = x.float()
    k_new, v_new = [], []
    for l in range(n_layers):
        nm = mega.norms[l]
        qkv = dqdot(rms_norm(x, nm[0]), *weight_rows(
            mega.qkv_codes[l], mega.qkv_scales[l], "rope", hidden + 2 * kvh, d),
            qtype)[0]
        q = _rope(qkv[:hidden].reshape(n_heads, d), cos, sin)
        k = _rope(qkv[hidden:hidden + kvh].reshape(n_kv, d), cos, sin).reshape(-1)
        v = qkv[hidden + kvh:]
        _write_row(kv_k[l], p, k, n_kv)
        _write_row(kv_v[l], p, v, n_kv)
        attn = decode_attention_plain(q, kv_k[l], kv_v[l], p)
        x = x + dqdot(attn.reshape(1, hidden), *weight_rows(
            mega.o_codes[l], mega.o_scales[l], "pairs", hidden), qtype)
        h = rms_norm(x, nm[1])
        gate, up = weight_rows(mega.gate_up_codes[l], mega.gate_up_scales[l],
                               "silu", ffn)
        act = torch.nn.functional.silu(dqdot(h, *gate, qtype)) * \
            dqdot(h, *up, qtype)
        x = x + dqdot(act, *weight_rows(mega.down_codes[l], mega.down_scales[l],
                                        "pairs", hidden), qtype)
        k_new.append(k)
        v_new.append(v)
    return x, torch.stack(k_new), torch.stack(v_new)


def llama_megastep_batched_plain(mega: LlamaMegaLayers, x, kv_k, kv_v, pos,
                                 *, qtype: int, n_heads: int, n_kv: int,
                                 inv_freq):
    """K9's plain PyTorch version: `llama_megastep_plain` applied per slot,
    as the JAX package's `llama_megastep_batched_reference` is. x (B, H);
    kv_k/kv_v (L, B, n_kv, CTX, D), each slot's row pos[s] written in place;
    pos (B,). Returns (x_out (B, H), k_new (L, B, KV), v_new (L, B, KV))."""
    p = torch.as_tensor(pos).reshape(-1)
    outs = [llama_megastep_plain(mega, x[s:s + 1], kv_k[:, s], kv_v[:, s],
                                 p[s], qtype=qtype, n_heads=n_heads,
                                 n_kv=n_kv, inv_freq=inv_freq)
            for s in range(x.shape[0])]
    return (torch.cat([o[0] for o in outs]),
            torch.stack([o[1] for o in outs], 1),
            torch.stack([o[2] for o in outs], 1))


def tiles_packed(codes_t) -> bool:
    """Whether tiled codes (gemv_tile) hold Q4_0 nibble-packed blocks (16
    bytes a row a block; one-byte codes take 32)."""
    return codes_t.shape[-1] == 16 * 16 * GEMV_STAGE_BLOCKS


def require_tiles(codes_t, scales_t, name: str, dev, pairs: int, k: int,
                  lead: int = 1) -> None:
    """Validate one tiled projection (gemv_tile) with `lead` leading dims
    (layers) for a GEMV launch over `pairs` feature pairs and K = k."""
    _build.require(codes_t, name + "_codes", device=dev,
                   dtypes=(torch.uint8, torch.int8), ndim=lead + 3)
    _build.require(scales_t, name + "_scales", device=dev,
                   dtypes=(torch.float32, torch.bfloat16), ndim=lead + 3)
    tiles = -(-pairs // GEMV_TILE_PAIRS)
    stages = k // GEMV_UNIT_K
    if (codes_t.shape[lead:lead + 2] != (tiles, stages)
            or codes_t.shape[-1] not in (256 * GEMV_STAGE_BLOCKS,
                                         512 * GEMV_STAGE_BLOCKS)
            or scales_t.shape[lead:] != (tiles, stages, 16 * GEMV_STAGE_BLOCKS)
            or not gemv_k_ok(k)):
        raise ValueError(f"{name}: tiles {tuple(codes_t.shape)} / "
                         f"{tuple(scales_t.shape)} for {pairs} pairs over K {k}")


class StepScratch(NamedTuple):
    """Buffers a step on the card reuses layer after layer; a caller that
    steps often (the batched engine) allocates them once."""

    attn: torch.Tensor   # (B, heads, D) attention output
    act: torch.Tensor    # (B, F) SiLU(gate) * up
    part: tuple          # the attention kernel's partial states


def step_scratch(mega: LlamaMegaLayers, b: int, n_heads: int, ctx: int,
                 device) -> StepScratch:
    hidden = mega.norms.shape[2]
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    d = hidden // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return StepScratch(attn=torch.empty((b, n_heads, d), **f32),
                       act=torch.empty((b, ffn), **f32),
                       part=da.attention_scratch(b, n_heads, ctx, d, device))


def group_scratch(scratch: StepScratch | None, g: slice):
    """The rows of `scratch` (step_scratch for a whole batch) that slot
    group g uses; the attention partials are shared, as the groups run one
    after another on one stream."""
    return None if scratch is None else scratch._replace(
        attn=scratch.attn[g], act=scratch.act[g])


def require_step(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, inv_freq, *,
                 n_heads: int) -> None:
    """Validate a step's tensors on the card for B <= 16 rows (x (B, H),
    kv_k / kv_v (L, B, n_kv, CTX, D), pos (B,) int32, inv_freq (D/2,)
    float32, heads of any size K3 / K4 take); raise ValueError on what the
    kernels do not take."""
    dev = x.device
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    b, n_kv, ctx, d = kv_k.shape[1], kv_k.shape[2], kv_k.shape[3], kv_k.shape[4]
    kvn = hidden + 2 * n_kv * d
    _build.require(x, "x", device=dev, dtypes=(torch.float32,), ndim=2)
    _build.require(kv_k, "kv_k", device=dev,
                   dtypes=(torch.bfloat16, torch.float32), ndim=5, outer=1)
    _build.require(kv_v, "kv_v", device=dev, dtypes=(kv_k.dtype,), ndim=5,
                   outer=1)
    _build.require(mega.norms, "norms", device=dev, dtypes=(torch.float32,),
                   ndim=3)
    _build.require(pos, "pos", device=dev, dtypes=(torch.int32,), align=4)
    _build.require(inv_freq, "inv_freq", device=dev, dtypes=(torch.float32,),
                   ndim=1, align=4)
    for name, n, k, pairs in (("qkv", kvn, hidden, kvn // 2),
                              ("o", hidden, hidden, hidden // 2),
                              ("gate_up", ffn, hidden, ffn),
                              ("down", hidden, ffn, hidden // 2)):
        require_tiles(getattr(mega, name + "_codes"),
                      getattr(mega, name + "_scales"), name, dev, pairs, k)
    if (x.shape != (b, hidden) or kv_k.shape != (n_layers, b, n_kv, ctx, d)
            or kv_v.shape != kv_k.shape or hidden != n_heads * d
            or inv_freq.numel() != d // 2 or not da.head_size_ok(d, kv_k.dtype)
            or pos.numel() != b or not 0 < b <= MAX_BATCH):
        raise ValueError(f"llama_megastep: x {tuple(x.shape)}, kv "
                         f"{tuple(kv_k.shape)}, L={n_layers} "
                         f"H={hidden}, {n_heads} heads, inv_freq "
                         f"{tuple(inv_freq.shape)}, pos {tuple(pos.shape)}, "
                         f"at most {MAX_BATCH} rows")


def layers_cuda(gemv_kernel, attn_kernel, mega: LlamaMegaLayers, x, kv_k,
                kv_v, pos, *, qtype: int, n_heads: int, inv_freq,
                scratch: StepScratch | None = None):
    """The L layers on the card as a launch sequence, for B <= 16 rows:
    x (B, H), kv_k/kv_v (L, B, n_kv, CTX, D) (each slot's cache dense, the
    layer axis at any stride: a group of a larger batch's slots), pos (B,)
    int32, inv_freq (D/2,) float32, all on the card. Per layer 4 GEMV
    launches through `gemv_kernel` (K9's or K7's counter) and 1 attention
    launch through `attn_kernel` (K4's), on the current stream. K9 and K7
    run on it; so do K8 and K6 through them at one slot where the
    persistent step does not take the head size (the models' gates), and
    it is chip_smoke's yardstick for the persistent step. `scratch`
    (step_scratch) is allocated when not given. Returns (x_out (B, H),
    k_new (L, B, KV), v_new (L, B, KV))."""
    dev = x.device
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    b, n_kv, ctx, d = kv_k.shape[1], kv_k.shape[2], kv_k.shape[3], kv_k.shape[4]
    kvh = n_kv * d
    kvn = hidden + 2 * kvh
    require_step(mega, x, kv_k, kv_v, pos, inv_freq, n_heads=n_heads)
    sc = scratch or step_scratch(mega, b, n_heads, ctx, dev)
    if sc.attn.shape != (b, n_heads, d) or sc.act.shape != (b, ffn):
        raise ValueError(f"llama_megastep: scratch for {tuple(sc.act.shape)} "
                         f"does not fit {b} rows")
    packed = int(tiles_packed(mega.qkv_codes))
    cache_bf16 = int(kv_k.dtype == torch.bfloat16)
    kv_bstride = n_kv * ctx * d
    stream = _build.stream_ptr(dev)
    xw = x.clone()
    qkv = torch.empty((n_layers, b, kvn), dtype=torch.float32, device=dev)
    nm, vp = mega.norms, ctypes.c_void_p
    null = vp(0)
    pos_p, inv_p = vp(pos.data_ptr()), vp(inv_freq.data_ptr())
    x_p, attn_p, act_p = (vp(t.data_ptr()) for t in (xw, sc.attn, sc.act))

    def gemv(xin, rms, name, l, n, k, res, out, epi, norm=null, kc=null,
             vc=null):
        scales = getattr(mega, name + "_scales")
        ca = vp(addr(getattr(mega, name + "_codes"), l))
        sa = vp(addr(scales, l))
        gemv_kernel(xin, norm, rms, ca, sa, ca, sa, qtype, packed,
                    int(scales.dtype == torch.bfloat16), b, n, k, res, out,
                    epi, inv_p, pos_p, 1, kc, vc, hidden,
                    kvh, d, ctx, cache_bf16, kv_bstride, stream)

    for l in range(n_layers):
        q_out = qkv[l]
        gemv(x_p, 1, "qkv", l, kvn, hidden, null, vp(q_out.data_ptr()),
             EPI_ROPE_QKV, norm=vp(addr(nm, l, 0)),
             kc=vp(addr(kv_k, l)), vc=vp(addr(kv_v, l)))
        da._launch(attn_kernel, q_out[:, :hidden].unflatten(1, (n_heads, d)),
                   kv_k[l], kv_v[l], pos, None, sc.attn, sc.part)
        gemv(attn_p, 0, "o", l, hidden, hidden, x_p, x_p, EPI_RESIDUAL)
        gemv(x_p, 1, "gate_up", l, ffn, hidden, null, act_p, EPI_SILU_MUL,
             norm=vp(addr(nm, l, 1)))
        gemv(act_p, 0, "down", l, hidden, ffn, x_p, x_p, EPI_RESIDUAL)
    return xw, qkv[:, :, hidden:hidden + kvh], qkv[:, :, hidden + kvh:]


def persistent_step(kernel, layers: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                    qtype: int, n_heads: int, n_kv: int, inv_freq, head=None,
                    out_norm=None):
    """One launch of the persistent step (csrc/llama_flat.cu) through
    `kernel` (K8's or K6's counter), validated as `layers_cuda` validates
    one row, heads of 64 or 128: x (1, H); kv_k / kv_v (L, n_kv, CTX, D),
    written in place at row pos. Returns (x_out (1, H), k_new (L, KV), v_new
    (L, KV), logits (1, vocab_pad) with K6's `head` and `out_norm`, else
    None). Raises where the card refuses the launch (a grid that cannot be
    resident at once among them)."""
    from . import llama_persistent
    if kv_k.dim() != 4 or kv_k.shape[1] != n_kv or pos.numel() != 1:
        raise ValueError(f"llama step: kv {tuple(kv_k.shape)}, n_kv {n_kv}, "
                         f"pos {tuple(pos.shape)}")
    xw = x.float().reshape(1, -1).contiguous().clone()
    require_step(layers, xw, kv_k.unsqueeze(1), kv_v.unsqueeze(1), pos,
                 inv_freq, n_heads=n_heads)
    hidden, kvh = layers.norms.shape[2], n_kv * kv_k.shape[3]
    for name in ("o", "gate_up", "down"):
        if getattr(layers, name + "_scales").dtype != torch.bfloat16:
            raise ValueError(f"llama step: {name} scales must be bfloat16")
    qkv, logits = llama_persistent.launch(
        kernel, layers, xw, kv_k, kv_v, pos, inv_freq, qtype=qtype,
        n_heads=n_heads, head=head, out_norm=out_norm)
    return xw, qkv[:, 0, hidden:hidden + kvh], qkv[:, 0, hidden + kvh:], logits


def llama_megastep_cuda(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                        qtype: int, n_heads: int, n_kv: int, inv_freq):
    """K8 on the card: one cooperative launch of the persistent step
    (csrc/llama_flat.cu, planned by ops/llama_persistent.py) on the current
    stream, equal to the launch sequence bit for bit. Same contract as
    `llama_megastep_plain`, with pos a one-element int32 CUDA tensor; heads
    of 64 or 128 (da.STEP_HEAD_SIZES: the Orpheus gate sends other sizes to
    K9's launch sequence). Raises where the card refuses the launch."""
    xo, kn, vn, _ = persistent_step(KERNEL, mega, x, kv_k, kv_v, pos,
                                    qtype=qtype, n_heads=n_heads, n_kv=n_kv,
                                    inv_freq=inv_freq)
    return xo, kn, vn


def llama_megastep(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *, qtype: int,
                   n_heads: int, n_kv: int, inv_freq):
    """Dispatch: K8 for CUDA tensors, the plain version for CPU tensors. See
    `llama_megastep_plain` for the contract."""
    fn = llama_megastep_plain if x.device.type == "cpu" else llama_megastep_cuda
    return fn(mega, x, kv_k, kv_v, pos, qtype=qtype, n_heads=n_heads,
              n_kv=n_kv, inv_freq=inv_freq)


def persistent_batched(counter, layers: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                       qtype: int, n_heads: int, n_kv: int, inv_freq):
    """The L layers for B slots through the batched persistent step
    (csrc/llama_flat_batched.cu), one launch on `counter` (K9's or K7's) for
    each group of at most `llama_persistent.max_rows` slots
    (`_build.slot_groups`), validated as `layers_cuda` validates a group.
    x (B, H); kv_k / kv_v (L, B, n_kv, CTX, D), each slot's row pos[s]
    written in place; pos (B,) int32. Returns (x_out (B, H), k_new (L, B,
    KV), v_new (L, B, KV)). Raises where the card refuses a launch."""
    from . import llama_persistent as lp
    hidden, kvh = layers.norms.shape[2], n_kv * kv_k.shape[4]
    ffn = layers.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    cap = lp.max_rows(hidden, ffn, tiles_packed(layers.qkv_codes),
                      layers.qkv_scales.dtype == torch.bfloat16)
    outs = []
    for g in _build.slot_groups(x.shape[0], cap):
        xg = x[g].clone()
        require_step(layers, xg, kv_k[:, g], kv_v[:, g], pos[g], inv_freq,
                     n_heads=n_heads)
        qkv = lp.launch_batched(counter, layers, xg, kv_k[:, g], kv_v[:, g],
                                pos[g], inv_freq, qtype=qtype, n_heads=n_heads)
        outs.append((xg, qkv[:, :, hidden:hidden + kvh], qkv[:, :, hidden + kvh:]))
    return _build.cat_groups(outs)


def takes_persistent_batched(layers: LlamaMegaLayers, d: int) -> bool:
    """The route gate of K9 and K7's layer stack, before any launch: the
    batched persistent step for heads of 64 / 128 (at widths where a row
    fits its shared memory), else the launch sequence."""
    from . import llama_persistent as lp
    return d in da.STEP_HEAD_SIZES and lp.max_rows(
        layers.norms.shape[2], layers.gate_up_codes.shape[1] * GEMV_TILE_PAIRS,
        tiles_packed(layers.qkv_codes),
        layers.qkv_scales.dtype == torch.bfloat16) > 0


def llama_megastep_batched_sequence(mega: LlamaMegaLayers, x, kv_k, kv_v, pos,
                                    *, qtype: int, n_heads: int, n_kv: int,
                                    inv_freq, scratch: StepScratch | None = None):
    """K9's launch sequence: 4 batched GEMV launches and 1 K4 launch per
    layer for each group of at most 16 slots (`_build.slot_groups`), one
    group after another, on the current stream and K9's counter: the route
    for heads of other sizes than 64 / 128, and the yardstick the
    persistent steps equal bit for bit. Same contract as
    `llama_megastep_batched_cuda`."""
    if kv_k.dim() != 5 or kv_k.shape[2] != n_kv:
        raise ValueError(f"llama_megastep_batched: kv {tuple(kv_k.shape)}, "
                         f"n_kv {n_kv}")
    x = x.float().contiguous()
    return _build.cat_groups([
        layers_cuda(KERNEL_BATCHED, da.KERNEL_BATCHED, mega, x[g], kv_k[:, g],
                    kv_v[:, g], pos[g], qtype=qtype, n_heads=n_heads,
                    inv_freq=inv_freq, scratch=group_scratch(scratch, g))
        for g in _build.slot_groups(x.shape[0], MAX_BATCH)])


def llama_megastep_batched_cuda(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                                qtype: int, n_heads: int, n_kv: int, inv_freq,
                                scratch: StepScratch | None = None):
    """K9 on the card, on the current stream: for heads of 64 / 128 one
    cooperative launch of the batched persistent step for each group of at
    most R slots (`persistent_batched`); for other head sizes the launch
    sequence (`llama_megastep_batched_sequence`, which alone uses
    `scratch`). The gate is applied before any launch, and a launch the
    card refuses raises. Every slot equals K8 on its state bit for bit.
    Same contract as `llama_megastep_batched_plain`, with pos a (B,) int32
    CUDA tensor."""
    if kv_k.dim() != 5 or kv_k.shape[2] != n_kv:
        raise ValueError(f"llama_megastep_batched: kv {tuple(kv_k.shape)}, "
                         f"n_kv {n_kv}")
    kw = dict(qtype=qtype, n_heads=n_heads, n_kv=n_kv, inv_freq=inv_freq)
    if takes_persistent_batched(mega, kv_k.shape[4]):
        return persistent_batched(KERNEL_BATCHED, mega, x.float().contiguous(),
                                  kv_k, kv_v, pos, **kw)
    return llama_megastep_batched_sequence(mega, x, kv_k, kv_v, pos,
                                           scratch=scratch, **kw)


def llama_megastep_batched(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                           qtype: int, n_heads: int, n_kv: int, inv_freq,
                           scratch: StepScratch | None = None):
    """Dispatch: K9 for CUDA tensors, the plain version for CPU tensors
    (which ignores `scratch`). See `llama_megastep_batched_plain`."""
    kw = dict(qtype=qtype, n_heads=n_heads, n_kv=n_kv, inv_freq=inv_freq)
    if x.device.type == "cpu":
        return llama_megastep_batched_plain(mega, x, kv_k, kv_v, pos, **kw)
    return llama_megastep_batched_cuda(mega, x, kv_k, kv_v, pos,
                                       scratch=scratch, **kw)
