"""One Parler decode step over all L layers: kernels K2 (one sequence) and
K5 (B batch slots sharing one read of the weights).

Computes the JAX package's `parler_megastep` (reference
`parler_megastep_reference`) and `parler_megastep_batched` (reference
`parler_megastep_batched_reference`): per layer LN -> qkv -> self-attention
over the cache -> o -> LN -> cross-q -> cross-attention over the precomputed
(heads, Tc, D) K/V -> co -> LN -> fc1 -> tanh-GELU -> fc2, with block-
quantized weights at bf16-rounded dequant and bf16-rounded activations, f32
sums (`_dqdot` numerics). Returns the pre-final-norm x and each layer's
k_new / v_new.

On the card the step is a sequence of hand-written kernels on one stream
(csrc/parler_megastep.cu, its header says why): per layer 6 launches of the
dequant GEMV (csrc/parler_gemv.cuh: tensor cores, the input rows staged as
bf16 behind the fused layer norm, the weights streamed through a cp.async
ring, the residual add or GELU fused after it), and 2 launches of the
decode attention (ops/decode_attention.py) for the self- and
cross-attention. K2 and K5 are one kernel (K2 is B = 1) and one launch
sequence, `_megastep_cuda`; K2 uses K3 for attention and K5 uses K4. Each
row of a batched GEMV sums in the order a one-row GEMV does, so slot s of
K5 equals K2 on slot s's state bit for bit. On CPU tensors
`parler_megastep_plain` / `parler_megastep_batched_plain` compute the same
in plain PyTorch.

The prep (`prep_mega_layers`) lays each projection out in the order the
GEMV streams it: tiles of 16 weight rows (rows 2p and 2p + 1 of pairs p,
`llama_megastep.gemv_tile`'s "pairs"), each a run of stages of 128
weights, Q4_0 nibble-packed; the plain versions read the same tiles back in
row order (`projection_rows`).

Unlike the TPU kernel, which folds the current token's k/v into the softmax
and leaves the cache write to its caller, this step writes k/v into cache
row `pos` IN PLACE first and then attends rows [0, pos]. That is exact in
f32; on a bf16 cache the current row is rounded to bf16 before it is
attended (the plain version does the same, so kernel and plain agree).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._build import addr
from . import decode_attention as da
from .decode_attention import decode_attention_plain
from .llama_megastep import gemv_pair_rows, gemv_tile, tiles_packed, weight_rows
from .quant_matmul import BIAS, QuantTensor, quant_matmul_plain

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_ARGS = [_vp, _vp, _vp, _i32, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _vp, _vp,
         _i32, _vp, _vp, _vp, _i32, _i32, _i32, _i32, ctypes.c_longlong, _vp]
# One C entry serves both; each path counts its own launches.
KERNEL = _build.Kernel("parler_megastep", "tts_parler_gemv", _ARGS)          # K2
KERNEL_BATCHED = _build.Kernel("parler_megastep", "tts_parler_gemv", _ARGS)  # K5
EPI_STORE, EPI_RESIDUAL, EPI_GELU, EPI_QKV = 0, 1, 2, 3
LN_EPS = 1e-5
MAX_BATCH = 16  # rows one batched GEMV launch takes; larger batches run in groups
# csrc/parler_gemv.cuh's shapes: a warp's tile is TILE_ROWS weight rows,
# streamed in stages of GEMV_UNIT_K weights through a ring of GEMV_RING
# stages, GEMV_WARPS warps a block; the rings, the partial sums of the
# warps that share a tile's K and the staged rows share a block's dynamic
# shared memory, at most GEMV_SMEM_LIMIT bytes.
TILE_ROWS, GEMV_UNIT_K, GEMV_RING, GEMV_WARPS = 16, 128, 4, 8
GEMV_SMEM_LIMIT = 226 * 1024


def gemv_smem_bytes(b: int, k: int, packed: bool = True) -> int:
    """A GEMV block's dynamic shared memory at b rows of k (csrc/
    parler_gemv.cuh smem_bytes): the warps' rings of 4 stages (1152 bytes
    for Q4_0, 2176 for one-byte codes), a float4 a lane a warp an n-tile of
    partial sums, and the b rows as bf16, each padded to 32 bytes past a
    multiple of 128."""
    stage = 4 * 16 * (16 if packed else 32) + 16 * 4 * 2
    nt = 1 if b <= 8 else 2
    return GEMV_WARPS * (GEMV_RING * stage + nt * 512) + \
        b * (-(-k * 2 // 128) * 128 + 32)


class MegaLayers(NamedTuple):
    """Per-layer weights in the megastep layout (all stacked on L).

    Each projection tiled for the GEMV (`llama_megastep.gemv_tile`, pairs
    of rows 2p, 2p + 1: (L, N / 16, K / 128, 64 Cb) codes, Cb 16 for Q4_0
    nibble-packed, 32 for one-byte codes, and (L, N / 16, K / 128, 64)
    bf16 scales). qkv = concat(q, k, v) on N; occ = concat(o, cq, co) on N,
    H / 16 tiles each. norms packs (ln1_w, ln1_b, lnc_w, lnc_b, ln2_w,
    ln2_b).
    """

    qkv_codes: torch.Tensor   # (L, 3H / 16, H / 128, 64 Cb)
    qkv_scales: torch.Tensor  # (L, 3H / 16, H / 128, 64) bf16
    occ_codes: torch.Tensor   # (L, 3H / 16, H / 128, 64 Cb)
    occ_scales: torch.Tensor  # (L, 3H / 16, H / 128, 64) bf16
    fc1_codes: torch.Tensor   # (L, F / 16, H / 128, 64 Cb)
    fc1_scales: torch.Tensor  # (L, F / 16, H / 128, 64) bf16
    fc2_codes: torch.Tensor   # (L, H / 16, F / 128, 64 Cb)
    fc2_scales: torch.Tensor  # (L, H / 16, F / 128, 64) bf16
    norms: torch.Tensor       # (L, 6, H) f32
    cross_k: torch.Tensor     # (L, heads, Tc, D) f32
    cross_v: torch.Tensor     # (L, heads, Tc, D) f32
    cross_pos: torch.Tensor   # (1,) int32 = Tc - 1: cross-attention reads all rows


def tile_projection(*ms: QuantTensor):
    """The GEMV's tiles of the projections ms (QuantTensors of one qtype,
    (..., N_i, K)) joined on N: Q4_0 codes nibble-packed, scales bf16, in
    `gemv_tile`'s order for pairs of rows 2p, 2p + 1. Returns (codes (...,
    N / 16, K / 128, 64 Cb), scales (..., N / 16, K / 128, 64)),
    contiguous."""
    ms = [m.pack() for m in ms]
    codes = torch.cat([m.codes for m in ms], dim=-2)
    scales = torch.cat([m.scales.to(torch.bfloat16) for m in ms], dim=-2)
    return gemv_tile(codes, scales,
                     *gemv_pair_rows("pairs", codes.shape[-2] // 2))


def prep_mega_layers(layers) -> tuple[MegaLayers, int]:
    """MegaLayers from stacked ParlerLayerWeights whose 8 projections are
    QuantTensors of one block qtype (Q4_0 codes packed here if they are
    not), H and F multiples of 128. Raises ValueError otherwise (the caller
    then takes the per-matmul path)."""
    mats = [layers.q_w, layers.k_w, layers.v_w, layers.o_w, layers.cq_w,
            layers.co_w, layers.fc1, layers.fc2]
    if not all(isinstance(m, QuantTensor) for m in mats):
        raise ValueError("megastep needs all projections quantized")
    qtypes = {m.qtype for m in mats}
    if len(qtypes) != 1 or next(iter(qtypes)) not in BIAS:
        raise ValueError(f"megastep needs one uniform qtype, got {qtypes}")
    qtype = next(iter(qtypes))
    q, k, v, o, cq, co, f1, f2 = mats
    hidden, ffn = o.shape[0], f1.shape[0]
    if hidden % GEMV_UNIT_K or ffn % GEMV_UNIT_K:
        raise ValueError(f"megastep needs H and F multiples of {GEMV_UNIT_K}, "
                         f"got H={hidden} F={ffn}")
    norms = torch.stack([layers.ln1_w, layers.ln1_b, layers.lnc_w,
                         layers.lnc_b, layers.ln2_w, layers.ln2_b], dim=1)
    tc = layers.cross_k.shape[2]
    mega = MegaLayers(
        *tile_projection(q, k, v), *tile_projection(o, cq, co),
        *tile_projection(f1), *tile_projection(f2),
        norms=norms.float().contiguous(),
        cross_k=layers.cross_k.float().contiguous(),
        cross_v=layers.cross_v.float().contiguous(),
        cross_pos=torch.tensor([tc - 1], dtype=torch.int32,
                               device=norms.device))
    return mega, qtype


def layer_norm(x, w, b, eps: float = LN_EPS):
    """(x - mean) * rsqrt(mean((x - mean)^2) + eps) * w + b over the last
    axis, as the TPU kernel's `_ln` writes it."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def mega_dims(mega: MegaLayers) -> tuple[int, int, int]:
    """(L, H, F) of a MegaLayers."""
    return (mega.norms.shape[0], mega.norms.shape[2],
            mega.fc1_codes.shape[1] * TILE_ROWS)


def projection_rows(codes_t, scales_t):
    """A tiled projection (MegaLayers, one layer's or a slice of its tiles)
    in row order, for the plain versions: (codes (N, Kc), scales (N,
    K/32))."""
    return weight_rows(codes_t, scales_t, "pairs", codes_t.shape[-3] * TILE_ROWS)


def require_mega(mega: MegaLayers, dev) -> None:
    """Validate MegaLayers for the kernels on `dev`: tiled codes and bf16
    scales of the widths the norms give, H and F multiples of 128."""
    _, hidden, ffn = mega_dims(mega)
    _build.require(mega.norms, "norms", device=dev, dtypes=(torch.float32,),
                   ndim=3)
    for name, n, k in (("qkv", 3 * hidden, hidden), ("occ", 3 * hidden, hidden),
                       ("fc1", ffn, hidden), ("fc2", hidden, ffn)):
        codes, scales = getattr(mega, name + "_codes"), getattr(mega, name + "_scales")
        _build.require(codes, name + "_codes", device=dev,
                       dtypes=(torch.uint8, torch.int8), ndim=4)
        _build.require(scales, name + "_scales", device=dev,
                       dtypes=(torch.bfloat16,), ndim=4)
        if (k % GEMV_UNIT_K or n % TILE_ROWS
                or codes.shape[1:3] != (n // TILE_ROWS, k // GEMV_UNIT_K)
                or codes.shape[3] not in (1024, 2048)
                or scales.shape[1:] != (n // TILE_ROWS, k // GEMV_UNIT_K, 64)):
            raise ValueError(f"{name}: tiles {tuple(codes.shape)} / "
                             f"{tuple(scales.shape)} for N {n}, K {k}")


def _qdot(h, codes, scales, qtype):
    return quant_matmul_plain(h, QuantTensor(codes, scales, qtype))


def _write_row(cache, p, rows, n_heads):
    """cache (heads, CTX, D)[:, p, :] = rows (H,) — in place."""
    cache.index_copy_(1, p, rows.reshape(n_heads, 1, -1).to(cache.dtype))


def parler_megastep_plain(mega: MegaLayers, x, kv_k, kv_v, pos, *,
                          qtype: int, use_cross: bool, n_heads: int):
    """K2's plain PyTorch version. x (1, H); kv_k/kv_v (L, heads, CTX, D),
    written in place at row pos; pos an int or one-element int tensor.
    Returns (x_out (1, H) f32, k_new (L, H), v_new (L, H))."""
    n_layers, hidden, _ = mega_dims(mega)
    d, th = hidden // n_heads, hidden // TILE_ROWS
    ctx = kv_k.shape[2]
    p = torch.as_tensor(pos, device=x.device).reshape(1).long().clamp(max=ctx - 1)
    x = x.float()
    k_new, v_new = [], []
    for l in range(n_layers):
        nm = mega.norms[l]

        def occ(i):   # o, cq, co: H / 16 tiles each
            return projection_rows(mega.occ_codes[l, i * th:(i + 1) * th],
                                   mega.occ_scales[l, i * th:(i + 1) * th])

        qkv = _qdot(layer_norm(x, nm[0], nm[1]), *projection_rows(
            mega.qkv_codes[l], mega.qkv_scales[l]), qtype)[0]
        q, k, v = qkv[:hidden], qkv[hidden:2 * hidden], qkv[2 * hidden:]
        _write_row(kv_k[l], p, k, n_heads)
        _write_row(kv_v[l], p, v, n_heads)
        attn = decode_attention_plain(q.reshape(n_heads, d), kv_k[l], kv_v[l], p)
        x = x + _qdot(attn.reshape(1, hidden), *occ(0), qtype)
        if use_cross:
            cq = _qdot(layer_norm(x, nm[2], nm[3]), *occ(1), qtype)
            ca = decode_attention_plain(cq.reshape(n_heads, d), mega.cross_k[l],
                                        mega.cross_v[l], mega.cross_k.shape[2])
            x = x + _qdot(ca.reshape(1, hidden), *occ(2), qtype)
        up = _qdot(layer_norm(x, nm[4], nm[5]), *projection_rows(
            mega.fc1_codes[l], mega.fc1_scales[l]), qtype)
        up = torch.nn.functional.gelu(up, approximate="tanh")
        x = x + _qdot(up, *projection_rows(mega.fc2_codes[l], mega.fc2_scales[l]),
                      qtype)
        k_new.append(k)
        v_new.append(v)
    return x, torch.stack(k_new), torch.stack(v_new)


def parler_megastep_batched_plain(mega: MegaLayers, x, kv_k, kv_v, pos, *,
                                  qtype: int, use_cross: bool, n_heads: int):
    """K5's plain PyTorch version: `parler_megastep_plain` per slot, as the
    JAX package's `parler_megastep_batched_reference` (its spec) loops over
    the single-slot reference. x (B, H); kv_k/kv_v (L, B, heads, CTX, D),
    each slot written in place at its row pos[s]; pos (B,). Returns
    (x_out (B, H), k_new (L, B, H), v_new (L, B, H))."""
    p = torch.as_tensor(pos).reshape(-1)
    outs = [parler_megastep_plain(mega, x[s:s + 1], kv_k[:, s], kv_v[:, s],
                                  p[s], qtype=qtype, use_cross=use_cross,
                                  n_heads=n_heads)
            for s in range(x.shape[0])]
    return (torch.cat([o[0] for o in outs]), torch.stack([o[1] for o in outs], 1),
            torch.stack([o[2] for o in outs], 1))


class StepScratch(NamedTuple):
    """Buffers one step on the card reuses layer after layer; a caller that
    steps often (the batched engine) allocates them once."""

    attn: torch.Tensor   # (B, heads, D) self-/cross-attention output
    cq: torch.Tensor     # (B, H) cross-attention query
    up: torch.Tensor     # (B, F) GELU(fc1) output
    part: tuple          # the attention kernel's partial states


def step_scratch(mega: MegaLayers, b: int, n_heads: int, ctx: int,
                 device) -> StepScratch:
    _, hidden, ffn = mega_dims(mega)
    d = hidden // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return StepScratch(
        attn=torch.empty((b, n_heads, d), **f32),
        cq=torch.empty((b, hidden), **f32), up=torch.empty((b, ffn), **f32),
        part=da.attention_scratch(b, n_heads, max(ctx, mega.cross_k.shape[2]),
                                  d, device))


def _megastep_cuda(gemv_kernel, attn_kernel, mega: MegaLayers, x, kv_k, kv_v,
                   pos, *, qtype: int, use_cross: bool, n_heads: int,
                   scratch: StepScratch | None):
    """The step on the card for B <= 16 rows: x (B, H), kv_k/kv_v
    (L, B, heads, CTX, D) (each slot's cache dense, the layer axis at any
    stride: a group of a larger batch's slots), pos (B,) int32. Per layer 6
    GEMV launches through `gemv_kernel` and 2 attention launches through
    `attn_kernel`, on the current stream."""
    dev = x.device
    n_layers, hidden, ffn = mega_dims(mega)
    d, th = hidden // n_heads, hidden // TILE_ROWS
    b, ctx = x.shape[0], kv_k.shape[3]
    _build.require(kv_k, "kv_k", device=dev,
                   dtypes=(torch.bfloat16, torch.float32), ndim=5, outer=1)
    _build.require(kv_v, "kv_v", device=dev, dtypes=(kv_k.dtype,), ndim=5,
                   outer=1)
    _build.require(pos, "pos", device=dev, dtypes=(torch.int32,), align=4)
    require_mega(mega, dev)
    if (kv_k.shape != (n_layers, b, n_heads, ctx, d) or kv_v.shape != kv_k.shape
            or x.shape != (b, hidden) or pos.numel() != b
            or not 0 < b <= MAX_BATCH):
        raise ValueError(f"parler_megastep: x {tuple(x.shape)}, "
                         f"kv {tuple(kv_k.shape)}, pos {tuple(pos.shape)}, "
                         f"L={n_layers} H={hidden}, at most {MAX_BATCH} rows")
    sc = scratch or step_scratch(mega, b, n_heads, ctx, dev)
    packed = int(tiles_packed(mega.qkv_codes))
    cache_bf16 = int(kv_k.dtype == torch.bfloat16)
    kv_bstride = n_heads * ctx * d
    stream = _build.stream_ptr(dev)
    xw = x.float().clone()
    qkv = torch.empty((n_layers, b, 3 * hidden), dtype=torch.float32, device=dev)
    nm, vp = mega.norms, ctypes.c_void_p
    null = vp(0)
    pos_p = vp(pos.data_ptr())

    def gemv(xin, ln, codes_addr, scales_addr, n, k, res, out, epi,
             kc=null, vc=null, lnw=null, lnb=null):
        gemv_kernel(xin, lnw, lnb, ln, vp(codes_addr), vp(scales_addr), qtype,
                    packed, b, n, k, res, out, epi, kc, vc, pos_p, hidden, d,
                    ctx, cache_bf16, kv_bstride, stream)

    def attend(q, kk, vv, p):
        da._launch(attn_kernel, q, kk, vv, p, None, sc.attn, sc.part)

    x_p, attn_p = vp(xw.data_ptr()), vp(sc.attn.data_ptr())
    for l in range(n_layers):
        q_out = qkv[l]
        gemv(x_p, 1, addr(mega.qkv_codes, l), addr(mega.qkv_scales, l),
             3 * hidden, hidden, null, vp(q_out.data_ptr()), EPI_QKV,
             kc=vp(addr(kv_k, l)), vc=vp(addr(kv_v, l)),
             lnw=vp(addr(nm, l, 0)), lnb=vp(addr(nm, l, 1)))
        attend(q_out[:, :hidden].unflatten(1, (n_heads, d)), kv_k[l], kv_v[l],
               pos)
        occ_c, occ_s = mega.occ_codes, mega.occ_scales   # o, cq, co: th tiles each
        gemv(attn_p, 0, addr(occ_c, l), addr(occ_s, l), hidden, hidden, x_p,
             x_p, EPI_RESIDUAL)
        if use_cross:
            gemv(x_p, 1, addr(occ_c, l, th), addr(occ_s, l, th), hidden,
                 hidden, null, vp(sc.cq.data_ptr()), EPI_STORE,
                 lnw=vp(addr(nm, l, 2)), lnb=vp(addr(nm, l, 3)))
            attend(sc.cq.view(b, n_heads, d), mega.cross_k[l], mega.cross_v[l],
                   mega.cross_pos)
            gemv(attn_p, 0, addr(occ_c, l, 2 * th), addr(occ_s, l, 2 * th),
                 hidden, hidden, x_p, x_p, EPI_RESIDUAL)
        gemv(x_p, 1, addr(mega.fc1_codes, l), addr(mega.fc1_scales, l),
             ffn, hidden, null, vp(sc.up.data_ptr()), EPI_GELU,
             lnw=vp(addr(nm, l, 4)), lnb=vp(addr(nm, l, 5)))
        gemv(vp(sc.up.data_ptr()), 0, addr(mega.fc2_codes, l),
             addr(mega.fc2_scales, l), hidden, ffn, x_p, x_p, EPI_RESIDUAL)
    return xw, qkv[:, :, hidden:2 * hidden], qkv[:, :, 2 * hidden:]


def parler_megastep_cuda(mega: MegaLayers, x, kv_k, kv_v, pos, *,
                         qtype: int, use_cross: bool, n_heads: int):
    """K2 on the card: 6 GEMV launches and 2 K3 launches per layer on the
    current stream. Same contract as `parler_megastep_plain`, with pos a
    one-element int32 CUDA tensor."""
    if x.numel() != mega_dims(mega)[1] or kv_k.dim() != 4:
        raise ValueError(f"parler_megastep: x {tuple(x.shape)}, "
                         f"kv {tuple(kv_k.shape)}")
    xo, kn, vn = _megastep_cuda(
        KERNEL, da.KERNEL, mega, x.reshape(1, -1), kv_k.unsqueeze(1),
        kv_v.unsqueeze(1), pos, qtype=qtype, use_cross=use_cross,
        n_heads=n_heads, scratch=None)
    return xo, kn[:, 0], vn[:, 0]


def parler_megastep(mega: MegaLayers, x, kv_k, kv_v, pos, *, qtype: int,
                    use_cross: bool, n_heads: int):
    """Dispatch: the kernels for CUDA tensors, the plain version for CPU
    tensors. See `parler_megastep_plain` for the contract."""
    fn = parler_megastep_plain if x.device.type == "cpu" else parler_megastep_cuda
    return fn(mega, x, kv_k, kv_v, pos, qtype=qtype, use_cross=use_cross,
              n_heads=n_heads)


def parler_megastep_batched_cuda(mega: MegaLayers, x, kv_k, kv_v, pos, *,
                                 qtype: int, use_cross: bool, n_heads: int,
                                 scratch: StepScratch | None = None):
    """K5 on the card: 6 batched GEMV launches and 2 K4 launches per layer
    for each group of at most 16 slots (`_build.slot_groups`), one group
    after another, so any slot count is served; each slot's rows sum as a
    one-row step does, so every slot still equals K2 on its state bit for
    bit. Same contract as `parler_megastep_batched_plain`, with pos a (B,)
    int32 CUDA tensor; `scratch` (step_scratch for B slots) is allocated
    when not given."""
    outs = []
    for g in _build.slot_groups(x.shape[0], MAX_BATCH):
        sc = None if scratch is None else scratch._replace(
            attn=scratch.attn[g], cq=scratch.cq[g], up=scratch.up[g])
        outs.append(_megastep_cuda(
            KERNEL_BATCHED, da.KERNEL_BATCHED, mega, x[g], kv_k[:, g],
            kv_v[:, g], pos[g], qtype=qtype, use_cross=use_cross,
            n_heads=n_heads, scratch=sc))
    return _build.cat_groups(outs)


def parler_megastep_batched(mega: MegaLayers, x, kv_k, kv_v, pos, *,
                            qtype: int, use_cross: bool, n_heads: int,
                            scratch: StepScratch | None = None):
    """Dispatch: K5 for CUDA tensors, the plain version for CPU tensors (which
    ignores `scratch`). See `parler_megastep_batched_plain`."""
    kw = dict(qtype=qtype, use_cross=use_cross, n_heads=n_heads)
    if x.device.type == "cpu":
        return parler_megastep_batched_plain(mega, x, kv_k, kv_v, pos, **kw)
    return parler_megastep_batched_cuda(mega, x, kv_k, kv_v, pos,
                                        scratch=scratch, **kw)
