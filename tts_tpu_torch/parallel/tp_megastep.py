"""Tensor parallelism for the quantized Parler decode step, the port of the
JAX package's `parallel/tp_megastep.py`.

Two layouts, both on block-quantized weights end to end:

1. Megatron TP (`megastep_tp`): qkv / cross-q / fc1 column-sharded by
   attention heads, o / cross-o / fc2 row-sharded, attention on the rank's
   own heads against its head-sharded KV cache, one all-reduce over the tp
   group after each row-sharded projection (where the JAX package has
   `jax.lax.psum`). Activations replicated. Every projection is one K1
   call on the rank's shard (ops/quant_matmul.quant_matmul, f32 scales:
   K1's exact-f32 mode, as the JAX layout casts its scales to f32); the
   attention is plain torch ops, as it is XLA outside any Pallas kernel in
   the JAX package. The partial sums of a row-sharded product meet in the
   all-reduce, so the step equals tp=1 within f32 rounding, not bit for bit.

2. Weight-gather TP (`megastep_weight_gather`): every rank holds 1/tp of
   each projection's K2 tiles (ops/parler_megastep.MegaLayers, cut on the
   output axis) and of the cross K/V heads; layer l+1's shards are
   all-gathered (async) while layer l runs K2 on the gathered layer. The
   gathered bytes are the unsharded bytes, so the step is bit-equal to K2
   on the unsharded weights (the plain version on CPU tensors). KV cache
   and attention replicate: this mode pairs with dp over batch slots.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.parler_megastep import (MegaLayers, TILE_ROWS, layer_norm,
                                   mega_dims, parler_megastep)
from ..ops.quant_matmul import QuantTensor, quant_matmul
from .distributed import group_rank_size, psum
from .sharding import (check_quant, f32_scales, require_k_shards, split_axis,
                       split_k, split_n)


class TPLayers(NamedTuple):
    """Per-layer quantized weights laid out for Megatron TP (stacked on L;
    f32 scales). Whole, from prep_tp_layers, or one rank's part, from
    shard_tp_layers."""

    qkv: QuantTensor   # (L, 3H, K) rows packed rank-major [q_i | k_i | v_i]
    o: QuantTensor     # (L, H, H) row (K) sharded
    cq: QuantTensor    # (L, H, H) column sharded (by heads)
    co: QuantTensor    # (L, H, H) row sharded
    fc1: QuantTensor   # (L, F, H) column sharded
    fc2: QuantTensor   # (L, H, F) row sharded
    norms: torch.Tensor    # (L, 6, H) replicated
    cross_k: torch.Tensor  # (L, heads, Tc, D) head sharded
    cross_v: torch.Tensor


def prep_tp_layers(layers, tp: int) -> tuple[TPLayers, int]:
    """TPLayers from stacked ParlerLayerWeights with QuantTensor projections
    of one qtype. The qkv rows are packed rank-major, so that a plain cut of
    N in tp parts hands each rank its own [q_i | k_i | v_i]. Q4_0 codes keep
    their nibble pack (sharding.split_k). Refuses a tp whose K shards the
    per-shard matmul cannot take (on the card: multiples of 64)."""
    mats, qtype = check_quant(dict(
        q=layers.q_w, k=layers.k_w, v=layers.v_w, o=layers.o_w,
        cq=layers.cq_w, co=layers.co_w, f1=layers.fc1, f2=layers.fc2),
        "Parler")
    hidden, ffn = mats["o"].shape[0], mats["f1"].shape[0]
    if layers.cross_k.shape[1] % tp:
        raise ValueError(f"tp={tp} must divide heads {layers.cross_k.shape[1]}")
    require_k_shards({"o": (hidden, True), "cross-o": (hidden, True),
                      "fc2": (ffn, True), "qkv": (hidden, False),
                      "fc1": (hidden, False)}, tp, mats["q"].device)
    parts = [split_n(mats[m], i, tp) for i in range(tp) for m in ("q", "k", "v")]
    qkv = QuantTensor(torch.cat([p.codes for p in parts], dim=-2),
                      torch.cat([p.scales for p in parts], dim=-2), parts[0].qtype)
    norms = torch.stack([layers.ln1_w, layers.ln1_b, layers.lnc_w,
                         layers.lnc_b, layers.ln2_w, layers.ln2_b], dim=1)
    f = f32_scales
    return TPLayers(
        qkv=f(qkv), o=f(mats["o"]), cq=f(mats["cq"]), co=f(mats["co"]),
        fc1=f(mats["f1"]), fc2=f(mats["f2"]), norms=norms.float().contiguous(),
        cross_k=layers.cross_k.float().contiguous(),
        cross_v=layers.cross_v.float().contiguous()), qtype


def shard_tp_layers(tpl: TPLayers, i: int, tp: int) -> TPLayers:
    """Rank i's part of TPLayers (of tp ranks)."""
    return TPLayers(
        qkv=split_n(tpl.qkv, i, tp), o=split_k(tpl.o, i, tp),
        cq=split_n(tpl.cq, i, tp), co=split_k(tpl.co, i, tp),
        fc1=split_n(tpl.fc1, i, tp), fc2=split_k(tpl.fc2, i, tp),
        norms=tpl.norms, cross_k=split_axis(tpl.cross_k, 1, i, tp),
        cross_v=split_axis(tpl.cross_v, 1, i, tp))


def gqa_local(q, k, v, kc, vc, pos, scale):
    """GQA attention on a rank's heads, current token folded analytically
    (the JAX package's `_attend_local` / `_gqa_local`): q (R, nh_l, D), k /
    v (R, nkv_l, D) the current rows, kc / vc (R, nkv_l, CTX, D) rows [0,
    pos) attended. Returns (R, nh_l * D) f32. Parler's heads are their own
    groups (nkv_l = nh_l)."""
    r, nkv_l, ctx, d = kc.shape
    g = q.shape[1] // nkv_l
    qs = q.reshape(r, nkv_l, g, d) * scale
    s = torch.einsum("bhgd,bhtd->bhgt", qs, kc.float())
    t = torch.arange(ctx, device=q.device)
    s = s.masked_fill(~(t < pos), float("-inf"))
    s_cur = (qs * k[:, :, None, :]).sum(dim=3, keepdim=True)
    m = torch.maximum(s.amax(dim=3, keepdim=True), s_cur)
    ph, pc = torch.exp(s - m), torch.exp(s_cur - m)
    denom = ph.sum(dim=3, keepdim=True) + pc
    av = torch.einsum("bhgt,bhtd->bhgd", ph, vc.float())
    return ((av + pc * v[:, :, None, :]) / denom).reshape(r, -1)


def _pos(pos, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).reshape(()).long()


@torch.no_grad()
def megastep_tp(tpl: TPLayers, x, kv_k, kv_v, pos, *, group=None,
                use_cross: bool, n_heads: int):
    """Megatron-TP quantized decode step over all L layers on this rank.

    tpl: this rank's shard_tp_layers; group: the tp process group (None:
    the world, or no collective outside one); x (1, H) replicated; kv_k /
    kv_v (L, heads / tp, CTX, D) this rank's heads, read, not written; pos
    an int or one-element tensor. Returns (x_out (1, H) replicated, before
    the final norm, k_new / v_new (L, H / tp): this rank's heads' rows for
    row pos, which the caller writes)."""
    _, tp = group_rank_size(group)
    hidden = x.shape[1]
    hl, d = hidden // tp, hidden // n_heads
    scale = 1.0 / np.sqrt(d)
    p = _pos(pos, x.device)
    xx = x.float()
    k_new, v_new = [], []
    for l in range(tpl.norms.shape[0]):
        nm = tpl.norms[l]
        qkv = quant_matmul(layer_norm(xx, nm[0], nm[1]), tpl.qkv[l])
        q, k_row, v_row = qkv[0, :hl], qkv[0, hl:2 * hl], qkv[0, 2 * hl:]
        attn = gqa_local(*[t.reshape(1, -1, d) for t in (q, k_row, v_row)],
                         kv_k[l][None], kv_v[l][None], p, scale)
        xx = xx + psum(quant_matmul(attn, tpl.o[l]), group)
        if use_cross:
            cq = quant_matmul(layer_norm(xx, nm[2], nm[3]), tpl.cq[l])
            ck, cv = tpl.cross_k[l], tpl.cross_v[l]
            s2 = torch.einsum("hqd,htd->hqt", cq.reshape(-1, 1, d) * scale, ck)
            ca = torch.einsum("hqt,htd->hqd", torch.softmax(s2, dim=-1), cv)
            xx = xx + psum(quant_matmul(ca.reshape(1, hl), tpl.co[l]), group)
        up = torch.nn.functional.gelu(
            quant_matmul(layer_norm(xx, nm[4], nm[5]), tpl.fc1[l]),
            approximate="tanh")
        xx = xx + psum(quant_matmul(up, tpl.fc2[l]), group)
        k_new.append(k_row)
        v_new.append(v_row)
    return xx, torch.stack(k_new), torch.stack(v_new)


# ---------------------------------------------------------------------------
# Weight-gather TP with one-layer-lookahead overlap
# ---------------------------------------------------------------------------

_TILED = ("qkv_codes", "qkv_scales", "occ_codes", "occ_scales", "fc1_codes",
          "fc1_scales", "fc2_codes", "fc2_scales")
_GATHERED = _TILED + ("cross_k", "cross_v")   # each cut on its axis 1


def shard_mega_gather(mega: MegaLayers, i: int, tp: int) -> MegaLayers:
    """Rank i's part of MegaLayers for the gather mode: every projection's
    tiles cut on the output axis (1/tp of the weight bytes), the cross K/V
    on heads; norms and cross_pos whole."""
    _, hidden, ffn = mega_dims(mega)
    for name, n in (("qkv / occ", 3 * hidden), ("fc1", ffn), ("fc2", hidden)):
        if (n // TILE_ROWS) % tp:
            raise ValueError(f"tp={tp}: {name}'s {n // TILE_ROWS} tiles of "
                             f"{TILE_ROWS} rows do not split {tp} ways")
    return mega._replace(**{f: split_axis(getattr(mega, f), 1, i, tp)
                            for f in _GATHERED})


def _gather_layer(shards: MegaLayers, l: int, group, tp: int):
    """Start the all-gathers of layer l's shards, each moved as its bytes
    (any backend takes uint8); returns (works, parts, dtypes)."""
    works, parts, dtypes = [], [], []
    for f in _GATHERED:
        s = getattr(shards, f)[l]
        b = s.view(torch.uint8)
        out = [torch.empty_like(b) for _ in range(tp)]
        works.append(dist.all_gather(out, b, group=group, async_op=True))
        parts.append(out)
        dtypes.append(s.dtype)
    return works, parts, dtypes


def _gathered(pending, norms, cross_pos) -> MegaLayers:
    """Wait for a layer's gathers; the whole layer as a one-layer
    MegaLayers."""
    works, parts, dtypes = pending
    for w in works:
        w.wait()
    full = {f: torch.cat(p, dim=0).view(dt)[None]
            for f, p, dt in zip(_GATHERED, parts, dtypes)}
    return MegaLayers(**full, norms=norms, cross_pos=cross_pos)


@torch.no_grad()
def megastep_weight_gather(shards: MegaLayers, x, kv_k, kv_v, pos, *,
                           group=None, qtype: int, use_cross: bool,
                           n_heads: int):
    """Decode step with layer-ahead all-gather of quantized weight shards.

    shards: this rank's shard_mega_gather; x (1, H); kv_k / kv_v (L, heads,
    CTX, D) the whole cache, written in place at row pos as K2 does; pos a
    one-element int32 tensor (an int on the CPU). Layer l+1's gathers are
    issued before layer l runs (K2 on the card, its plain version on CPU
    tensors), so the collective overlaps the layer's kernels. Returns
    (x_out (1, H), k_new (L, H), v_new (L, H)), all replicated."""
    _, tp = group_rank_size(group)
    n_layers = shards.norms.shape[0]
    if tp == 1:
        return parler_megastep(shards, x, kv_k, kv_v, pos, qtype=qtype,
                               use_cross=use_cross, n_heads=n_heads)
    kw = dict(qtype=qtype, use_cross=use_cross, n_heads=n_heads)
    cur = _gathered(_gather_layer(shards, 0, group, tp), shards.norms[:1],
                    shards.cross_pos)
    ks, vs = [], []
    for l in range(n_layers):
        nxt = (_gather_layer(shards, l + 1, group, tp)
               if l + 1 < n_layers else None)
        x, kn, vn = parler_megastep(cur, x, kv_k[l:l + 1], kv_v[l:l + 1], pos,
                                    **kw)
        ks.append(kn)
        vs.append(vn)
        if nxt is not None:
            cur = _gathered(nxt, shards.norms[l + 1:l + 2], shards.cross_pos)
    return x, torch.cat(ks), torch.cat(vs)
