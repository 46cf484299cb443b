"""Megatron tensor parallelism for the quantized Dia CFG decode step, the
port of the JAX package's `parallel/dia_tp.py`.

Layout over the tp group: self-attention qkv column-sharded by GQA head
groups (each rank's 16/tp query heads attend its own 4/tp kv heads — no
attention collective), cross-attention q column-sharded by heads against
the request's head-sharded cross K/V (with the pad-tail fold of
ops/dia_megastep.prep_dia_cross), o / cross-o / wo row-sharded with one
all-reduce each, gate / up column-sharded. The CFG pair rides as two
activation rows (K1 at M = 2), replicated across ranks. KV cache sharded on
the kv-head axis. tp must divide the 4 kv heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.dia_megastep import cross_attention_plain, inv_freq
from ..ops.llama_megastep import _rope, rms_norm
from ..ops.quant_matmul import QuantTensor, quant_matmul
from .distributed import group_rank_size, psum
from .llama_tp import _pack_qkv
from .sharding import (check_quant, f32_scales, require_k_shards, split_axis,
                       split_k, split_n)
from .tp_megastep import _pos, gqa_local


class DiaTPLayers(NamedTuple):
    """Stacked Dia decoder weights in Megatron-TP layout (f32 scales)."""

    qkv: QuantTensor    # (L, (NH + 2 NKV) D, H) rows rank-major [q_i|k_i|v_i]
    o: QuantTensor      # (L, H, NH D) row sharded (self_o)
    cq: QuantTensor     # (L, NH D, H) column sharded by heads (cross_q)
    co: QuantTensor     # (L, H, NH D) row sharded (cross_o)
    gate: QuantTensor   # (L, F, H) column sharded
    up: QuantTensor     # (L, F, H) column sharded
    wo: QuantTensor     # (L, H, F) row sharded
    norms: torch.Tensor  # (L, 3, H) replicated


def prep_dia_tp(layers, tp: int, *, n_heads: int, n_kv: int,
                head_d: int) -> tuple[DiaTPLayers, int]:
    """DiaTPLayers from a stacked DiaDecoderLayer with QuantTensor
    projections (its cross_k / cross_v projections are encode-time only and
    stay out). Refuses a tp that does not divide the heads, or whose K
    shards the per-shard matmul cannot take."""
    mats, qtype = check_quant(dict(
        q=layers.self_q, k=layers.self_k, v=layers.self_v, o=layers.self_o,
        cq=layers.cross_q, co=layers.cross_o, gate=layers.gate, up=layers.up,
        wo=layers.wo), "dia")
    if n_heads % tp or n_kv % tp:
        raise ValueError(f"tp={tp} must divide heads {n_heads}/{n_kv}")
    hidden, ffn = mats["o"].shape[0], mats["wo"].shape[1]
    qh = n_heads * head_d
    require_k_shards({"o": (qh, True), "cross-o": (qh, True),
                      "wo": (ffn, True), "qkv": (hidden, False),
                      "cross-q": (hidden, False), "gate / up": (hidden, False)},
                     tp, mats["q"].device)
    qkv = _pack_qkv(mats["q"], mats["k"], mats["v"], tp, n_heads // tp,
                    n_kv // tp, head_d)
    f = f32_scales
    return DiaTPLayers(
        qkv=f(qkv), o=f(mats["o"]), cq=f(mats["cq"]), co=f(mats["co"]),
        gate=f(mats["gate"]), up=f(mats["up"]), wo=f(mats["wo"]),
        norms=torch.stack([layers.sa_norm, layers.ca_norm, layers.mlp_norm],
                          dim=1).float().contiguous()), qtype


def shard_dia_tp(tpl: DiaTPLayers, i: int, tp: int) -> DiaTPLayers:
    """Rank i's part of DiaTPLayers (of tp ranks)."""
    return DiaTPLayers(
        qkv=split_n(tpl.qkv, i, tp), o=split_k(tpl.o, i, tp),
        cq=split_n(tpl.cq, i, tp), co=split_k(tpl.co, i, tp),
        gate=split_n(tpl.gate, i, tp), up=split_n(tpl.up, i, tp),
        wo=split_k(tpl.wo, i, tp), norms=tpl.norms)


def shard_dia_cross(ck, cv, vtail, i: int, tp: int):
    """Rank i's heads of a request's cross arrays from prep_dia_cross ((L,
    2 heads, Sb, D) / (L, 2 heads, D)), the head axis exposed: (L, 2,
    heads / tp, Sb, D) and (L, 2, heads / tp, D)."""
    l, bh, sb, d = ck.shape
    h = bh // 2
    return (split_axis(ck.reshape(l, 2, h, sb, d), 2, i, tp),
            split_axis(cv.reshape(l, 2, h, sb, d), 2, i, tp),
            split_axis(vtail.reshape(l, 2, h, d), 2, i, tp))


@torch.no_grad()
def dia_megastep_tp(tpl: DiaTPLayers, x, kv_k, kv_v, pos, ck, cv, vtail,
                    n_tail: int, *, group=None, n_heads: int, n_kv: int):
    """Megatron-TP quantized Dia CFG decode step over all L layers on this
    rank.

    x (2, H) replicated (cond, uncond rows); kv_k / kv_v (L, 2, n_kv / tp,
    CTX, D) this rank's kv heads, read, not written; ck / cv (L, 2, heads /
    tp, Sb, D) and vtail (L, 2, heads / tp, D) from shard_dia_cross.
    Returns (x_out (2, H) replicated before the final norm, k_new / v_new
    (L, 2, n_kv / tp * D): this rank's kv heads' rows for row pos)."""
    _, tp = group_rank_size(group)
    d = kv_k.shape[-1]
    nh_l, nkv_l = n_heads // tp, n_kv // tp
    p = _pos(pos, x.device)
    ang = p.float() * inv_freq(d, x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rope(y, nh):                                    # (2, nh * D)
        return torch.stack([_rope(y[r].reshape(nh, d), cos, sin)
                            for r in range(2)])

    xx = x.float()
    k_new, v_new = [], []
    for l in range(tpl.norms.shape[0]):
        nm = tpl.norms[l]
        qkv = quant_matmul(rms_norm(xx, nm[0]), tpl.qkv[l])   # (2, ...)
        q = rope(qkv[:, :nh_l * d], nh_l)
        k = rope(qkv[:, nh_l * d:(nh_l + nkv_l) * d], nkv_l)
        v = qkv[:, (nh_l + nkv_l) * d:].reshape(2, nkv_l, d)
        attn = gqa_local(q, k, v, kv_k[l], kv_v[l], p, 1.0)
        xx = xx + psum(quant_matmul(attn, tpl.o[l]), group)
        cq = rope(quant_matmul(rms_norm(xx, nm[1]), tpl.cq[l]), nh_l)
        ca = cross_attention_plain(cq, ck[l], cv[l], vtail[l], n_tail)
        xx = xx + psum(quant_matmul(ca.reshape(2, nh_l * d), tpl.co[l]), group)
        h = rms_norm(xx, nm[2])
        act = torch.nn.functional.silu(quant_matmul(h, tpl.gate[l])) * \
            quant_matmul(h, tpl.up[l])
        xx = xx + psum(quant_matmul(act, tpl.wo[l]), group)
        k_new.append(k.reshape(2, -1))
        v_new.append(v.reshape(2, -1))
    return xx, torch.stack(k_new), torch.stack(v_new)
