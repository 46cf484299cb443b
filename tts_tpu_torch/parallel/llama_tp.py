"""Tensor parallelism for the quantized llama (Orpheus-3B) decode step, the
port of the JAX package's `parallel/llama_tp.py`.

Megatron layout over the tp group: qkv column-sharded by head groups (rank
i holds q heads [i*nh_l, (i+1)*nh_l) and kv heads [i*nkv_l, (i+1)*nkv_l),
so GQA groups stay on their rank and attention needs no collective), o and
down row (K) sharded with one all-reduce each, gate / up column-sharded,
the KV cache sharded on the kv-head axis, activations replicated. Each
projection is one K1 call on the rank's shard (f32 scales); RoPE and the
attention are plain torch ops (XLA in the JAX package), RoPE with the
port's llama helpers (ops/llama_megastep._rope).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.llama_megastep import _rope, rms_norm
from ..ops.quant_matmul import QuantTensor, quant_matmul
from .distributed import group_rank_size, psum
from .sharding import (check_quant, f32_scales, require_k_shards, split_k,
                       split_n)
from .tp_megastep import _pos, gqa_local


class LlamaTPLayers(NamedTuple):
    """Stacked per-layer llama weights in Megatron-TP layout (f32 scales).
    Whole, from prep_llama_tp, or one rank's part, from shard_llama_tp."""

    qkv: QuantTensor    # (L, (NH + 2 NKV) D, H) rows rank-major [q_i|k_i|v_i]
    o: QuantTensor      # (L, H, NH D) row (K) sharded
    gate: QuantTensor   # (L, F, H) column sharded
    up: QuantTensor     # (L, F, H) column sharded
    down: QuantTensor   # (L, H, F) row sharded
    norms: torch.Tensor  # (L, 2, H) replicated


def _pack_qkv(q, k, v, tp, nh_l, nkv_l, d) -> QuantTensor:
    """q / k / v rows packed rank-major by head groups."""
    parts = []
    for i in range(tp):
        parts += [QuantTensor(m.codes[..., i * n * d:(i + 1) * n * d, :],
                              m.scales[..., i * n * d:(i + 1) * n * d, :], m.qtype)
                  for m, n in ((q, nh_l), (k, nkv_l), (v, nkv_l))]
    return QuantTensor(torch.cat([p.codes for p in parts], dim=-2),
                       torch.cat([p.scales for p in parts], dim=-2), q.qtype)


def prep_llama_tp(layers, tp: int, *, n_heads: int, n_kv: int,
                  head_d: int) -> tuple[LlamaTPLayers, int]:
    """LlamaTPLayers from a stacked OrpheusLayer with QuantTensor
    projections. Refuses a tp that does not divide the heads, or whose K
    shards of o / down the per-shard matmul cannot take (on the card:
    multiples of 64)."""
    mats, qtype = check_quant(dict(q=layers.q, k=layers.k, v=layers.v,
                                   o=layers.o, gate=layers.gate, up=layers.up,
                                   down=layers.down), "llama")
    if n_heads % tp or n_kv % tp:
        raise ValueError(f"tp={tp} must divide heads {n_heads}/{n_kv}")
    hidden, ffn = mats["o"].shape[0], mats["down"].shape[1]
    require_k_shards({"o": (n_heads * head_d, True), "down": (ffn, True),
                      "qkv": (hidden, False), "gate / up": (hidden, False)},
                     tp, mats["q"].device)
    qkv = _pack_qkv(mats["q"], mats["k"], mats["v"], tp, n_heads // tp,
                    n_kv // tp, head_d)
    f = f32_scales
    return LlamaTPLayers(
        qkv=f(qkv), o=f(mats["o"]), gate=f(mats["gate"]), up=f(mats["up"]),
        down=f(mats["down"]),
        norms=torch.stack([layers.in_norm, layers.post_norm],
                          dim=1).float().contiguous()), qtype


def shard_llama_tp(tpl: LlamaTPLayers, i: int, tp: int) -> LlamaTPLayers:
    """Rank i's part of LlamaTPLayers (of tp ranks)."""
    return LlamaTPLayers(
        qkv=split_n(tpl.qkv, i, tp), o=split_k(tpl.o, i, tp),
        gate=split_n(tpl.gate, i, tp), up=split_n(tpl.up, i, tp),
        down=split_k(tpl.down, i, tp), norms=tpl.norms)


@torch.no_grad()
def llama_megastep_tp(tpl: LlamaTPLayers, x, kv_k, kv_v, pos, inv_freq, *,
                      group=None, n_heads: int, n_kv: int):
    """Megatron-TP quantized llama decode step over all L layers on this
    rank.

    tpl: this rank's shard_llama_tp; group: the tp process group; x (1, H)
    replicated; kv_k / kv_v (L, n_kv / tp, CTX, D) this rank's kv heads,
    read, not written; pos an int or one-element tensor; inv_freq (D/2,)
    (ops/attention.rope_freqs, llama3 factors folded). Returns (x_out (1,
    H) replicated before the final RMS norm, k_new / v_new (L, n_kv / tp *
    D): this rank's kv heads' rows for row pos)."""
    _, tp = group_rank_size(group)
    d = kv_k.shape[-1]
    nh_l, nkv_l = n_heads // tp, n_kv // tp
    p = _pos(pos, x.device)
    ang = p.float() * inv_freq.float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    xx = x.float()
    k_new, v_new = [], []
    for l in range(tpl.norms.shape[0]):
        nm = tpl.norms[l]
        qkv = quant_matmul(rms_norm(xx, nm[0]), tpl.qkv[l])[0]
        q = _rope(qkv[:nh_l * d].reshape(nh_l, d), cos, sin)
        k = _rope(qkv[nh_l * d:(nh_l + nkv_l) * d].reshape(nkv_l, d), cos, sin)
        v = qkv[(nh_l + nkv_l) * d:].reshape(nkv_l, d)
        attn = gqa_local(q[None], k[None], v[None], kv_k[l][None],
                         kv_v[l][None], p, 1.0 / np.sqrt(d))
        xx = xx + psum(quant_matmul(attn, tpl.o[l]), group)
        h = rms_norm(xx, nm[1])
        act = torch.nn.functional.silu(quant_matmul(h, tpl.gate[l])) * \
            quant_matmul(h, tpl.up[l])
        xx = xx + psum(quant_matmul(act, tpl.down[l]), group)
        k_new.append(k.reshape(-1))
        v_new.append(v.reshape(-1))
    return xx, torch.stack(k_new), torch.stack(v_new)
