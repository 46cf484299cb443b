"""Tensor-parallel shards of the decoders' weights and state, the port of
the JAX package's `parallel/sharding.py`.

Megatron-style TP over the mesh's `tp` axis, each rank holding its own
slice (the JAX package annotates one global array instead):
  * q/k/v projections, cross-q and fc1 column-sharded (output features,
    whole heads),
  * o, cross-o and fc2 row-sharded (input features; the layer all-reduces
    their products),
  * the per-layer cross K/V and the KV cache sharded on the head axis,
  * batch slots (and every per-request vector) sharded over `dp`.
Embeddings, norms, positional tables and the 9 stacked LM heads stay whole
on every rank (the JAX package shards the heads too and lets XLA gather
their logits; here every tp rank computes the same logits and samples
alike).

Weights are the port's own: dense (L, out, in) tensors or QuantTensors
(codes (L, N, Kc), scales (L, N, K/32)). A row (K) cut of nibble-packed
Q4_0 codes keeps the pack: ggml's block order stores each 32-weight block
in 16 bytes of its own, so a cut at a block boundary is a byte cut.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.quant_matmul import BIAS, QK, QuantTensor
from .mesh import axis_size

K1_STAGE_K = 64   # K1 takes K a multiple of 64 (ops/quant_matmul.k1_plan)


def _copy(x):
    """A contiguous copy: a shard never shares memory with the whole, whose
    owner may write to it."""
    return x.clone(memory_format=torch.contiguous_format)


def split_n(w, i: int, n: int):
    """Part i of n of a weight's output features (axis -2: QuantTensor
    codes / scales rows, dense (..., out, in) rows), a contiguous copy."""
    if isinstance(w, QuantTensor):
        return QuantTensor(split_n(w.codes, i, n), split_n(w.scales, i, n),
                           w.qtype)
    if w.shape[-2] % n:
        raise ValueError(f"{w.shape[-2]} output features do not split {n} ways")
    step = w.shape[-2] // n
    return _copy(w[..., i * step:(i + 1) * step, :])


def split_k(w, i: int, n: int):
    """Part i of n of a weight's input features (the last axis), cut at
    32-weight quant blocks for a QuantTensor (packed codes keep their
    pack), a contiguous copy."""
    if isinstance(w, QuantTensor):
        k = w.shape[1]
        if k % (n * QK):
            raise ValueError(f"K {k} does not split {n} ways into whole "
                             f"{QK}-weight blocks")
        kc = w.codes.shape[-1] // n
        kb = w.scales.shape[-1] // n
        return QuantTensor(_copy(w.codes[..., i * kc:(i + 1) * kc]),
                           _copy(w.scales[..., i * kb:(i + 1) * kb]), w.qtype)
    step = w.shape[-1] // n
    if w.shape[-1] % n:
        raise ValueError(f"{w.shape[-1]} input features do not split {n} ways")
    return _copy(w[..., i * step:(i + 1) * step])


def split_axis(x, axis: int, i: int, n: int):
    """Part i of n of x along `axis` (heads of a cache or cross K/V, slots
    of a batch), a contiguous copy; None stays None."""
    if x is None:
        return None
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split {n} ways")
    return _copy(x.chunk(n, dim=axis)[i])


def require_k_shards(ks: dict, tp: int, device) -> None:
    """Refuse a tp whose K shards the per-shard matmul cannot take: on the
    card K1 needs each shard's K a multiple of 64, on the CPU the plain
    version whole 32-weight blocks. ks maps each projection's name to its
    full K (row-sharded projections: cut by tp; the others: whole)."""
    step = K1_STAGE_K if torch.device(device).type == "cuda" else QK
    for name, (k, cut) in ks.items():
        shard = k // tp if cut else k
        if (cut and k % tp) or shard % step:
            raise ValueError(
                f"tp={tp}: {name}'s K shard ({k}{f' / {tp}' if cut else ''} = "
                f"{shard}) is not a multiple of {step}"
                + (" (K1's K step)" if step == K1_STAGE_K else ""))


def check_quant(mats: dict, what: str) -> tuple[dict, int]:
    """The TP preps' input rule: every projection a QuantTensor of one
    block qtype (Q4_0 codes packed where their packing differs). Returns
    (mats, qtype)."""
    if not all(isinstance(m, QuantTensor) for m in mats.values()):
        raise ValueError(f"{what} TP needs all projections quantized")
    qtypes = {m.qtype for m in mats.values()}
    if len(qtypes) != 1 or next(iter(qtypes)) not in BIAS:
        raise ValueError(f"{what} TP needs one uniform qtype: {qtypes}")
    if len({m.is_packed for m in mats.values()}) != 1:
        mats = {k: m.pack() for k, m in mats.items()}
    return mats, next(iter(qtypes))


def f32_scales(m: QuantTensor) -> QuantTensor:
    """m with float32 scales: K1's exact-f32 mode, as the JAX TP layouts
    cast their scales to f32."""
    return QuantTensor(m.codes, m.scales.float(), m.qtype)


def _tp(mesh: DeviceMesh):
    return mesh.get_local_rank("tp"), axis_size(mesh, "tp")


def _dp(mesh: DeviceMesh):
    return mesh.get_local_rank("dp"), axis_size(mesh, "dp")


def shard_parler_layers(lw, i: int, n: int):
    """Part i of n of stacked ParlerLayerWeights (see the module
    docstring)."""
    col = lambda w: split_n(w, i, n)          # noqa: E731
    row = lambda w: split_k(w, i, n)          # noqa: E731
    return lw._replace(
        q_w=col(lw.q_w), k_w=col(lw.k_w), v_w=col(lw.v_w), o_w=row(lw.o_w),
        cq_w=col(lw.cq_w), co_w=row(lw.co_w),
        cross_k=split_axis(lw.cross_k, 1, i, n),
        cross_v=split_axis(lw.cross_v, 1, i, n),
        fc1=col(lw.fc1), fc2=row(lw.fc2))


def shard_parler_weights(w, mesh: DeviceMesh):
    """This rank's tp shard of ParlerWeights (heads over tp; everything
    outside the layers whole). Refuses K shards the per-shard matmul cannot
    take (require_k_shards)."""
    i, n = _tp(mesh)
    lw = w.layers
    if isinstance(lw.o_w, QuantTensor):
        require_k_shards({"o": (lw.o_w.shape[1], True),
                          "cross-o": (lw.co_w.shape[1], True),
                          "fc2": (lw.fc2.shape[1], True),
                          "qkv": (lw.q_w.shape[1], False),
                          "fc1": (lw.fc1.shape[1], False)}, n, lw.o_w.device)
    return w._replace(layers=shard_parler_layers(lw, i, n))


def shard_parler_kv(kv_k, kv_v, mesh: DeviceMesh):
    """KV cache (L, heads, ctx, D): this rank's heads."""
    i, n = _tp(mesh)
    return split_axis(kv_k, 1, i, n), split_axis(kv_v, 1, i, n)


def shard_batched_state(st, mesh: DeviceMesh):
    """This rank's part of a BatchedParlerState over the (dp, tp) mesh:
    batch slots over dp (each dp group serves its own requests), KV heads
    over tp, every per-request vector over dp."""
    from ..ops.sampling import BatchedSamplerState
    ti, tn = _tp(mesh)
    di, dn = _dp(mesh)

    def slots(x, axis=0):
        return split_axis(x, axis, di, dn)

    def kv(x):
        return split_axis(slots(x, 1), 2, ti, tn)

    return st._replace(
        kv_k=kv(st.kv_k), kv_v=kv(st.kv_v), pos=slots(st.pos),
        step=slots(st.step), tokens_in=slots(st.tokens_in),
        eos_seen=slots(st.eos_seen), active=slots(st.active),
        out_tokens=slots(st.out_tokens),
        sampler_state=BatchedSamplerState(*[slots(t) for t in st.sampler_state]),
        do_sample=slots(st.do_sample), temperature=slots(st.temperature),
        top_k=slots(st.top_k), top_p=slots(st.top_p),
        repetition_penalty=slots(st.repetition_penalty))
