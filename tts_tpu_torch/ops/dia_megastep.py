"""One Dia decode step over all L decoder layers for a CFG pair: kernel K10,
and kernel K11 for B pairs.

Computes the JAX package's `dia_megastep` (reference
`dia_megastep_reference`): the conditional and the unconditional sequence
ride as two rows, and per layer RMS -> qkv -> NeoX RoPE (theta 10000) ->
GQA self-attention at softmax scale 1.0 (Dia does not scale by 1/sqrt(d))
-> o -> RMS -> cross q + RoPE -> cross-attention over the bucketed cross
K/V with the analytic pad-tail fold -> cross o -> RMS -> SiLU(gate) * up
-> down, with block-quantized weights at bf16-rounded dequant and
bf16-rounded activations, f32 sums (`_dqdot` numerics). Returns the
pre-final-norm x and each layer's k_new / v_new; the caller applies the
final norm, the stacked heads and the CFG merge. K11 computes
`dia_megastep_batched` (reference `dia_megastep_batched_reference`, K10's
reference per pair): 2B rows, each pair at its own position with its own
caches and cross K/V.

The cross-attention tail: the reference attends the whole padded encoder
window, whose K rows past the prompt are zero. `prep_dia_cross` keeps the
smallest bucket of rows (128, 256, 512 or 1024) that holds the prompt and
sums the V rows past it into `vtail`; the n_tail rows past the bucket each
give logit 0 and fold in analytically: m = max(m, 0), denom += n_tail
e^{-m}, numer += e^{-m} vtail. With no tail there is no max with 0.

On the card K10 is one cooperative launch of a persistent kernel
(csrc/dia_flat.cu, its header says why; ops/dia_flat.py reckons its plan):
per layer eight phases with a grid barrier after each, the GEMV phases
running the dequant GEMV's device code (csrc/gemv.cuh, the llama steps'
GEMV, with the RMS norm fused before and RoPE + KV-row write, residual add
or SiLU(gate) * up after), the attention phases K4's page and merge code
(csrc/attention.cuh). K11 is a sequence of hand-written kernels on one
stream (csrc/dia_megastep.cu): per layer 6 launches of that GEMV, 1 of K4
for the self-attention (each row over its own cache) and 1 of the
cross-attention (csrc/decode_attention.cu's K4 kernel through its
tts_cross_attention entry, the tail merged as one more partial state).
Both sum every feature in one order, so K10 equals the launch sequence on
its pair bit for bit, and each K11 pair equals K10 on that pair's state.
On CPU tensors `dia_megastep_plain` and `dia_megastep_batched_plain`
compute the same in plain PyTorch.

K11 departs from the TPU batched kernel in one rounding, as K9 does: that
kernel rounds q, K/V and the probabilities to bf16 for its attention
dots; here every pair keeps K10's f32 softmax. Unlike the TPU kernels,
which fold the current token's f32 k/v into the softmax and leave the
cache write to their caller, these steps write k/v into cache row `pos`
IN PLACE first and then attend rows [0, pos], as K8 does: exact in f32;
on a bf16 cache the current row is rounded to bf16 before it is attended
(the plain versions do the same).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from . import decode_attention as da
from . import dia_flat
from ._build import addr
from .attention import rope_freqs
from .decode_attention import decode_attention_plain
from .llama_megastep import (ARGS, EPI_RESIDUAL, EPI_ROPE_QKV, EPI_SILU_MUL,
                             GEMV_TILE_PAIRS, _rope, _write_row, dqdot,
                             gemv_k_ok, gemv_pair_rows, gemv_tile,
                             require_tiles, rms_norm, tiles_packed,
                             weight_rows)
from .quant_matmul import BIAS, QuantTensor

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_CROSS_ARGS = [_vp, _vp, _vp, _vp, ctypes.c_float, _vp, _vp, _vp, _vp, _i32,
               _i32, _i32, _i32, _i32, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_float, _vp]
# K10 is the persistent step; K11's launch sequence counts its GEMV and
# cross-attention launches (its self-attention launches count on K4's).
# CROSS counts the cross-attention entry launched alone
# (`cross_attention_cuda`).
KERNEL = _build.Kernel("dia_flat", "tts_dia_flat", dia_flat.ARGS)                  # K10
KERNEL_BATCHED = _build.Kernel("dia_megastep", "tts_dia_gemv", ARGS)              # K11
CROSS = _build.Kernel("decode_attention", "tts_cross_attention", _CROSS_ARGS)
CROSS_BATCHED = _build.Kernel("decode_attention", "tts_cross_attention", _CROSS_ARGS)  # K11
CROSS_BUCKETS = (128, 256, 512, 1024)
ROPE_THETA = 10000.0
MAX_PAIRS = 8    # pairs one launch takes (2 rows each; the GEMV takes 16,
                 # csrc/dia_megastep.cu); larger batches run in groups


class DiaMegaLayers(NamedTuple):
    """Per-layer decoder weights in the megastep layout (stacked on L).

    Each projection tiled for the GEMV (`llama_megastep.gemv_tile`: (L,
    tiles, K/128, ...) codes and scales), Q4 nibble-packed, every scale
    bfloat16, as the TPU kernel's prep keeps them. qkv = concat(self q, k,
    v) on N, its pairs RoPE's; occ = the tiles of self o, cross q (RoPE's
    pairs) and cross o, H/16 each (which needs n_heads * head_size ==
    hidden); gate_up pairs gate row p with up row p; o, cross o and down
    pair rows 2p, 2p + 1. norms packs (sa, ca, mlp) RMS weights.
    """

    qkv_codes: torch.Tensor       # (L, (QH + 2 KV) / 16, H / 128, 64 Cb)
    qkv_scales: torch.Tensor      # (L, (QH + 2 KV) / 16, H / 128, 64)
    occ_codes: torch.Tensor       # (L, 3 H / 16, H / 128, 64 Cb)
    occ_scales: torch.Tensor
    gate_up_codes: torch.Tensor   # (L, F / 8, H / 128, 64 Cb)
    gate_up_scales: torch.Tensor
    down_codes: torch.Tensor      # (L, H / 16, F / 128, 64 Cb)
    down_scales: torch.Tensor     # (L, H / 16, F / 128, 64)
    norms: torch.Tensor           # (L, 3, H) f32


def prep_dia_mega(layers, head_dim: int) -> tuple[DiaMegaLayers, int]:
    """DiaMegaLayers from a stacked DiaDecoderLayer whose 9 decode
    projections are QuantTensors of one block qtype (cross_k / cross_v run
    only at encode time), heads of `head_dim`. Raises ValueError otherwise,
    or where a width is not one the GEMV takes (the caller then takes the
    per-matmul path)."""
    mats = [layers.self_q, layers.self_k, layers.self_v, layers.self_o,
            layers.cross_q, layers.cross_o, layers.gate, layers.up, layers.wo]
    if not all(isinstance(m, QuantTensor) for m in mats):
        raise ValueError("dia megastep needs all decode projections quantized")
    qtypes = {m.qtype for m in mats}
    if len(qtypes) != 1 or next(iter(qtypes)) not in BIAS:
        raise ValueError(f"dia megastep needs one uniform qtype, got {qtypes}")
    q, k, v, o, cq, co, gate, up, down = [m.pack() for m in mats]
    if o.shape[1] != cq.shape[1]:
        raise ValueError("dia megastep needs n_heads * head_size == hidden")
    hidden, ffn = o.shape[0], gate.shape[0]
    if not (gemv_k_ok(hidden) and gemv_k_ok(ffn) and head_dim % 2 == 0
            and hidden % head_dim == 0):
        raise ValueError(f"dia megastep: H {hidden}, F {ffn}, heads of "
                         f"{head_dim} are not widths the GEMV takes")

    def tile(m, kind, rows_of=None, other=None):
        n = m.shape[0] if rows_of is None else rows_of
        rows = gemv_pair_rows(kind, n if kind == "silu" else n // 2, head_dim)
        sb = None if other is None else other.scales.to(torch.bfloat16)
        return gemv_tile(m.codes, m.scales.to(torch.bfloat16), *rows,
                         codes_b=None if other is None else other.codes,
                         scales_b=sb)

    qkv = QuantTensor(torch.cat([q.codes, k.codes, v.codes], dim=-2),
                      torch.cat([q.scales, k.scales, v.scales], dim=-2),
                      q.qtype)
    qkv_c, qkv_s = tile(qkv, "rope")
    occ = [tile(o, "pairs"), tile(cq, "rope"), tile(co, "pairs")]
    gu_c, gu_s = tile(gate, "silu", other=up)
    d_c, d_s = tile(down, "pairs")
    return DiaMegaLayers(
        qkv_codes=qkv_c, qkv_scales=qkv_s,
        occ_codes=torch.cat([c for c, _ in occ], dim=-3).contiguous(),
        occ_scales=torch.cat([sc for _, sc in occ], dim=-3).contiguous(),
        gate_up_codes=gu_c, gate_up_scales=gu_s, down_codes=d_c, down_scales=d_s,
        norms=torch.stack([layers.sa_norm, layers.ca_norm, layers.mlp_norm],
                          dim=1).float().contiguous()), next(iter(qtypes))


def prep_dia_cross(cross_k, cross_v, sentence_length: int,
                   buckets=CROSS_BUCKETS):
    """Pack a request's cross K/V for the megastep: cross_k / cross_v (L, 2,
    heads, Tc, D) from dia_encode (K rows past the prompt zero). Returns (ck
    bf16 (L, 2 heads, Sb, D), cv likewise, vtail f32 (L, 2 heads, D) = the
    sum of the V rows in [Sb, Tc), n_tail = Tc - Sb), Sb the smallest bucket
    >= sentence_length that fits in Tc, else Tc."""
    l, b2, h, tc, d = cross_k.shape
    sb = next((b for b in buckets if sentence_length <= b <= tc), tc)
    ck = cross_k[:, :, :, :sb].to(torch.bfloat16).reshape(l, b2 * h, sb, d)
    cv = cross_v[:, :, :, :sb].to(torch.bfloat16).reshape(l, b2 * h, sb, d)
    vtail = cross_v[:, :, :, sb:].float().sum(dim=3).reshape(l, b2 * h, d)
    return ck.contiguous(), cv.contiguous(), vtail.contiguous(), tc - sb


_INV: dict = {}


def inv_freq(d: int, device) -> torch.Tensor:
    """RoPE inverse frequencies (d/2,) at theta 10000 on `device`, made once
    per (d, device)."""
    key = (d, str(device))
    if key not in _INV:
        _INV[key] = rope_freqs(d, ROPE_THETA, device=device)
    return _INV[key]


def cross_attention_plain(q, ck, cv, vtail, n_tail: int):
    """The cross-attention's plain PyTorch version, as the JAX reference
    writes it: q (R, H, D); ck / cv (R, H, Sb, D) (every row attended,
    scale 1.0); vtail (R, H, D) folded in with n_tail rows of logit 0 when
    n_tail > 0. Returns (R, H, D) float32."""
    s = torch.einsum("rhd,rhtd->rht", q.float(), ck.float())
    m = s.amax(dim=2, keepdim=True)
    if n_tail:
        m = m.clamp(min=0.0)
    ph = torch.exp(s - m)
    den = ph.sum(dim=2, keepdim=True)
    av = torch.einsum("rht,rhtd->rhd", ph, cv.float())
    if n_tail:
        et = torch.exp(-m)
        den = den + n_tail * et
        av = av + et * vtail.float()
    return av / den


def dia_megastep_plain(mega: DiaMegaLayers, x, kv_k, kv_v, pos, ck, cv,
                       vtail, n_tail: int, *, qtype: int, n_heads: int,
                       n_kv: int):
    """K10's plain PyTorch version. x (2, H) (rows: cond, uncond); kv_k /
    kv_v (L, 2, n_kv, CTX, D), written in place at row pos; pos an int or a
    one-element int tensor; ck / cv (L, 2 heads, Sb, D) and vtail (L, 2
    heads, D) from prep_dia_cross with its n_tail. Returns (x_out (2, H) f32
    before the final norm, k_new (L, 2, KV), v_new (L, 2, KV))."""
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    d = hidden // n_heads
    kvh = n_kv * d
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    t1 = hidden // (2 * GEMV_TILE_PAIRS)   # occ's tiles of each of its three
    ctx, sb = kv_k.shape[3], ck.shape[2]
    p = torch.as_tensor(pos, device=x.device).reshape(1).long()
    ang = p.float() * inv_freq(d, x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    p = p.clamp(max=ctx - 1)
    x = x.float()
    k_new, v_new = [], []
    for l in range(n_layers):
        nm = mega.norms[l]
        qkv = dqdot(rms_norm(x, nm[0]), *weight_rows(
            mega.qkv_codes[l], mega.qkv_scales[l], "rope", hidden + 2 * kvh, d),
            qtype)
        attn, ks, vs = [], [], []
        for r in range(2):
            q = _rope(qkv[r, :hidden].reshape(n_heads, d), cos, sin)
            k = _rope(qkv[r, hidden:hidden + kvh].reshape(n_kv, d), cos,
                      sin).reshape(-1)
            v = qkv[r, hidden + kvh:]
            _write_row(kv_k[l, r], p, k, n_kv)
            _write_row(kv_v[l, r], p, v, n_kv)
            attn.append(decode_attention_plain(q, kv_k[l, r], kv_v[l, r], p,
                                               scale=1.0))
            ks.append(k)
            vs.append(v)
        occ_c, occ_s = mega.occ_codes[l], mega.occ_scales[l]
        o_w, cq_w, co_w = (weight_rows(occ_c[i * t1:(i + 1) * t1],
                                       occ_s[i * t1:(i + 1) * t1], kind,
                                       hidden, d)
                           for i, kind in enumerate(("pairs", "rope", "pairs")))
        x = x + dqdot(torch.stack(attn).reshape(2, hidden), *o_w, qtype)
        cq = dqdot(rms_norm(x, nm[1]), *cq_w, qtype)
        cq = torch.stack([_rope(cq[r].reshape(n_heads, d), cos, sin)
                          for r in range(2)])
        ca = cross_attention_plain(cq, ck[l].reshape(2, n_heads, sb, d),
                                   cv[l].reshape(2, n_heads, sb, d),
                                   vtail[l].reshape(2, n_heads, d), n_tail)
        x = x + dqdot(ca.reshape(2, hidden), *co_w, qtype)
        h = rms_norm(x, nm[2])
        gate, up = weight_rows(mega.gate_up_codes[l], mega.gate_up_scales[l],
                               "silu", ffn)
        act = torch.nn.functional.silu(dqdot(h, *gate, qtype)) * \
            dqdot(h, *up, qtype)
        x = x + dqdot(act, *weight_rows(mega.down_codes[l], mega.down_scales[l],
                                        "pairs", hidden), qtype)
        k_new.append(torch.stack(ks))
        v_new.append(torch.stack(vs))
    return x, torch.stack(k_new), torch.stack(v_new)


def dia_megastep_batched_plain(mega: DiaMegaLayers, x, kv_k, kv_v, pos, ck,
                               cv, vtail, n_tail: int, *, qtype: int,
                               n_heads: int, n_kv: int):
    """K11's plain PyTorch version: `dia_megastep_plain` applied per pair,
    as the JAX package's `dia_megastep_batched_reference` is. x (2B, H)
    (pair s on rows 2s, 2s + 1); kv_k / kv_v (L, B, 2, n_kv, CTX, D), each
    pair's row pos[s] written in place; pos (B,); ck / cv (L, B, 2, heads,
    Sb, D); vtail (L, B, 2, heads, D). Returns (x_out (2B, H), k_new (L, 2B,
    KV), v_new (L, 2B, KV))."""
    p = torch.as_tensor(pos).reshape(-1)
    outs = [dia_megastep_plain(
        mega, x[2 * s:2 * s + 2], kv_k[:, s], kv_v[:, s], p[s],
        ck[:, s].flatten(1, 2), cv[:, s].flatten(1, 2),
        vtail[:, s].flatten(1, 2), n_tail, qtype=qtype, n_heads=n_heads,
        n_kv=n_kv) for s in range(kv_k.shape[1])]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs], 1),
            torch.cat([o[2] for o in outs], 1))


class DiaScratch(NamedTuple):
    """Buffers a step on the card reuses layer after layer; a caller that
    steps often (the batched engine) allocates them once."""

    attn: torch.Tensor   # (R, heads, D) self- and cross-attention output
    cq: torch.Tensor     # (R, heads * D) cross q
    act: torch.Tensor    # (R, F) SiLU(gate) * up
    part: tuple          # the attention kernels' partial states


def step_scratch(mega: DiaMegaLayers, rows: int, n_heads: int, ctx: int,
                 sb: int, device) -> DiaScratch:
    hidden = mega.norms.shape[2]
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    d = hidden // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return DiaScratch(attn=torch.empty((rows, n_heads, d), **f32),
                      cq=torch.empty((rows, hidden), **f32),
                      act=torch.empty((rows, ffn), **f32),
                      part=da.attention_scratch(rows, n_heads, max(ctx, sb), d,
                                                device))


def require_step(mega: DiaMegaLayers, x, kv_k, kv_v, pos, ck, cv, vtail,
                 n_tail: int, *, n_heads: int) -> None:
    """Validate a step's tensors on the card (layers_cuda's contract, up to
    16 rows, heads of any size K4 takes); raise ValueError on what the
    kernels do not take."""
    dev = x.device
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    rows, n_kv, ctx, d = kv_k.shape[1], kv_k.shape[2], kv_k.shape[3], kv_k.shape[4]
    sb = ck.shape[3]
    kvn = hidden + 2 * n_kv * d
    _build.require(x, "x", device=dev, dtypes=(torch.float32,), ndim=2)
    _build.require(kv_k, "kv_k", device=dev,
                   dtypes=(torch.bfloat16, torch.float32), ndim=5, outer=1)
    _build.require(kv_v, "kv_v", device=dev, dtypes=(kv_k.dtype,), ndim=5,
                   outer=1)
    _build.require(ck, "ck", device=dev, dtypes=(torch.bfloat16, torch.float32),
                   ndim=5, outer=1)
    _build.require(cv, "cv", device=dev, dtypes=(ck.dtype,), ndim=5, outer=1)
    _build.require(vtail, "vtail", device=dev, dtypes=(torch.float32,), ndim=4,
                   outer=1)
    _build.require(mega.norms, "norms", device=dev, dtypes=(torch.float32,),
                   ndim=3)
    _build.require(pos, "pos", device=dev, dtypes=(torch.int32,), align=4)
    for name, pairs, k in (("qkv", kvn // 2, hidden), ("occ", 3 * hidden // 2, hidden),
                           ("gate_up", ffn, hidden), ("down", hidden // 2, ffn)):
        require_tiles(getattr(mega, name + "_codes"),
                      getattr(mega, name + "_scales"), name, dev, pairs, k)
        if getattr(mega, name + "_scales").dtype != torch.bfloat16:
            raise ValueError(f"dia_megastep: {name} scales must be bfloat16")
    if (x.shape != (rows, hidden) or hidden != n_heads * d
            or kv_k.shape != (n_layers, rows, n_kv, ctx, d)
            or kv_v.shape != kv_k.shape or hidden % (2 * GEMV_TILE_PAIRS)
            or ck.shape != (n_layers, rows, n_heads, sb, d)
            or cv.shape != ck.shape or vtail.shape != (n_layers, rows, n_heads, d)
            or pos.numel() not in (1, rows) or not 0 < rows <= 2 * MAX_PAIRS
            or n_tail < 0 or not da.head_size_ok(d, kv_k.dtype)):
        raise ValueError(f"dia_megastep: x {tuple(x.shape)}, kv "
                         f"{tuple(kv_k.shape)}, cross {tuple(ck.shape)}, vtail "
                         f"{tuple(vtail.shape)}, qkv rows {kvn}, L={n_layers} "
                         f"H={hidden}, {n_heads} heads, pos {tuple(pos.shape)}, "
                         f"n_tail {n_tail}, at most {2 * MAX_PAIRS} rows")


def layers_cuda(gemv_kernel, cross_kernel, mega: DiaMegaLayers, x, kv_k, kv_v,
                pos, ck, cv, vtail, n_tail: int, *, qtype: int, n_heads: int,
                scratch: DiaScratch | None = None):
    """The L layers on the card for R <= 16 rows: x (R, H) f32; kv_k / kv_v
    (L, R, n_kv, CTX, D); pos int32, one element shared by every row or (R,);
    ck / cv (L, R, heads, Sb, D); vtail (L, R, heads, D) f32, read only when
    n_tail > 0; all on the card. Each row's part of the caches, cross K/V and
    tail is dense and the layer axis may have any stride (a group of a larger
    batch's rows). Per layer 6 GEMV launches through
    `gemv_kernel` (K11's counter), 1 K4 launch for the self-attention and 1
    cross-attention launch through `cross_kernel`, on the current stream. Returns (x_out (R, H), k_new (L, R, KV), v_new
    (L, R, KV))."""
    dev = x.device
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    ffn = mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    rows, n_kv, ctx, d = kv_k.shape[1], kv_k.shape[2], kv_k.shape[3], kv_k.shape[4]
    sb = ck.shape[3]
    kvh = n_kv * d
    kvn = hidden + 2 * kvh
    t1 = hidden // (2 * GEMV_TILE_PAIRS)   # occ's tiles of each of its three
    require_step(mega, x, kv_k, kv_v, pos, ck, cv, vtail, n_tail,
                 n_heads=n_heads)
    sc = scratch or step_scratch(mega, rows, n_heads, ctx, sb, dev)
    n_pages = -(-max(ctx, sb) // da.PAGE)
    if (sc.attn.shape != (rows, n_heads, d) or sc.act.shape != (rows, ffn)
            or sc.part[1].numel() < rows * n_heads * n_pages * d):
        raise ValueError(f"dia_megastep: scratch for {tuple(sc.act.shape)} "
                         f"does not fit {rows} rows over {max(ctx, sb)}")
    packed = int(tiles_packed(mega.qkv_codes))
    cache_bf16 = int(kv_k.dtype == torch.bfloat16)
    stream = _build.stream_ptr(dev)
    vp = ctypes.c_void_p
    null = vp(0)
    inv = inv_freq(d, dev)
    pos_p, inv_p = vp(pos.data_ptr()), vp(inv.data_ptr())
    pos_stride = int(pos.numel() > 1)
    xw = x.clone()
    qkv = torch.empty((n_layers, rows, kvn), dtype=torch.float32, device=dev)
    x_p, attn_p, cq_p, act_p = (vp(t.data_ptr()) for t in
                                (xw, sc.attn, sc.cq, sc.act))
    part_ml, part_acc = (vp(t.data_ptr()) for t in sc.part)
    arrivals = vp(da.arrivals(dev, rows * n_heads).data_ptr())
    tail = n_tail > 0

    def gemv(xin, norm, name, l, tile0, n, k, res, out, epi, *,
             q_feats=hidden, kv_feats=0, kc=null, vc=null):
        codes, scales = getattr(mega, name + "_codes"), getattr(mega, name + "_scales")
        ca, sa = vp(addr(codes, l, tile0)), vp(addr(scales, l, tile0))
        gemv_kernel(xin, norm, int(norm is not null), ca, sa, ca, sa, qtype,
                    packed, 1, rows, n, k, res, out, epi, inv_p, pos_p,
                    pos_stride, kc, vc, q_feats, kv_feats, d, ctx, cache_bf16,
                    n_kv * ctx * d, stream)

    for l in range(n_layers):
        q_out = qkv[l]
        gemv(x_p, vp(addr(mega.norms, l, 0)), "qkv", l, 0, kvn, hidden, null,
             vp(q_out.data_ptr()), EPI_ROPE_QKV, kv_feats=kvh,
             kc=vp(addr(kv_k, l)), vc=vp(addr(kv_v, l)))
        da._launch(da.KERNEL_BATCHED, q_out[:, :hidden].unflatten(1, (n_heads, d)),
                   kv_k[l], kv_v[l], pos, 1.0, sc.attn, sc.part)
        gemv(attn_p, null, "occ", l, 0, hidden, hidden, x_p, x_p, EPI_RESIDUAL)
        gemv(x_p, vp(addr(mega.norms, l, 1)), "occ", l, t1, hidden, hidden,
             null, cq_p, EPI_ROPE_QKV)
        cross_kernel(cq_p, vp(addr(ck, l)), vp(addr(cv, l)),
                     vp(addr(vtail, l)) if tail else null, float(n_tail),
                     attn_p, part_ml, part_acc, arrivals, rows, n_heads, sb, d,
                     int(ck.dtype == torch.bfloat16), hidden, n_heads * sb * d,
                     1.0, stream)
        gemv(attn_p, null, "occ", l, 2 * t1, hidden, hidden, x_p, x_p,
             EPI_RESIDUAL)
        gemv(x_p, vp(addr(mega.norms, l, 2)), "gate_up", l, 0, ffn, hidden, null,
             act_p, EPI_SILU_MUL)
        gemv(act_p, null, "down", l, 0, hidden, ffn, x_p, x_p, EPI_RESIDUAL)
    return xw, qkv[:, :, hidden:hidden + kvh], qkv[:, :, hidden + kvh:]


def dia_megastep_cuda(mega: DiaMegaLayers, x, kv_k, kv_v, pos, ck, cv, vtail,
                      n_tail: int, *, qtype: int, n_heads: int, n_kv: int,
                      scratch: DiaScratch | None = None):
    """K10 on the card: one cooperative launch of the persistent step
    (csrc/dia_flat.cu) on the current stream. Same contract as
    `dia_megastep_plain`, with pos a one-element int32 CUDA tensor and the
    cross K/V in bf16 (prep_dia_cross's); heads of 64 or 128. `scratch`
    (the launch sequence's) is not used: the step keeps its scratch per
    stream (ops/dia_flat.py). Raises where the card refuses the launch."""
    if kv_k.dim() != 5 or kv_k.shape[1:3] != (2, n_kv) or ck.dim() != 4:
        raise ValueError(f"dia_megastep: kv {tuple(kv_k.shape)}, n_kv {n_kv}, "
                         f"cross {tuple(ck.shape)}")
    n_layers, _, sb, d = ck.shape
    ck, cv = (t.view(n_layers, 2, n_heads, sb, d) for t in (ck, cv))
    vtail = vtail.view(n_layers, 2, n_heads, d)
    xw = x.float().contiguous().clone()
    require_step(mega, xw, kv_k, kv_v, pos, ck, cv, vtail, n_tail,
                 n_heads=n_heads)
    hidden, ffn = mega.norms.shape[2], mega.gate_up_codes.shape[1] * GEMV_TILE_PAIRS
    packed = tiles_packed(mega.qkv_codes)
    if (ck.dtype != torch.bfloat16 or pos.numel() != 1
            or d not in da.STEP_HEAD_SIZES or n_heads % n_kv
            or dia_flat.smem_bytes(hidden, ffn, packed) > dia_flat.SMEM_LIMIT):
        raise ValueError(f"dia_megastep: cross K/V {ck.dtype}, pos "
                         f"{tuple(pos.shape)}, heads of {d}, {n_heads} / "
                         f"{n_kv} heads, H {hidden}, F {ffn}: the persistent "
                         f"step takes bf16 cross K/V, one position and heads "
                         f"of 64 or 128")
    qkv = dia_flat.launch(KERNEL, mega, xw, kv_k, kv_v, pos, ck, cv, vtail,
                          n_tail, inv_freq(d, x.device), qtype=qtype,
                          packed=packed, n_heads=n_heads)
    kvh = n_kv * d
    return xw, qkv[:, :, hidden:hidden + kvh], qkv[:, :, hidden + kvh:]


def dia_megastep(mega: DiaMegaLayers, x, kv_k, kv_v, pos, ck, cv, vtail,
                 n_tail: int, *, qtype: int, n_heads: int, n_kv: int):
    """Dispatch: K10 for CUDA tensors, the plain version for CPU tensors. See
    `dia_megastep_plain` for the contract."""
    fn = dia_megastep_plain if x.device.type == "cpu" else dia_megastep_cuda
    return fn(mega, x, kv_k, kv_v, pos, ck, cv, vtail, n_tail, qtype=qtype,
              n_heads=n_heads, n_kv=n_kv)


def dia_megastep_batched_cuda(mega: DiaMegaLayers, x, kv_k, kv_v, pos, ck, cv,
                              vtail, n_tail: int, *, qtype: int, n_heads: int,
                              n_kv: int, scratch: DiaScratch | None = None):
    """K11 on the card: K10's launch sequence on the 2B rows of each group
    of at most 8 pairs (16 rows; `_build.slot_groups`), one group after
    another; every pair still equals K10 on its state bit for bit. Same
    contract as `dia_megastep_batched_plain`, with pos a (B,) int32 CUDA
    tensor; `scratch` (step_scratch for 2B rows) is allocated when not
    given."""
    if kv_k.dim() != 6 or kv_k.shape[2:4] != (2, n_kv) or ck.dim() != 6:
        raise ValueError(f"dia_megastep_batched: kv {tuple(kv_k.shape)}, n_kv "
                         f"{n_kv}, cross {tuple(ck.shape)}")
    # one row per sequence: pair s on rows 2s, 2s + 1 (views, no copies)
    x = x.float().contiguous()
    kk, vv = kv_k.flatten(1, 2), kv_v.flatten(1, 2)
    ck, cv, vt = ck.flatten(1, 2), cv.flatten(1, 2), vtail.flatten(1, 2)
    p2 = pos.repeat_interleave(2)
    outs = []
    for g in _build.slot_groups(kv_k.shape[1], MAX_PAIRS):
        r = slice(2 * g.start, 2 * g.stop)
        sc = None if scratch is None else scratch._replace(
            attn=scratch.attn[r], cq=scratch.cq[r], act=scratch.act[r])
        outs.append(layers_cuda(
            KERNEL_BATCHED, CROSS_BATCHED, mega, x[r], kk[:, r], vv[:, r],
            p2[r], ck[:, r], cv[:, r], vt[:, r], n_tail, qtype=qtype,
            n_heads=n_heads, scratch=sc))
    return _build.cat_groups(outs)


def dia_megastep_batched(mega: DiaMegaLayers, x, kv_k, kv_v, pos, ck, cv,
                         vtail, n_tail: int, *, qtype: int, n_heads: int,
                         n_kv: int, scratch: DiaScratch | None = None):
    """Dispatch: K11 for CUDA tensors, the plain version for CPU tensors
    (which ignores `scratch`). See `dia_megastep_batched_plain`."""
    kw = dict(qtype=qtype, n_heads=n_heads, n_kv=n_kv)
    if x.device.type == "cpu":
        return dia_megastep_batched_plain(mega, x, kv_k, kv_v, pos, ck, cv,
                                          vtail, n_tail, **kw)
    return dia_megastep_batched_cuda(mega, x, kv_k, kv_v, pos, ck, cv, vtail,
                                     n_tail, scratch=scratch, **kw)


def cross_attention_cuda(q, ck, cv, vtail, n_tail: int):
    """The cross-attention kernel alone on the card (the card tests' and
    chip_smoke's entry; it counts on K10's counter): q (R, H, D) f32; ck /
    cv (R, H, Sb, D) bf16 or f32; vtail (R, H, D) f32, read only when
    n_tail > 0. Returns (R, H, D)."""
    dev = q.device
    rows, h, d = q.shape
    sb = ck.shape[2]
    for t, name, dts in ((q, "q", (torch.float32,)),
                         (ck, "ck", (torch.bfloat16, torch.float32)),
                         (cv, "cv", (ck.dtype,)), (vtail, "vtail", (torch.float32,))):
        _build.require(t, name, device=dev, dtypes=dts)
    if (ck.shape != (rows, h, sb, d) or cv.shape != ck.shape
            or vtail.shape != (rows, h, d) or not da.head_size_ok(d, ck.dtype)
            or n_tail < 0):
        raise ValueError(f"cross_attention: q {tuple(q.shape)}, k/v "
                         f"{tuple(ck.shape)}, vtail {tuple(vtail.shape)}")
    out = torch.empty((rows, h, d), dtype=torch.float32, device=dev)
    part_ml, part_acc = da.attention_scratch(rows, h, sb, d, dev)
    CROSS(_build.ptr(q), _build.ptr(ck), _build.ptr(cv),
           _build.ptr(vtail) if n_tail > 0 else ctypes.c_void_p(0),
           float(n_tail), _build.ptr(out), _build.ptr(part_ml),
           _build.ptr(part_acc), _build.ptr(da.arrivals(dev, rows * h)), rows,
           h, sb, d, int(ck.dtype == torch.bfloat16),
           h * d, h * sb * d, 1.0, _build.stream_ptr(dev))
    return out
