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

On the card the step is a sequence of hand-written kernels on one stream
(csrc/llama_megastep.cu, its header says why): per layer 4 launches of the
dequant GEMV, which fuses the RMS norm before it and the RoPE + KV-row
write, SiLU(gate) * up or residual add after it, and 1 launch of the decode
attention (K3 for one row, K4 for B rows, ops/decode_attention.py). K9 is
the same sequence with B rows, one weight read for every slot; each of its
slots equals K8 on that slot's state bit for bit. K6 and K7
(ops/llama_flat.py) run the same layers through `layers_cuda` and add the
LM head. On CPU tensors `llama_megastep_plain` and
`llama_megastep_batched_plain` compute the same in plain PyTorch.

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
ARGS = [_vp, _vp, _i32, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32,
        _vp, _vp, _i32, _vp, _vp, _i32, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
        ctypes.c_longlong, _vp]
# One C entry serves K6-K9; each path counts its own launches.
KERNEL = _build.Kernel("llama_megastep", "tts_llama_gemv", ARGS)           # K8
KERNEL_BATCHED = _build.Kernel("llama_megastep", "tts_llama_gemv", ARGS)   # K9
EPI_STORE, EPI_RESIDUAL, EPI_SILU_MUL, EPI_ROPE_QKV = 0, 1, 2, 3
RMS_EPS = 1e-5
MAX_BATCH = 16   # rows one GEMV launch takes (csrc/llama_megastep.cu MAX_ROWS);
                 # larger batches run in groups
# csrc/gemv.cuh's launch shape: blocks of GEMV_WARPS warps in clusters of
# GEMV_CLUSTER, at most one block per SM, staging B x K bf16 rows in at most
# GEMV_STAGE_LIMIT bytes of shared memory a pass; an RMS prologue holds a
# row in registers up to GEMV_RMS_HELD elements
GEMV_WARPS, GEMV_CLUSTER = 12, 2
GEMV_STAGE_LIMIT = 224 * 1024
GEMV_RMS_HELD = 16 * 256


def gemv_rows_per_pass(b: int, k: int) -> int:
    """The rows a GEMV launch stages at a time (csrc/gemv.cuh
    rows_per_pass): all b when b x k bf16 fit in GEMV_STAGE_LIMIT, else b
    split evenly over the fewest passes that fit; 0 when one row does not."""
    fit = GEMV_STAGE_LIMIT // (2 * k)
    if fit < 1:
        return 0
    passes = -(-b // fit)
    return -(-b // passes)


def gemv_blocks(pairs: int, sms: int) -> int:
    """The blocks of a GEMV launch over `pairs` feature pairs on a card of
    `sms` SMs (csrc/gemv.cuh grid_blocks)."""
    blocks = min(-(-pairs // GEMV_WARPS), sms)
    return -(-blocks // GEMV_CLUSTER) * GEMV_CLUSTER


def gemv_staging_bytes(b: int, n: int, k: int, *, rms: bool, silu: bool,
                       sms: int) -> int:
    """Bytes a GEMV launch reads from L2 to stage its b f32 input rows of k:
    each cluster reads each row once (twice with an RMS prologue over rows
    longer than GEMV_RMS_HELD). n output features; SiLU(gate) * up pairs
    gate row j with up row j (n pairs), the other epilogues rows 2p, 2p+1."""
    clusters = gemv_blocks(n if silu else n // 2, sms) // GEMV_CLUSTER
    reads = 2 if rms and k > GEMV_RMS_HELD else 1
    return clusters * b * k * 4 * reads


class LlamaMegaLayers(NamedTuple):
    """Per-layer weights in the megastep layout (all stacked on L).

    Codes row-major (see ops/quant_matmul.py), Q4 nibble-packed. Scales as
    the TPU kernel's prep keeps them: qkv float32, the others bfloat16 (K6's
    copy, `ops/llama_flat.prep_llama_flat`, has every scale in bfloat16).
    qkv = concat(q, k, v) on N; norms packs (in_norm, post_norm).
    """

    qkv_codes: torch.Tensor    # (L, H + 2 KV, Kc(H))
    qkv_scales: torch.Tensor   # (L, H + 2 KV, H/32)
    o_codes: torch.Tensor      # (L, H, Kc(H))
    o_scales: torch.Tensor
    gate_codes: torch.Tensor   # (L, F, Kc(H))
    gate_scales: torch.Tensor
    up_codes: torch.Tensor     # (L, F, Kc(H))
    up_scales: torch.Tensor
    down_codes: torch.Tensor   # (L, H, Kc(F))
    down_scales: torch.Tensor  # (L, H, F/32)
    norms: torch.Tensor        # (L, 2, H) f32


def prep_llama_mega(layers) -> tuple[LlamaMegaLayers, int]:
    """LlamaMegaLayers from stacked OrpheusLayer weights whose 7 projections
    are QuantTensors of one block qtype. Raises ValueError otherwise (the
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

    def bf16(m):
        return m.scales.to(torch.bfloat16).contiguous()

    mega = LlamaMegaLayers(
        qkv_codes=torch.cat([q.codes, k.codes, v.codes], dim=-2).contiguous(),
        qkv_scales=torch.cat([q.scales, k.scales, v.scales],
                             dim=-2).float().contiguous(),
        o_codes=o.codes.contiguous(), o_scales=bf16(o),
        gate_codes=gate.codes.contiguous(), gate_scales=bf16(gate),
        up_codes=up.codes.contiguous(), up_scales=bf16(up),
        down_codes=down.codes.contiguous(), down_scales=bf16(down),
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
    ctx = kv_k.shape[2]
    p = torch.as_tensor(pos, device=x.device).reshape(1).long()
    ang = p.float() * inv_freq.float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    p = p.clamp(max=ctx - 1)
    x = x.float()
    k_new, v_new = [], []
    for l in range(n_layers):
        nm = mega.norms[l]
        qkv = dqdot(rms_norm(x, nm[0]), mega.qkv_codes[l], mega.qkv_scales[l],
                    qtype)[0]
        q = _rope(qkv[:hidden].reshape(n_heads, d), cos, sin)
        k = _rope(qkv[hidden:hidden + kvh].reshape(n_kv, d), cos, sin).reshape(-1)
        v = qkv[hidden + kvh:]
        _write_row(kv_k[l], p, k, n_kv)
        _write_row(kv_v[l], p, v, n_kv)
        attn = decode_attention_plain(q, kv_k[l], kv_v[l], p)
        x = x + dqdot(attn.reshape(1, hidden), mega.o_codes[l],
                      mega.o_scales[l], qtype)
        h = rms_norm(x, nm[1])
        act = torch.nn.functional.silu(
            dqdot(h, mega.gate_codes[l], mega.gate_scales[l], qtype)) * \
            dqdot(h, mega.up_codes[l], mega.up_scales[l], qtype)
        x = x + dqdot(act, mega.down_codes[l], mega.down_scales[l], qtype)
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


class StepScratch(NamedTuple):
    """Buffers a step on the card reuses layer after layer; a caller that
    steps often (the batched engine) allocates them once."""

    attn: torch.Tensor   # (B, heads, D) attention output
    act: torch.Tensor    # (B, F) SiLU(gate) * up
    part: tuple          # the attention kernel's partial states


def step_scratch(mega: LlamaMegaLayers, b: int, n_heads: int, ctx: int,
                 device) -> StepScratch:
    hidden, ffn = mega.norms.shape[2], mega.gate_codes.shape[1]
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


def layers_cuda(gemv_kernel, attn_kernel, mega: LlamaMegaLayers, x, kv_k,
                kv_v, pos, *, qtype: int, n_heads: int, inv_freq,
                scratch: StepScratch | None = None):
    """The L layers on the card for B <= 16 rows: x (B, H), kv_k/kv_v
    (L, B, n_kv, CTX, D) (each slot's cache dense, the layer axis at any
    stride: a group of a larger batch's slots), pos (B,) int32, inv_freq
    (D/2,) float32, all on the card. Per layer 4 GEMV launches through `gemv_kernel` (K8's, K6's,
    K9's or K7's counter) and 1 attention launch through `attn_kernel` (K3's
    or K4's), on the current stream. `scratch` (step_scratch) is allocated
    when not given. Returns (x_out (B, H), k_new (L, B, KV), v_new
    (L, B, KV))."""
    dev = x.device
    n_layers, hidden = mega.norms.shape[0], mega.norms.shape[2]
    ffn = mega.gate_codes.shape[1]
    kvn = mega.qkv_codes.shape[1]
    b, n_kv, ctx, d = kv_k.shape[1], kv_k.shape[2], kv_k.shape[3], kv_k.shape[4]
    kvh = n_kv * d
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
    for name in ("qkv", "o", "gate", "up", "down"):
        _build.require(getattr(mega, name + "_codes"), name + "_codes",
                       device=dev, dtypes=(torch.uint8, torch.int8), ndim=3)
        _build.require(getattr(mega, name + "_scales"), name + "_scales",
                       device=dev, dtypes=(torch.float32, torch.bfloat16),
                       ndim=3, align=2)
    if (x.shape != (b, hidden) or kv_k.shape != (n_layers, b, n_kv, ctx, d)
            or kv_v.shape != kv_k.shape or kvn != hidden + 2 * kvh
            or hidden != n_heads * d or inv_freq.numel() != d // 2
            or pos.numel() != b or not 0 < b <= MAX_BATCH
            or mega.gate_scales.dtype != mega.up_scales.dtype):
        raise ValueError(f"llama_megastep: x {tuple(x.shape)}, kv "
                         f"{tuple(kv_k.shape)}, qkv rows {kvn}, L={n_layers} "
                         f"H={hidden}, {n_heads} heads, inv_freq "
                         f"{tuple(inv_freq.shape)}, pos {tuple(pos.shape)}, "
                         f"at most {MAX_BATCH} rows")
    sc = scratch or step_scratch(mega, b, n_heads, ctx, dev)
    if sc.attn.shape != (b, n_heads, d) or sc.act.shape != (b, ffn):
        raise ValueError(f"llama_megastep: scratch for {tuple(sc.act.shape)} "
                         f"does not fit {b} rows")
    packed = int(mega.qkv_codes.shape[2] * 2 == hidden)
    cache_bf16 = int(kv_k.dtype == torch.bfloat16)
    kv_bstride = n_kv * ctx * d
    stream = _build.stream_ptr(dev)
    xw = x.clone()
    qkv = torch.empty((n_layers, b, kvn), dtype=torch.float32, device=dev)
    nm, vp = mega.norms, ctypes.c_void_p
    null = vp(0)
    pos_p, inv_p = vp(pos.data_ptr()), vp(inv_freq.data_ptr())
    x_p, attn_p, act_p = (vp(t.data_ptr()) for t in (xw, sc.attn, sc.act))

    def gemv(xin, rms, name, l, n, k, res, out, epi, pair=None, norm=null,
             kc=null, vc=null):
        scales = getattr(mega, name + "_scales")
        ca = vp(addr(getattr(mega, name + "_codes"), l))
        sa = vp(addr(scales, l))
        cb, sb = (ca, sa) if pair is None else (
            vp(addr(getattr(mega, pair + "_codes"), l)),
            vp(addr(getattr(mega, pair + "_scales"), l)))
        gemv_kernel(xin, norm, rms, ca, sa, cb, sb, qtype, packed,
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
        gemv(x_p, 1, "gate", l, ffn, hidden, null, act_p, EPI_SILU_MUL,
             pair="up", norm=vp(addr(nm, l, 1)))
        gemv(act_p, 0, "down", l, hidden, ffn, x_p, x_p, EPI_RESIDUAL)
    return xw, qkv[:, :, hidden:hidden + kvh], qkv[:, :, hidden + kvh:]


def llama_megastep_cuda(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                        qtype: int, n_heads: int, n_kv: int, inv_freq):
    """K8 on the card: 4 GEMV launches and 1 K3 launch per layer on the
    current stream. Same contract as `llama_megastep_plain`, with pos a
    one-element int32 CUDA tensor."""
    if kv_k.dim() != 4 or kv_k.shape[1] != n_kv:
        raise ValueError(f"llama_megastep: kv {tuple(kv_k.shape)}, n_kv {n_kv}")
    xo, kn, vn = layers_cuda(KERNEL, da.KERNEL, mega,
                             x.float().reshape(1, -1).contiguous(),
                             kv_k.unsqueeze(1), kv_v.unsqueeze(1), pos,
                             qtype=qtype, n_heads=n_heads, inv_freq=inv_freq)
    return xo, kn[:, 0], vn[:, 0]


def llama_megastep(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *, qtype: int,
                   n_heads: int, n_kv: int, inv_freq):
    """Dispatch: K8 for CUDA tensors, the plain version for CPU tensors. See
    `llama_megastep_plain` for the contract."""
    fn = llama_megastep_plain if x.device.type == "cpu" else llama_megastep_cuda
    return fn(mega, x, kv_k, kv_v, pos, qtype=qtype, n_heads=n_heads,
              n_kv=n_kv, inv_freq=inv_freq)


def llama_megastep_batched_cuda(mega: LlamaMegaLayers, x, kv_k, kv_v, pos, *,
                                qtype: int, n_heads: int, n_kv: int, inv_freq,
                                scratch: StepScratch | None = None):
    """K9 on the card: 4 batched GEMV launches and 1 K4 launch per layer for
    each group of at most 16 slots (`_build.slot_groups`), one group after
    another, on the current stream; every slot still equals K8 on its state
    bit for bit. Same contract as `llama_megastep_batched_plain`, with pos
    a (B,) int32 CUDA tensor."""
    if kv_k.dim() != 5 or kv_k.shape[2] != n_kv:
        raise ValueError(f"llama_megastep_batched: kv {tuple(kv_k.shape)}, "
                         f"n_kv {n_kv}")
    x = x.float().contiguous()
    return _build.cat_groups([
        layers_cuda(KERNEL_BATCHED, da.KERNEL_BATCHED, mega, x[g], kv_k[:, g],
                    kv_v[:, g], pos[g], qtype=qtype, n_heads=n_heads,
                    inv_freq=inv_freq, scratch=group_scratch(scratch, g))
        for g in _build.slot_groups(x.shape[0], MAX_BATCH)])


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
