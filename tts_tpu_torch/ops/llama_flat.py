"""The whole Orpheus decode step, all L layers plus the final RMS norm and
the LM head: kernel K6, and kernel K7 for B batch slots.

Computes the JAX package's `llama_flat_megastep`: K8's layer math
(ops/llama_megastep.py) with every weight scale in bf16, the qkv ones
included, then RMS(out_norm) and the LM head padded to a multiple of 256
rows with zero scales (`QuantTensor.fast_lm_head`), so that the padded
logits are exactly 0. Returns (logits (1, vocab_pad), k_new, v_new); the
caller slices the real vocab.

The TPU kernel streams every weight of the step as one flat sequence of
tiles, with a schedule and a `meta` array that drive Mosaic's sequential
grid; none of that carries over (blocks on the H100 run in no order). On
the card the step is K8's persistent launch (csrc/llama_flat.cu) with one
more phase, the GEMV of the head with the RMS(out_norm) prologue, counted
on K6's own counter. On CPU tensors `llama_flat_megastep_plain` computes
the same in plain PyTorch.
As K8, the step writes the current token's k/v into cache row `pos` in
place before it attends rows [0, pos].

K7 computes `llama_flat_megastep_batched`: K9's layer stack on the
bf16-scale layers (one row per slot: for heads of 64 / 128 one launch of
the batched persistent step, csrc/llama_flat_batched.cu, for each group of
at most R slots, else the launch sequence with K4 for attention), then one
B-row head GEMV launch (csrc/llama_megastep.cu), logits (B, vocab_pad)
with the padded rows exactly 0: 2 launches a step of up to R slots, both on
K7's counter.
Each slot equals K6 on that slot's state bit for bit; like K9 it keeps
K3's f32 softmax where the TPU batched kernel rounds its page dots to bf16
(ops/llama_megastep.py). Plain version: `llama_flat_megastep_batched_plain`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from . import decode_attention as da
from .llama_megastep import (ARGS, EPI_STORE, GEMV_TILE_PAIRS, GEMV_UNIT_K,
                             MAX_BATCH, STEP_ARGS, LlamaMegaLayers,
                             StepScratch, dqdot, gemv_pair_rows, gemv_tile,
                             group_scratch, layers_cuda,
                             llama_megastep_batched_plain,
                             llama_megastep_plain, persistent_batched,
                             persistent_step, takes_persistent_batched,
                             require_tiles, rms_norm, tiles_packed,
                             weight_rows)
from .quant_matmul import QuantTensor

# K6 is one persistent launch a step (the head its last phase); K7 counts its
# layer stack's launches (the batched persistent step's, or the launch
# sequence's GEMVs) and its head GEMV's.
KERNEL = _build.Kernel("llama_flat", "tts_llama_flat", STEP_ARGS)          # K6
KERNEL_BATCHED = _build.Kernel("llama_megastep", "tts_llama_gemv", ARGS)   # K7


class Tiles(NamedTuple):
    """One projection tiled for the GEMV (llama_megastep.gemv_tile), rows
    2p and 2p + 1 paired: codes (T, K/128, ...) and scales (T, K/128, 64)."""

    codes: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> tuple:
        """(N, K): 16 rows a tile, 128 weights a stage."""
        return (self.codes.shape[-3] * 2 * GEMV_TILE_PAIRS,
                self.codes.shape[-2] * GEMV_UNIT_K)


class LlamaFlat(NamedTuple):
    """K6's weights: the layers with bf16 scales everywhere, the padded
    bf16-scale LM head (N = vocab_pad rows), tiled, and the final norm's
    weight."""

    layers: LlamaMegaLayers
    head: Tiles
    out_norm: torch.Tensor   # (H,) f32


def prep_llama_flat(mega: LlamaMegaLayers, head, out_norm, qtype: int,
                    n_heads: int, n_kv: int) -> LlamaFlat:
    """LlamaFlat from K8's layers and the LM head. Raises ValueError when the
    head is not a QuantTensor of the layers' qtype or the GQA group is not
    one the TPU kernel takes (the caller then keeps K8), as the JAX
    package's `prep_llama_flat` does."""
    if not isinstance(head, QuantTensor) or head.qtype != qtype:
        raise ValueError("flat megastep needs a QuantTensor LM head of the "
                         "layer qtype")
    if n_heads // n_kv > 8 or n_heads % n_kv:
        raise ValueError("flat megastep assumes GQA group size <= 8")
    layers = mega._replace(qkv_scales=mega.qkv_scales.to(torch.bfloat16))
    h = head.fast_lm_head()
    tiled = Tiles(*gemv_tile(h.codes, h.scales,
                             *gemv_pair_rows("pairs", h.shape[0] // 2)))
    return LlamaFlat(layers, tiled, out_norm.float().contiguous())


def head_logits(flat: LlamaFlat, xo, qtype: int):
    """The head's `_dqdot` product on RMS(out_norm) of xo (plain)."""
    h = rms_norm(xo, flat.out_norm)
    return dqdot(h, *weight_rows(flat.head.codes, flat.head.scales, "pairs",
                                 flat.head.shape[0]), qtype)


def llama_flat_megastep_plain(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                              qtype: int, n_heads: int, n_kv: int, inv_freq):
    """K6's plain PyTorch version: `llama_megastep_plain` on the bf16-scale
    layers, then the head's `_dqdot` product on RMS(out_norm) of x_out.
    Returns (logits (1, vocab_pad) f32, k_new (L, KV), v_new (L, KV))."""
    xo, kn, vn = llama_megastep_plain(flat.layers, x, kv_k, kv_v, pos,
                                      qtype=qtype, n_heads=n_heads, n_kv=n_kv,
                                      inv_freq=inv_freq)
    return head_logits(flat, xo, qtype), kn, vn


def _require_head(flat: LlamaFlat, dev) -> None:
    head, hidden = flat.head, flat.layers.norms.shape[2]
    require_tiles(head.codes, head.scales, "head", dev, head.shape[0] // 2,
                  hidden, lead=0)
    _build.require(flat.out_norm, "out_norm", device=dev,
                   dtypes=(torch.float32,), ndim=1)
    if head.scales.dtype != torch.bfloat16 or flat.out_norm.numel() != hidden:
        raise ValueError(f"llama_flat_megastep: head {head.shape} "
                         f"({head.scales.dtype} scales), out_norm "
                         f"{tuple(flat.out_norm.shape)}, H={hidden}")


def _head_cuda(kernel, flat: LlamaFlat, xo, qtype: int):
    """One launch of the GEMV for the head: logits (B, vocab_pad) of
    RMS(out_norm) of xo (B, H), on `kernel`'s counter."""
    head, hidden = flat.head, flat.layers.norms.shape[2]
    logits = torch.empty((xo.shape[0], head.shape[0]), dtype=torch.float32,
                         device=xo.device)
    vp, null = _build.ptr, ctypes.c_void_p(0)
    kernel(vp(xo), vp(flat.out_norm), 1, vp(head.codes), vp(head.scales),
           vp(head.codes), vp(head.scales), qtype,
           int(tiles_packed(head.codes)), 1, xo.shape[0], head.shape[0],
           hidden, null, vp(logits), EPI_STORE, null, null, 0, null, null, 0,
           0, 0, 0, 0, 0, _build.stream_ptr(xo.device))
    return logits


def llama_flat_megastep_cuda(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                             qtype: int, n_heads: int, n_kv: int, inv_freq):
    """K6 on the card: one cooperative launch of the persistent step
    (csrc/llama_flat.cu) with the RMS(out_norm) -> head phase last, on the
    current stream, equal to the launch sequence and its head GEMV bit for
    bit. Same contract as `llama_flat_megastep_plain`, with pos a
    one-element int32 CUDA tensor; heads of 64 or 128 (the Orpheus gate
    sends other sizes to K7's launch sequence). Raises where the card
    refuses the launch."""
    _require_head(flat, x.device)
    _, kn, vn, logits = persistent_step(
        KERNEL, flat.layers, x, kv_k, kv_v, pos, qtype=qtype, n_heads=n_heads,
        n_kv=n_kv, inv_freq=inv_freq, head=flat.head, out_norm=flat.out_norm)
    return logits, kn, vn


def llama_flat_megastep(flat: LlamaFlat, x, kv_k, kv_v, pos, *, qtype: int,
                        n_heads: int, n_kv: int, inv_freq):
    """Dispatch: K6 for CUDA tensors, the plain version for CPU tensors. See
    `llama_flat_megastep_plain` for the contract."""
    fn = llama_flat_megastep_plain if x.device.type == "cpu" \
        else llama_flat_megastep_cuda
    return fn(flat, x, kv_k, kv_v, pos, qtype=qtype, n_heads=n_heads,
              n_kv=n_kv, inv_freq=inv_freq)


def llama_flat_megastep_batched_plain(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                                      qtype: int, n_heads: int, n_kv: int,
                                      inv_freq):
    """K7's plain PyTorch version: `llama_megastep_batched_plain` (K8's plain
    version per slot) on the bf16-scale layers, then the head's `_dqdot`
    product on RMS(out_norm) of each slot's x_out. x (B, H); kv_k/kv_v
    (L, B, n_kv, CTX, D), each slot's row pos[s] written in place; pos (B,).
    Returns (logits (B, vocab_pad) f32, k_new (L, B, KV), v_new (L, B, KV))."""
    xo, kn, vn = llama_megastep_batched_plain(
        flat.layers, x, kv_k, kv_v, pos, qtype=qtype, n_heads=n_heads,
        n_kv=n_kv, inv_freq=inv_freq)
    return head_logits(flat, xo, qtype), kn, vn


def llama_flat_megastep_batched_sequence(flat: LlamaFlat, x, kv_k, kv_v, pos,
                                         *, qtype: int, n_heads: int, n_kv: int,
                                         inv_freq,
                                         scratch: StepScratch | None = None):
    """K7's launch sequence: 4 batched GEMV launches and 1 K4 launch per
    layer, then one head GEMV, for each group of at most 16 slots
    (`_build.slot_groups`), one group after another, on the current stream
    and K7's counter: the route for heads of other sizes than 64 / 128, and
    the yardstick the persistent steps equal bit for bit. Same contract as
    `llama_flat_megastep_batched_cuda`."""
    if kv_k.dim() != 5 or kv_k.shape[2] != n_kv:
        raise ValueError(f"llama_flat_megastep_batched: kv "
                         f"{tuple(kv_k.shape)}, n_kv {n_kv}")
    _require_head(flat, x.device)
    x = x.float().contiguous()
    outs = []
    for g in _build.slot_groups(x.shape[0], MAX_BATCH):
        xo, kn, vn = layers_cuda(KERNEL_BATCHED, da.KERNEL_BATCHED, flat.layers,
                                 x[g], kv_k[:, g], kv_v[:, g], pos[g],
                                 qtype=qtype, n_heads=n_heads,
                                 inv_freq=inv_freq,
                                 scratch=group_scratch(scratch, g))
        outs.append((_head_cuda(KERNEL_BATCHED, flat, xo, qtype), kn, vn))
    return _build.cat_groups(outs)


def llama_flat_megastep_batched_cuda(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                                     qtype: int, n_heads: int, n_kv: int,
                                     inv_freq, scratch: StepScratch | None = None):
    """K7 on the card, on the current stream: for heads of 64 / 128 the
    batched persistent step (one launch for each group of at most R slots,
    `llama_megastep.persistent_batched`) and then the head GEMV (one
    launch for each group of at most 16 slots), all on K7's counter; for
    other head sizes the launch sequence
    (`llama_flat_megastep_batched_sequence`, which alone uses `scratch`). The gate is applied before any launch, and a launch the
    card refuses raises. Every slot equals K6 on its state bit for bit.
    Same contract as `llama_flat_megastep_batched_plain`, with pos a (B,)
    int32 CUDA tensor."""
    if kv_k.dim() != 5 or kv_k.shape[2] != n_kv:
        raise ValueError(f"llama_flat_megastep_batched: kv "
                         f"{tuple(kv_k.shape)}, n_kv {n_kv}")
    kw = dict(qtype=qtype, n_heads=n_heads, n_kv=n_kv, inv_freq=inv_freq)
    if not takes_persistent_batched(flat.layers, kv_k.shape[4]):
        return llama_flat_megastep_batched_sequence(flat, x, kv_k, kv_v, pos,
                                                    scratch=scratch, **kw)
    _require_head(flat, x.device)
    xo, kn, vn = persistent_batched(KERNEL_BATCHED, flat.layers,
                                    x.float().contiguous(), kv_k, kv_v, pos,
                                    **kw)
    logits = [_head_cuda(KERNEL_BATCHED, flat, xo[g], qtype)
              for g in _build.slot_groups(xo.shape[0], MAX_BATCH)]
    return (logits[0] if len(logits) == 1 else torch.cat(logits)), kn, vn


def llama_flat_megastep_batched(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                                qtype: int, n_heads: int, n_kv: int, inv_freq,
                                scratch: StepScratch | None = None):
    """Dispatch: K7 for CUDA tensors, the plain version for CPU tensors
    (which ignores `scratch`). See `llama_flat_megastep_batched_plain`."""
    kw = dict(qtype=qtype, n_heads=n_heads, n_kv=n_kv, inv_freq=inv_freq)
    if x.device.type == "cpu":
        return llama_flat_megastep_batched_plain(flat, x, kv_k, kv_v, pos, **kw)
    return llama_flat_megastep_batched_cuda(flat, x, kv_k, kv_v, pos,
                                            scratch=scratch, **kw)
