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
the card the step is K8's launch sequence (`llama_megastep.layers_cuda`)
counted on K6's own counter, plus one more launch of the same GEMV for the
head with the RMS(out_norm) prologue (csrc/llama_megastep.cu). On CPU
tensors `llama_flat_megastep_plain` computes the same in plain PyTorch.
As K8, the step writes the current token's k/v into cache row `pos` in
place before it attends rows [0, pos].

K7 computes `llama_flat_megastep_batched`: K9's batched layer sequence
(one row per slot, K4 for attention) on the bf16-scale layers, then one
B-row head GEMV, logits (B, vocab_pad) with the padded rows exactly 0.
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
from .llama_megastep import (ARGS, EPI_STORE, MAX_BATCH, LlamaMegaLayers,
                             StepScratch, dqdot, group_scratch, layers_cuda,
                             llama_megastep_batched_plain,
                             llama_megastep_plain, rms_norm)
from .quant_matmul import QuantTensor

KERNEL = _build.Kernel("llama_megastep", "tts_llama_gemv", ARGS)           # K6
KERNEL_BATCHED = _build.Kernel("llama_megastep", "tts_llama_gemv", ARGS)   # K7


class LlamaFlat(NamedTuple):
    """K6's weights: the layers with bf16 scales everywhere, the padded
    bf16-scale LM head (N = vocab_pad rows) and the final norm's weight."""

    layers: LlamaMegaLayers
    head: QuantTensor
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
    return LlamaFlat(layers, head.fast_lm_head(), out_norm.float().contiguous())


def llama_flat_megastep_plain(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                              qtype: int, n_heads: int, n_kv: int, inv_freq):
    """K6's plain PyTorch version: `llama_megastep_plain` on the bf16-scale
    layers, then the head's `_dqdot` product on RMS(out_norm) of x_out.
    Returns (logits (1, vocab_pad) f32, k_new (L, KV), v_new (L, KV))."""
    xo, kn, vn = llama_megastep_plain(flat.layers, x, kv_k, kv_v, pos,
                                      qtype=qtype, n_heads=n_heads, n_kv=n_kv,
                                      inv_freq=inv_freq)
    h = rms_norm(xo, flat.out_norm)
    return dqdot(h, flat.head.codes, flat.head.scales, qtype), kn, vn


def _require_head(flat: LlamaFlat, dev) -> None:
    head, hidden = flat.head, flat.layers.norms.shape[2]
    _build.require(head.codes, "head codes", device=dev,
                   dtypes=(torch.uint8, torch.int8), ndim=2)
    _build.require(head.scales, "head scales", device=dev,
                   dtypes=(torch.bfloat16,), ndim=2, align=2)
    _build.require(flat.out_norm, "out_norm", device=dev,
                   dtypes=(torch.float32,), ndim=1)
    if head.shape[1] != hidden or head.shape[0] % 2 or \
            flat.out_norm.numel() != hidden:
        raise ValueError(f"llama_flat_megastep: head {head.shape}, "
                         f"out_norm {tuple(flat.out_norm.shape)}, H={hidden}")


def _head_cuda(kernel, flat: LlamaFlat, xo, qtype: int):
    """One launch of the GEMV for the head: logits (B, vocab_pad) of
    RMS(out_norm) of xo (B, H), on `kernel`'s counter."""
    head, hidden = flat.head, flat.layers.norms.shape[2]
    logits = torch.empty((xo.shape[0], head.shape[0]), dtype=torch.float32,
                         device=xo.device)
    vp, null = _build.ptr, ctypes.c_void_p(0)
    kernel(vp(xo), vp(flat.out_norm), 1, vp(head.codes), vp(head.scales),
           vp(head.codes), vp(head.scales), qtype, int(head.is_packed), 1,
           xo.shape[0], head.shape[0], hidden, null, vp(logits), EPI_STORE,
           null, null, 0, null, null, 0, 0, 0, 0, 0, 0,
           _build.stream_ptr(xo.device))
    return logits


def llama_flat_megastep_cuda(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                             qtype: int, n_heads: int, n_kv: int, inv_freq):
    """K6 on the card: 4 GEMV launches and 1 K3 launch per layer, then the
    head GEMV, on the current stream. Same contract as
    `llama_flat_megastep_plain`, with pos a one-element int32 CUDA tensor."""
    if kv_k.dim() != 4 or kv_k.shape[1] != n_kv:
        raise ValueError(f"llama_flat_megastep: kv {tuple(kv_k.shape)}, "
                         f"n_kv {n_kv}")
    _require_head(flat, x.device)
    xo, kn, vn = layers_cuda(KERNEL, da.KERNEL, flat.layers,
                             x.float().reshape(1, -1).contiguous(),
                             kv_k.unsqueeze(1), kv_v.unsqueeze(1), pos,
                             qtype=qtype, n_heads=n_heads, inv_freq=inv_freq)
    return _head_cuda(KERNEL, flat, xo, qtype), kn[:, 0], vn[:, 0]


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
    h = rms_norm(xo, flat.out_norm)
    return dqdot(h, flat.head.codes, flat.head.scales, qtype), kn, vn


def llama_flat_megastep_batched_cuda(flat: LlamaFlat, x, kv_k, kv_v, pos, *,
                                     qtype: int, n_heads: int, n_kv: int,
                                     inv_freq, scratch: StepScratch | None = None):
    """K7 on the card: 4 batched GEMV launches and 1 K4 launch per layer,
    then one head GEMV, for each group of at most 16 slots
    (`_build.slot_groups`), one group after another, on the current stream;
    every slot still equals K6 on its state bit for bit. Same contract as
    `llama_flat_megastep_batched_plain`, with pos a (B,) int32 CUDA tensor;
    `scratch` (llama_megastep.step_scratch for B slots) is allocated when
    not given."""
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
