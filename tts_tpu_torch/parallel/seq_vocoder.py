"""Sequence-parallel vocoder decode — a conv halo exchange over a mesh
axis, the port of the JAX package's `parallel/seq_vocoder.py`.

The frame axis is cut over the axis' ranks, and each rank decodes its block
against a halo of neighbour frames covering the decoder's receptive field.
Exact by construction: rank i decodes the clamped window
    [i*Tl - m, i*Tl + Tl + m)  (clamped to [0, T_padded])
assembled from its own block and both neighbours' (an all-gather of the
blocks stands where the JAX package's `ppermute` stands: it takes CUDA
tensors on NCCL and on gloo alike), then keeps only its own Tl frames of
output. Every kept sample's receptive field lies inside the window, the
edge windows are flush with the global edges, and `valid` masks the global
tail's padding (models/codec/dac.dac_decode), so the result equals the
unsharded decode up to the convolutions' own algorithm choice for another
length (bit for bit on the CPU). The waveform is gathered on every rank.
It takes a `DACRunner`'s weights as they are: bf16 convolution weights
(TTS_TPU_DAC_DTYPE=bfloat16, `bf16_conv_weights`) run in bf16 here too.

Margin: the DAC decoder's receptive field in input frames is ~3 (in conv)
+ sum_l 39 / prod(strides[:l+1]) + ~1 a layer; 16 covers the real 512x
model (strides 8, 8, 4, 2) with slack.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.codec.dac import DACConfig, DACWeights, dac_decode
from .mesh import axis_size


@torch.no_grad()
def sharded_dac_decode(cfg: DACConfig, w: DACWeights, codes: torch.Tensor,
                       mesh: DeviceMesh, axis: str = "sp",
                       margin: int = 16) -> torch.Tensor:
    """codes (T, n_heads) integer, the same on every rank of the axis ->
    waveform (T * up,) on every rank, the frames decoded 1/n a rank."""
    n = axis_size(mesh, axis)
    if n == 1:
        return dac_decode(cfg, w, codes)
    group, i = mesh.get_group(axis), mesh.get_local_rank(axis)
    t, h = codes.shape
    up = cfg.up_sampling_factor
    tl = max(-(-t // n), 2 * margin)    # window arithmetic needs Tl >= 2m
    t_pad = tl * n
    codes_p = torch.nn.functional.pad(codes, (0, 0, 0, t_pad - t))
    blocks = [torch.empty((tl, h), dtype=codes.dtype, device=codes.device)
              for _ in range(n)]
    dist.all_gather(blocks, codes_p[i * tl:(i + 1) * tl].contiguous(),
                    group=group)
    zero = torch.zeros_like(blocks[0])
    ctx3 = torch.cat([blocks[i - 1] if i > 0 else zero, blocks[i],
                      blocks[i + 1] if i < n - 1 else zero])     # (3 Tl, H)
    win = tl + 2 * margin
    start = min(max(i * tl - margin, 0), t_pad - win)
    off = tl + (start - i * tl)          # the window's start within ctx3
    valid = min(max(t - start, 0), win)
    wav = dac_decode(cfg, w, ctx3[off:off + win], valid=valid)    # (win * up,)
    keep = (i * tl - start) * up
    own = wav[keep:keep + tl * up].contiguous()
    outs = [torch.empty_like(own) for _ in range(n)]
    dist.all_gather(outs, own, group=group)
    return torch.cat(outs)[:t * up]
