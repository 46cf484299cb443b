"""Carry the JAX package's Dia weights across to the port's layouts.

`dia_weights_from_numpy` takes the fields of the JAX package's `DiaWeights`
/ `DiaEncoderLayer` / `DiaDecoderLayer` as numpy arrays — each dense leaf
an array, each QuantTensor a tuple (codes_t, scales_t, qtype) in its
transposed (K, N) device layout, packed or not, with float32 or bfloat16
scales — and returns the port's `DiaWeights`. `dia_mega_from_numpy` does
the same for the JAX package's `DiaMegaLayers` (K10's layout), so both
packages run K10's function on the same weights. The caller does the
JAX-side flattening; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ...common import default_device
from ...ops.dia_megastep import DiaMegaLayers
from ...ops.llama_megastep import gemv_pair_rows, gemv_tile
from ...ops.quant_matmul import QuantTensor
from ..parler.convert import _leaf
from .model import DiaDecoderLayer, DiaEncoderLayer, DiaWeights


def dia_weights_from_numpy(fields: Mapping[str, Any], device=None) -> DiaWeights:
    """fields: every DiaWeights field; fields["enc_layers"] and
    fields["dec_layers"] map every DiaEncoderLayer / DiaDecoderLayer field.
    Leaves as described in the module docstring. The weights land on
    `device` (default cuda, see common.default_device)."""
    device = default_device(device)
    enc = DiaEncoderLayer(**{f: _leaf(fields["enc_layers"][f], device)
                             for f in DiaEncoderLayer._fields})
    dec = DiaDecoderLayer(**{f: _leaf(fields["dec_layers"][f], device)
                             for f in DiaDecoderLayer._fields})
    return DiaWeights(enc_layers=enc, dec_layers=dec, **{
        f: _leaf(fields[f], device) for f in DiaWeights._fields
        if f not in ("enc_layers", "dec_layers")})


def dia_mega_from_numpy(fields: Mapping[str, np.ndarray], qtype: int,
                        head_dim: int, device=None) -> DiaMegaLayers:
    """fields: every field of the JAX package's DiaMegaLayers as numpy:
    `<m>_codes` (L, K or K/2 packed, N) and `<m>_scales` (L, K/32, N) bf16
    for m in qkv, occ, gate, up, down, and norms (L, 3, H), heads of
    `head_dim`; each projection tiled for the GEMV (gemv_tile), occ's self
    o, cross q and cross o apart."""
    device = default_device(device)
    qt = {}
    for m in ("qkv", "occ", "gate", "up", "down"):
        q = QuantTensor.from_transposed(fields[m + "_codes"],
                                        fields[m + "_scales"], qtype, device)
        qt[m] = (q.codes, q.scales.to(torch.bfloat16))
    hidden, ffn = qt["down"][0].shape[-2], qt["gate"][0].shape[-2]

    def tile(codes, scales, kind, n, **kw):
        rows = gemv_pair_rows(kind, n if kind == "silu" else n // 2, head_dim)
        return gemv_tile(codes, scales, *rows, **kw)

    occ_c, occ_s = qt["occ"]
    occ = [tile(occ_c[..., i * hidden:(i + 1) * hidden, :],
                occ_s[..., i * hidden:(i + 1) * hidden, :], kind, hidden)
           for i, kind in enumerate(("pairs", "rope", "pairs"))]
    return DiaMegaLayers(
        *tile(*qt["qkv"], "rope", qt["qkv"][0].shape[-2]),
        torch.cat([c for c, _ in occ], dim=-3).contiguous(),
        torch.cat([s for _, s in occ], dim=-3).contiguous(),
        *tile(*qt["gate"], "silu", ffn, codes_b=qt["up"][0],
              scales_b=qt["up"][1]),
        *tile(*qt["down"], "pairs", hidden),
        norms=torch.tensor(np.asarray(fields["norms"], np.float32),
                           device=device))
