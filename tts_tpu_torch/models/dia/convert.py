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
                        device=None) -> DiaMegaLayers:
    """fields: every field of the JAX package's DiaMegaLayers as numpy:
    `<m>_codes` (L, K or K/2 packed, N) and `<m>_scales` (L, K/32, N) bf16
    for m in qkv, occ, gate, up, down, and norms (L, 3, H)."""
    device = default_device(device)
    out = {}
    for m in ("qkv", "occ", "gate", "up", "down"):
        qt = QuantTensor.from_transposed(fields[m + "_codes"],
                                         fields[m + "_scales"], qtype, device)
        out[m + "_codes"] = qt.codes.contiguous()
        out[m + "_scales"] = qt.scales.to(torch.bfloat16).contiguous()
    out["norms"] = torch.tensor(np.asarray(fields["norms"], np.float32),
                                device=device)
    return DiaMegaLayers(**out)
