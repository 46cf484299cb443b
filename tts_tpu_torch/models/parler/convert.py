"""Carry the JAX package's Parler weights across to the port's layouts.

`parler_weights_from_numpy` takes the fields of the JAX package's
`ParlerWeights` / `ParlerLayerWeights` as numpy arrays — each dense leaf an
array, each QuantTensor a tuple (codes_t, scales_t, qtype) in its
transposed (K, N) device layout, packed or not, with float32 or bfloat16
scales — and returns the port's `ParlerWeights`, so both packages compute
the same thing from the same weights. The caller does the JAX-side
flattening; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ...common import default_device
from ...ops.quant_matmul import QuantTensor
from .model import ParlerLayerWeights, ParlerWeights


def _leaf(v: Any, device):
    if isinstance(v, tuple):
        codes_t, scales_t, qtype = v
        return QuantTensor.from_transposed(codes_t, scales_t, int(qtype), device)
    return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)


def parler_weights_from_numpy(fields: Mapping[str, Any],
                              device=None) -> ParlerWeights:
    """fields: every ParlerWeights field; fields["layers"] maps every
    ParlerLayerWeights field. Leaves as described in the module docstring.
    The weights land on `device` (default cuda, see common.default_device)."""
    device = default_device(device)
    layers = ParlerLayerWeights(**{f: _leaf(fields["layers"][f], device)
                                   for f in ParlerLayerWeights._fields})
    return ParlerWeights(layers=layers, **{
        f: _leaf(fields[f], device) for f in ParlerWeights._fields
        if f != "layers"})
