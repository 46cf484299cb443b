"""Carry the JAX package's Orpheus weights across to the port's layouts.

`orpheus_weights_from_numpy` takes the fields of the JAX package's
`OrpheusWeights` / `OrpheusLayer` as numpy arrays — each dense leaf an
array, each QuantTensor a tuple (codes_t, scales_t, qtype) in its
transposed (K, N) device layout, packed or not, with float32 or bfloat16
scales — and returns the port's `OrpheusWeights`. `llama_mega_from_numpy`
does the same for the JAX package's `LlamaMegaLayers` (K8's layout), so
both packages run K8's function on the same weights. The caller does the
JAX-side flattening; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ...common import default_device
from ...ops.llama_megastep import LlamaMegaLayers, gemv_pair_rows, gemv_tile
from ...ops.quant_matmul import QuantTensor
from ..parler.convert import _leaf
from .model import OrpheusLayer, OrpheusWeights


def orpheus_weights_from_numpy(fields: Mapping[str, Any],
                               device=None) -> OrpheusWeights:
    """fields: every OrpheusWeights field; fields["layers"] maps every
    OrpheusLayer field. Leaves as described in the module docstring. The
    weights land on `device` (default cuda, see common.default_device)."""
    device = default_device(device)
    layers = OrpheusLayer(**{f: _leaf(fields["layers"][f], device)
                             for f in OrpheusLayer._fields})
    return OrpheusWeights(layers=layers, **{
        f: _leaf(fields[f], device) for f in OrpheusWeights._fields
        if f != "layers"})


def llama_mega_from_numpy(fields: Mapping[str, np.ndarray], qtype: int,
                          head_dim: int, device=None) -> LlamaMegaLayers:
    """fields: every field of the JAX package's LlamaMegaLayers as numpy:
    `<m>_codes` (L, K or K/2 packed, N) and `<m>_scales` (L, K/32, N) for
    m in qkv, o, gate, up, down, and norms (L, 2, H), heads of `head_dim`.
    Scale dtypes are kept (qkv float32, the others bfloat16, as the JAX prep
    makes them); each projection is tiled for the GEMV (gemv_tile)."""
    device = default_device(device)
    qt = {m: QuantTensor.from_transposed(fields[m + "_codes"],
                                         fields[m + "_scales"], qtype, device)
          for m in ("qkv", "o", "gate", "up", "down")}
    hidden, ffn = qt["o"].shape[0], qt["gate"].shape[0]

    def tile(m, kind, n, **kw):
        rows = gemv_pair_rows(kind, n if kind == "silu" else n // 2, head_dim)
        return gemv_tile(qt[m].codes, qt[m].scales, *rows, **kw)

    return LlamaMegaLayers(
        *tile("qkv", "rope", qt["qkv"].shape[0]), *tile("o", "pairs", hidden),
        *tile("gate", "silu", ffn, codes_b=qt["up"].codes,
              scales_b=qt["up"].scales),
        *tile("down", "pairs", hidden),
        norms=torch.tensor(np.asarray(fields["norms"], np.float32),
                           device=device))
