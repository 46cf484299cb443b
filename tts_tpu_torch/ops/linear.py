"""Weight containers: a dense float32 tensor or a block-quantized QuantTensor.

`matmul(x, w)` computes x @ W^T for either; quantized weights go through
`quant_matmul` (kernel K1 on the card). Dense products are plain
torch.matmul in full float32 (TF32 stays off, see common.strict_fp32).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..common import default_device
from ..gguf import quants
from .quant_matmul import QuantTensor, quant_matmul

Weight = Union[torch.Tensor, QuantTensor]


def matmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ W.T for a logical weight W (N, K); x (..., K) -> (..., N)."""
    if isinstance(w, QuantTensor):
        lead = x.shape[:-1]
        y = quant_matmul(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*lead, y.shape[-1])
    return torch.matmul(x, w.T)


def take_rows(w: Weight, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup W[ids] for dense or quantized weights."""
    if isinstance(w, QuantTensor):
        return w.take_rows(ids)
    return w[ids]


def dense(w: Weight, dtype=torch.float32) -> torch.Tensor:
    if isinstance(w, QuantTensor):
        return w.dense(dtype)
    return w.to(dtype)


def from_gguf_tensor(reader, name: str, device=None) -> Weight:
    """Load one GGUF tensor as a weight on `device` (default cuda, see
    common.default_device).

    Block-quantized tensors stay quantized (QuantTensor, float32 scales;
    Q4_0 nibble-packed, which is ggml's own byte order); F16/F32 load dense
    float32.
    """
    device = default_device(device)
    ti = reader.tensors[name]
    if quants.is_quantized(ti.ggml_type):
        if len(ti.shape) != 2:
            raise ValueError(f"quantized tensor {name} must be 2D, got {ti.shape}")
        codes, scales = quants.unpack_planar(reader.raw(name), ti.ggml_type,
                                             ti.shape)
        return QuantTensor.from_planar(codes, scales, ti.ggml_type,
                                       device).pack()
    arr = np.array(reader.array(name), dtype=np.float32)
    return torch.from_numpy(arr).to(device)


def stack_weights(ws: list) -> Weight:
    """Stack per-layer weights along a new axis 0.

    All quantized with one qtype and one packing -> QuantTensor with stacked
    codes/scales; otherwise dequantize to a dense stack.
    """
    if all(isinstance(w, QuantTensor) for w in ws):
        w0 = ws[0]
        if all(w.qtype == w0.qtype and w.codes.shape == w0.codes.shape
               and w.scales.dtype == w0.scales.dtype for w in ws):
            return QuantTensor(torch.stack([w.codes for w in ws]),
                               torch.stack([w.scales for w in ws]), w0.qtype)
    return torch.stack([dense(w) for w in ws])
