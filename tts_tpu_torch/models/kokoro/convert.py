"""Carry the JAX package's Kokoro weights across to the port's containers.

`kokoro_weights_from_numpy` takes the JAX package's `KokoroWeights` with
every leaf a numpy array (the caller maps its leaves through `np.asarray`)
and returns the port's `KokoroWeights` on a device: the containers are
matched by class name and field, lists and tuples kept, absent tensors
(None) kept. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...common import default_device
from ...ops.rnn import LSTMWeights
from . import model as km

_CONTAINERS = {c.__name__: c for c in (
    LSTMWeights, km.AlbertLayer, km.AdaLayerNormW, km.AdaResBlockW,
    km.GenResBlockW, km.NoiseBlockW, km.DurationPredictorW, km.TextEncoderW,
    km.GeneratorW, km.DecoderW, km.KokoroWeights)}


def kokoro_weights_from_numpy(tree: Any, device=None) -> km.KokoroWeights:
    """The port's KokoroWeights from the JAX package's, leaves as numpy
    arrays, on `device` (default cuda, see common.default_device)."""
    device = default_device(device)

    def conv(v):
        if v is None:
            return None
        if hasattr(v, "_fields"):
            cls = _CONTAINERS[type(v).__name__]
            return cls(*(conv(getattr(v, f)) for f in cls._fields))
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        return torch.tensor(np.asarray(v, dtype=np.float32), device=device)

    return conv(tree)
