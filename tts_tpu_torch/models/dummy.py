"""Dummy test model: per-character sine waves, no weights needed (a copy of
the JAX package's `models/dummy.py`).

Parity: reference src/models/dummy/model.cpp:6-19 — reachable via the
`test:dummy` path (loaders.cpp:37-44) so the CLI can be exercised without
checkpoints.
"""
from __future__ import annotations

import numpy as np

from ..common import GenerationConfig, TTSResponse
from .base import TTSRunner

_SR = 44_100


class DummyRunner(TTSRunner):
    arch = "dummy"

    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        data = text.encode("utf-8")
        n = len(data)
        out = np.zeros(n * _SR, np.float32)
        j = np.arange(_SR, dtype=np.float32)
        env = np.sin(j * np.float32(np.pi / _SR))
        for i, ch in enumerate(data):
            wavelength = np.float32(_SR / np.pi / 2) / np.float32(200 + ch)
            out[i * _SR:(i + 1) * _SR] = env * np.sin(j / wavelength)
        return TTSResponse(out, _SR)
