"""Common types shared across the port.

`GenerationConfig`, `TTSResponse`, `SAMPLE_RATE_DAC`, `SAMPLE_RATE_SNAC` and
`chunk_schedule` are copies of the JAX package's `common.py` (parity:
reference include/common.h:45-74). `kv_cache_dtype` and `default_device`
are the port's own: they key on the torch device instead of the JAX
platform.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Audio-rate constants (reference: src/decoder/dac_model.h:27-31,
# snac_model.h).
SAMPLE_RATE_DAC = 44_100
SAMPLE_RATE_SNAC = 24_000


@dataclasses.dataclass
class GenerationConfig:
    """Per-request sampling/generation settings.

    Parity: reference `generation_configuration` include/common.h:45-66.
    """

    voice: str = ""
    top_k: int = 0  # 0 => disabled (reference uses max_top_k sentinel)
    temperature: float = 1.0
    repetition_penalty: float = 1.0
    use_cross_attn: bool = True
    espeak_voice_id: str = ""
    max_tokens: int = 0  # 0 => model default
    top_p: float = 1.0
    sample: bool = True
    seed: Optional[int] = None  # explicit PRNG seed


@dataclasses.dataclass
class TTSResponse:
    """Generated audio (reference `tts_response` include/common.h:70-74)."""

    audio: np.ndarray  # float32 waveform, mono
    sample_rate: int

    @property
    def n_outputs(self) -> int:
        return int(self.audio.shape[-1])

    @property
    def duration_s(self) -> float:
        return self.n_outputs / float(self.sample_rate)


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else `cuda`.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    card: the port never carries on on the CPU unless the caller asks for it.
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's plain "
            "PyTorch versions on the CPU")
    return dev


def kv_cache_dtype(device) -> torch.dtype:
    """Dtype for autoregressive KV caches: bfloat16 on the card (halves the
    per-step cache read), float32 on the CPU so parity tests stay exact."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def chunk_schedule(first: int = 64, cap: int = 256):
    """Yield decode-chunk sizes 64, 128, 256, 256, ... .

    Each chunk boundary costs one host sync, so chunks grow geometrically;
    the first chunks stay small so short generations don't overshoot EOS by
    hundreds of steps.
    """
    c = first
    while True:
        yield c
        c = min(c * 2, cap)


def strict_fp32() -> None:
    """Keep float32 products and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default
    (torch.backends.cudnn.allow_tf32 is True), which keeps about three
    decimal digits; the JAX reference computes them in float32. The port's
    entry points call this when they build a runner, turning TF32 off for
    both cuDNN convolutions and cuBLAS matmuls (the latter is off by default
    already; it is set so that nothing else in the process can change it
    unseen)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
