"""Common types shared across the port.

`GenerationConfig`, `TTSResponse`, `SAMPLE_RATE_DAC`, `SAMPLE_RATE_SNAC`,
`SAMPLE_RATE_KOKORO`, `KOKORO_SAMPLES_PER_FRAME` and `chunk_schedule` are
copies of the JAX package's `common.py` (parity:
reference include/common.h:45-74). `kv_cache_dtype` and `default_device`
are the port's own: they key on the torch device instead of the JAX
platform.

Runtime switches, read by the JAX package's variable names and meanings,
so that a deployment's settings carry over (each is read where it takes
effect, not cached):
  * TTS_TPU_KV_DTYPE=float32|bfloat16: the self-attention caches' dtype
    (`kv_cache_dtype`; unset: by device).
  * TTS_TPU_MEGAKERNEL=0: every decode route gate returns None, so runners
    and engines take the per-matmul route, K1 per projection and K3 / K4
    for attention (`megakernel_enabled`). "1", or unset: the gates choose
    by the weights, never by the device; that is the port's counterpart of
    the JAX package forcing its fused path off the TPU.
  * TTS_TPU_DAC_DTYPE=bfloat16: the DAC's convolution weights in bf16
    (models/codec/dac.py `default_dac_dtype`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

# Audio-rate constants (reference: src/decoder/dac_model.h:27-31,
# snac_model.h).
SAMPLE_RATE_DAC = 44_100
SAMPLE_RATE_SNAC = 24_000
SAMPLE_RATE_KOKORO = 24_000
# Kokoro: audio samples per duration frame (reference kokoro/model.h)
KOKORO_SAMPLES_PER_FRAME = 600


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


KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def kv_cache_dtype(device) -> torch.dtype:
    """Dtype for autoregressive KV caches: TTS_TPU_KV_DTYPE (float32 or
    bfloat16, the dtypes every cache-reading kernel takes) when set, as in
    the JAX package's `kv_cache_dtype`; else bfloat16 on the card (halves
    the per-step cache read) and float32 on the CPU so parity tests stay
    exact."""
    env = os.environ.get("TTS_TPU_KV_DTYPE")
    if env:
        if env not in KV_DTYPES:
            raise ValueError(f"TTS_TPU_KV_DTYPE={env!r}: the caches take "
                             f"{' or '.join(KV_DTYPES)}")
        return KV_DTYPES[env]
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def megakernel_enabled() -> bool:
    """False when TTS_TPU_MEGAKERNEL is "0" (the JAX package's test: only
    "0" turns the fused routes off): the route gates then return None and
    every runner and engine takes the per-matmul route."""
    return os.environ.get("TTS_TPU_MEGAKERNEL") != "0"


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
