"""tts_tpu_torch — the PyTorch + CUDA port of tts_tpu for NVIDIA Hopper (H100).

A second package beside `tts_tpu`, which stays the reference each part of the
port is held against. It imports torch and numpy, never jax, and nothing from
`tts_tpu`: the host-side modules it needs (GGUF, tokenizer, WAV) are its own
copies. Every Pallas kernel on a ported path becomes a CUDA C++ kernel for
sm_90a (`csrc/`), built with nvcc at first use and bound with ctypes
(`ops/_build.py`); beside each kernel sits a plain PyTorch version of the same
function, which the wrapper runs only for tensors on the CPU.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

from .common import (  # noqa: F401
    GenerationConfig,
    TTSResponse,
    SAMPLE_RATE_DAC,
)
