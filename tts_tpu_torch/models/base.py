"""Runner base class (parity: reference include/common.h:76-101
`tts_runner` / `tts_generation_runner`)."""
from __future__ import annotations

import abc
from typing import List

from ..common import GenerationConfig, TTSResponse


class TTSRunner(abc.ABC):
    """A loaded model that can synthesize speech from text."""

    arch: str = ""
    #: output waveform sample rate in Hz
    sample_rate: int = 44_100

    @abc.abstractmethod
    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        ...

    def list_voices(self) -> List[str]:
        """Parity: tts_runner::list_voices (include/common.h:84)."""
        return []

    def update_conditional_prompt(self, file_path: str, prompt: str) -> None:
        """Parity: parler update_conditional_prompt (common.h:97)."""
        raise NotImplementedError(f"{self.arch} does not support conditional prompts")
