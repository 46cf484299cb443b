"""Runner base class (parity: reference include/common.h:76-101
`tts_runner` / `tts_generation_runner`)."""
from __future__ import annotations

import abc
from typing import List

from ..common import GenerationConfig, TTSResponse


class TTSRunner(abc.ABC):
    """A loaded model that can synthesize speech from text."""

    arch: str = ""
    #: output waveform sample rate in Hz (the server's PCM streaming header
    #: needs it before a TTSResponse exists)
    sample_rate: int = 44_100

    @abc.abstractmethod
    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        ...

    def list_voices(self) -> List[str]:
        """Parity: tts_runner::list_voices (include/common.h:84)."""
        return []

    def generate_stream(self, text: str, config: GenerationConfig | None = None,
                        **kw):
        """Streaming fallback: one chunk holding the whole waveform. Models
        with an incremental decode and vocode override it."""
        resp = self.generate(text, config)
        if resp.audio.size:
            yield resp.audio

    def update_conditional_prompt(self, file_path: str, prompt: str) -> None:
        """Parity: parler update_conditional_prompt (common.h:97)."""
        raise NotImplementedError(f"{self.arch} does not support conditional prompts")
