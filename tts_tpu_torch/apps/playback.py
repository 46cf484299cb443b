"""Audio playback for the CLI's --play (parity: reference
examples/cli/playback.cpp, SDL2-based), a copy of the JAX package's
`apps/playback.py`.

It tries the common Python backends and raises when there is none, so that
the CLI writes a file instead, as the reference does when built without
SDL2.
"""
from __future__ import annotations

import numpy as np


def play_audio(audio: np.ndarray, sample_rate: int) -> bool:
    try:
        import sounddevice  # type: ignore
    except Exception:
        try:
            import simpleaudio  # type: ignore
        except Exception:
            raise RuntimeError("no playback backend (sounddevice/simpleaudio)")
        pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
        simpleaudio.play_buffer(pcm, 1, 2, sample_rate).wait_done()
        return True
    sounddevice.play(audio, sample_rate)
    sounddevice.wait()
    return True
