"""Frame-energy voice-inactivity trim.

Parity: reference examples/cli/vad.cpp:11-68 — min-max-normalized per-frame
energy, trailing-silence strip, early cutoff on >= 3s of silence.
"""
from __future__ import annotations

import numpy as np


def apply_energy_voice_inactivity_detection(
    audio: np.ndarray,
    sample_rate: float = 44_100.0,
    ms_per_frame: int = 10,
    frame_threshold: int = 20,
    normalized_energy_threshold: float = 0.01,
    trailing_silent_frames: int = 5,
    early_cutoff_seconds_threshold: int = 3,
    early_cutoff_energy_threshold: float = 0.1,
) -> np.ndarray:
    samples_per_frame = int(ms_per_frame * sample_rate / 1000.0)
    n_frames = len(audio) // samples_per_frame
    if n_frames == 0:
        return audio
    early_cutoff_frames = int(early_cutoff_seconds_threshold * 1000 / ms_per_frame)

    frames = audio[: n_frames * samples_per_frame].reshape(n_frames, samples_per_frame)
    energies = np.sum(frames.astype(np.float64) ** 2, axis=1).astype(np.float32)

    # early cutoff: a run of absolutely-silent frames terminates the clip
    silent = 0
    for i in range(n_frames):
        if energies[i] <= early_cutoff_energy_threshold:
            silent += 1
        else:
            silent = 0
        if silent >= early_cutoff_frames:
            end = (i + 1 + trailing_silent_frames - silent) * samples_per_frame
            return audio[:max(end, 0)]

    mx, mn = float(energies.max()), float(energies.min())
    denom = (mx - mn) or 1.0
    concurrent = 0
    for i in range(n_frames, 0, -1):
        if (energies[i - 1] - mn) / denom < normalized_energy_threshold:
            concurrent += 1
        else:
            break
    if concurrent >= frame_threshold:
        cut = (concurrent - trailing_silent_frames) * samples_per_frame
        return audio[: len(audio) - cut]
    return audio
