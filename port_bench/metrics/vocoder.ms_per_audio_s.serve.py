"""vocoder.ms_per_audio_s.serve (read through vocoder.ms_per_audio_s.cli in a
single-stream cell): DAC decode time (synchronized before the call; the call
returns on the host) over the seconds of audio it decoded, margins of
streamed segments included, over the window."""
from port_bench.layers import in_window

HOP = 512


def read(run):
    spans = in_window(run, "vocoder.decode")
    audio = sum(s[3]["frames"] for s in spans) * HOP / run.fam.SAMPLE_RATE
    if not audio or not run.trace_on:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / audio
