"""runner.ms_per_step: host time of the runner's chunked decode loop (one
sync a chunk) over its steps, over the window's requests (the traced run
synchronizes before the loop, so the encoder's work is not in it)."""
from port_bench.layers import in_window


def read(run):
    spans = in_window(run, "runner.decode")
    steps = sum(s[3]["steps"] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / steps
