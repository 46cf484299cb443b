"""engine.ms_per_step: host time of each engine.step call (one decode
chunk, its one sync, and the refill of freed slots) over the steps it
advanced, over the window (the batched engines)."""
from port_bench.layers import in_window


def read(run):
    spans = in_window(run, "engine.step")
    steps = sum(s[3]["chunk"] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / steps
