"""runner.encode_ms: the mean time of the runner's encoder pass and cross
K / V preparation (DiaRunner.encode), synchronized before and after, over
the window's requests (traced runs only)."""
from port_bench.layers import in_window


def read(run):
    spans = in_window(run, "runner.encode")
    if not spans or not run.trace_on:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / len(spans)
