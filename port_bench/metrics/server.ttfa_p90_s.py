"""server.ttfa_p90_s: the 90th percentile of the time to first audio over
every streamed request sent in the window (a stream that failed counts as
missing), from the client's clock (the HTTP server layer). A per-layer
metric: its spread from run to run (15-20% of the median, PERF.md) would
need a bound past the end-to-end metrics' limit."""
import math

from port_bench.harness import percentile, ttfa_values


def read(run):
    if not run.traffic.get("stream"):
        return None
    v = ttfa_values(run)
    p = percentile(v, 90) if v else math.inf
    return p if math.isfinite(p) else None
