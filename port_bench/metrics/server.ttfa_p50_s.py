"""server.ttfa_p50_s: the median time to first audio of the window's
streamed requests, from the client's clock (the HTTP server layer)."""
from port_bench.harness import percentile, ttfa_values


def read(run):
    if not run.traffic.get("stream"):
        return None
    v = ttfa_values(run)
    return percentile(v, 50) if v else None
