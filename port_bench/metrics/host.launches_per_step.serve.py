"""host.launches_per_step.serve (read through host.launches_per_step.cli in a
single-stream cell): device operations (kernels, copies, memsets) the host
launched per decode step, over the traced window's whole spans: a chunk's
launches over its steps in a served cell (the refill's prefills and the sync
included), a request's over its decode steps (the encoder and the vocode
included) in a single-stream one."""
from port_bench.layers import in_trace, traced_spans


def read(run):
    spans = traced_spans(run)
    if not spans:
        return None
    events = sum(run.trace.count(None, s[1], s[2]) for s in spans)
    if spans[0][0] == "engine.step":
        steps = sum(s[3]["chunk"] for s in spans)
    else:
        steps = sum(d[3]["steps"] for d in in_trace(run, "runner.decode"))
    return events / steps if steps else None
