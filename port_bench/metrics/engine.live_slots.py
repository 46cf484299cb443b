"""engine.live_slots: the mean number of slots holding a request at the
start of each decode chunk of the window (a slot whose request ends inside
a chunk counts as live for the whole chunk)."""
from port_bench.layers import in_window


def read(run):
    spans = in_window(run, "engine.step")
    if not spans:
        return None
    return sum(len(s[3]["live"]) for s in spans) / len(spans)
