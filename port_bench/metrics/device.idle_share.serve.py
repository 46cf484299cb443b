"""device.idle_share.serve (read through device.idle_share.cli in a single-
stream cell): the share of the traced window (%) in which no kernel, copy or
memset ran on the card (torch.profiler's device activity, overlapping spans
counted once)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
