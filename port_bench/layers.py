"""What the per-layer metric readers share: the spans of the window and of
the traced window, and the decode steps each span holds."""
from __future__ import annotations


def in_window(run, name: str) -> list:
    """Spans called `name` that ended inside the measured window."""
    w0, w1 = run.window
    return [s for s in run.spans.named(name) if w0 <= s[2] <= w1]


def in_trace(run, name: str) -> list:
    """Spans called `name` that lie wholly inside the traced window."""
    if run.trace is None:
        return []
    t0, t1 = run.trace.t0, run.trace.t1
    return [s for s in run.spans.named(name) if s[1] >= t0 and s[2] <= t1]


def chunk_positions(run, span) -> list:
    """The cache positions of the live slots at each decode step of an
    engine.step span: a slot live at the chunk's start moves one position
    a step until the window's last position."""
    attrs = span[3]
    last = run.fam.last_position(run.cfg)
    pos0 = attrs["pos"]
    return [[pos0[s] + j for s in attrs["live"] if pos0[s] + j <= last]
            for j in range(attrs["chunk"])]


def request_positions(run, span) -> list:
    """A single-stream request's decode steps, at positions 0, 1, ...
    (runner.decode span)."""
    return list(range(span[3]["steps"]))


def kernel_busy(run, spans: list, names) -> float:
    """Seconds the named kernels ran inside the given spans."""
    return sum(run.trace.busy_s(s[1], s[2], names) for s in spans)


def kernel_count(run, spans: list, names) -> int:
    return sum(run.trace.count(names, s[1], s[2]) for s in spans)


def steps_of(run, spans: list) -> list:
    """Every decode step of the spans that had a live request: the
    positions of its live requests (engine.step spans: the chunk's steps;
    runner.generate spans: the request's runner.decode steps)."""
    out = []
    for s in spans:
        if s[0] == "engine.step":
            out += [p for p in chunk_positions(run, s) if p]
        else:
            for d in run.spans.named("runner.decode"):
                if s[1] <= d[1] and d[2] <= s[2]:
                    out += [[p] for p in request_positions(run, d)]
    return out


def step_work(run, positions: list, span=None) -> dict:
    """(flops, bytes) by kernel family of one step."""
    if span is not None and span[0] == "runner.generate":
        return run.fam.single_step_work(run.cfg, positions[0],
                                        prompt_bytes_of(run, span))
    return run.fam.step_work(run.cfg, positions)


def prompt_bytes_of(run, span) -> int:
    for d in run.spans.named("runner.decode"):
        if span[1] <= d[1] and d[2] <= span[2]:
            return d[3]["prompt_bytes"]
    return 0


def traced_spans(run) -> list:
    """The spans of decode work wholly inside the traced window: engine
    chunks in a served cell, whole requests in a single-stream one."""
    return in_trace(run, "engine.step") or in_trace(run, "runner.generate")


def roofline_share(run, part: str) -> float | None:
    """The `part` kernel family's share of its roofline over the traced
    window's whole spans, in %: the least time its work could take (each
    step's bound, summed) over the time its kernels ran in those spans.
    None where nothing ran, or where the trace holds under 90% of the
    one-launch-a-step K10 launches the steps made (the profiler lost
    events)."""
    from port_bench import roofline as rl
    names = rl.KERNELS[part]
    spans = traced_spans(run)
    least = 0.0
    steps = 0
    for s in spans:
        for positions in steps_of(run, [s]):
            w = step_work(run, positions, s)
            if part in w:
                least += rl.bound_s(*w[part])
                steps += 1
    busy = kernel_busy(run, spans, names) if spans else 0.0
    if not steps or busy <= 0:
        return None
    if part == "k10" and kernel_count(run, spans, names) < 0.9 * steps:
        return None
    return 100.0 * least / busy
