"""The traced window of a --trace 1 run: torch.profiler's device activity,
reduced to busy time, time by kernel, and the longest idle gaps named by
the host span that was open during each.

The profiler's device timestamps are on the wall clock (ns since the
epoch); the harness's spans are on time.perf_counter, converted with the
offset `Spans.wall_offset_ns`.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict


def kernel_key(name: str) -> str:
    """A device event's kernel name without namespace, return type and
    template arguments (at most 48 characters)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name)[0].split("::")[-1][:48]


def merge(spans: list) -> list:
    """Sorted (start, end) intervals merged where they overlap (kernels
    launched with programmatic dependent launch overlap the one before)."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(spans: list) -> float:
    return sum(e - s for s, e in merge(spans))


class DeviceTrace:
    """Start, stop, and the device's kernels between (ns, wall clock)."""

    def __init__(self, spans, device_type: str = "cuda"):
        self.spans = spans
        self.device_type = device_type   # "cpu": the host's ops stand in
        self.prof = None
        self.kernels: list = []      # (key, start_ns, end_ns)
        self.t0 = self.t1 = None     # perf_counter

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if self.device_type == "cuda"
            else ProfilerActivity.CPU])
        # the wall clock and perf_counter drift apart over a run: take
        # their offset afresh where the spans are matched to the trace
        self.spans.wall_offset_ns = time.time_ns() - time.perf_counter_ns()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        self.t1 = time.perf_counter()
        self.prof.stop()
        lo, hi = self.spans.to_wall_ns(self.t0), self.spans.to_wall_ns(self.t1)
        want = torch.autograd.DeviceType.CUDA if self.device_type == "cuda" \
            else torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != want:
                continue
            s, d = e.start_ns(), e.duration_ns()
            if s + d < lo or s > hi:
                continue
            self.kernels.append((kernel_key(e.name()), max(s, lo),
                                 min(s + d, hi)))
        self.prof = None

    def complete(self, launched: int, names) -> bool:
        """Whether the session recorded at least 90% of the `launched`
        launches of the kernels `names` that the program's counters counted
        over it (the profiler has been seen to record only copies, or a
        few kernels, for a whole session)."""
        return self.count(names) >= 0.9 * launched

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self, t0: float | None = None, t1: float | None = None,
               names=None) -> float:
        """Seconds some kernel (of `names`, when given) ran, between
        perf_counter times t0 and t1 (the traced window by default)."""
        lo = self.spans.to_wall_ns(self.t0 if t0 is None else t0)
        hi = self.spans.to_wall_ns(self.t1 if t1 is None else t1)
        sp = [(max(s, lo), min(e, hi)) for k, s, e in self.kernels
              if (names is None or k in names) and e > lo and s < hi]
        return covered(sp) / 1e9

    def count(self, names, t0: float | None = None,
              t1: float | None = None) -> int:
        lo = self.spans.to_wall_ns(self.t0 if t0 is None else t0)
        hi = self.spans.to_wall_ns(self.t1 if t1 is None else t1)
        return sum(1 for k, s, e in self.kernels
                   if (names is None or k in names) and s >= lo and e <= hi)

    def by_kernel(self) -> dict:
        d = defaultdict(list)
        for k, s, e in self.kernels:
            d[k].append((s, e))
        return {k: (covered(v) / 1e9, len(v)) for k, v in d.items()}

    def breakdown(self, n: int = 10) -> dict:
        """The n device operations that took most time, and the n longest
        idle gaps, each named by the innermost host span open at its
        middle ("no span" where none was)."""
        ops = sorted(((k, v[0]) for k, v in self.by_kernel().items()),
                     key=lambda kv: -kv[1])[:n]
        lo, hi = self.spans.to_wall_ns(self.t0), self.spans.to_wall_ns(self.t1)
        busy = merge([(s, e) for _, s, e in self.kernels])
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        off = self.spans.wall_offset_ns
        named = []
        for s, e in gaps[:n]:
            mid = ((s + e) / 2 - off) / 1e9
            open_ = [sp for sp in self.spans.items if sp[1] <= mid <= sp[2]]
            name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ \
                else "no span"
            named.append([name, (e - s) / 1e9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
