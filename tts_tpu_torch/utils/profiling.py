"""Tracing / profiling utilities, the port of the JAX package's
`utils/profiling.py`.

`StageTimer` accumulates wall-clock time per named stage (phonemize /
tokenize / encode / decode loop / vocode), as the JAX one does. `trace` is
`torch.profiler` where the JAX package starts `jax.profiler`: host
activity always, the card's kernels when CUDA is there, written into
`log_dir` as a Chrome trace (open it in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Accumulating named stage timer.

        t = StageTimer()
        with t.stage("decode"):
            ...
        print(t.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - start)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = time.perf_counter() - self._t0
        lines = [f"total: {total * 1000:.2f} ms"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {t * 1000:.2f} ms "
                         f"(n={self.counts[name]}, {t / total * 100:.1f}%)")
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps({k: round(v * 1000, 3) for k, v in self.totals.items()})


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace scope; `None` is a no-op.

        with trace("traces/tts"):
            runner.generate(...)

    Writes `log_dir/trace-<pid>.json` (Chrome trace format) when the scope
    ends: CPU activity, and the card's kernels when CUDA is available."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
