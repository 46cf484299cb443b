"""Finding a cell's parts by name, and the records a run keeps.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name `BENCHMARK.json` gives
it:

    configs/<config>.json        sizes, the deployment, what was cut
    traffic/<traffic>.json       the mix's parameters (read by loadgen.py)
    families/<family>.py         how a model family is built, its reference
    metrics/<metric>.py          one reader per per-layer metric

so that a later cell adds files and entries and edits none. Standard
library only: the load generator's child process imports this module.
"""
from __future__ import annotations

import importlib.util
import json
import threading
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import the file at `path` as a module of its own (metric files are
    named after their metrics, dots included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic
    resolved from their files."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        self.bench = bench
        self.workload = find(bench["workloads"], workload, "workload")
        self.name = workload
        self.config_entry = find(bench["configs"], self.workload["config"],
                                 "config")
        self.config = load_json(root / self.config_entry["file"])
        self.traffic_name = self.workload["traffic"]
        self.bench_dir = root / BENCH_DIR.name
        self.traffic = load_json(self.bench_dir / "traffic" /
                                 f"{self.traffic_name}.json")
        self.chips = int(self.workload["chips"])

    def metrics(self, kind: str) -> list:
        """The `end_to_end` or `per_layer` metrics this cell reports: those
        without a `workloads` key, and those that list it."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def family(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "families" / f"{name}.py",
                       f"port_bench_family_{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "port_bench_metric_" + name.replace(".", "_"))


class Spans:
    """Host spans and counts recorded from the benchmark's own wrappers
    around the calls into each layer: (name, start, end, attrs), times from
    time.perf_counter. Thread-safe: the server's threads record too."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: list = []
        # time.time_ns() - perf_counter_ns(): the profiler's clock is the
        # wall clock in ns
        self.wall_offset_ns = time.time_ns() - time.perf_counter_ns()

    def add(self, name: str, t0: float, t1: float, **attrs) -> None:
        with self._lock:
            self.items.append((name, t0, t1, attrs))

    def named(self, name: str) -> list:
        with self._lock:
            return [s for s in self.items if s[0] == name]

    def to_wall_ns(self, t: float) -> int:
        return int(t * 1e9) + self.wall_offset_ns
