"""The last line's contract, on tiny cells run whole on the CPU; run.py's
refusal without a card; and that nothing the harness imports is JAX or the
JAX package (top-level module names compared whole)."""
import ast
import json
import subprocess
import sys

import pytest

from port_bench import common, harness
from port_bench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 977          # larger than 32 signed bits hold
FORBIDDEN = {"jax", "jaxlib", "flax", "tts_tpu"}


@pytest.fixture(scope="module",
                params=[w["name"] for w in common.benchmark()["workloads"]])
def traced(request):
    return request.param, harness.run(tiny_cell(request.param), SEED, 3.0, 1,
                                      device="cpu", drain_s=30.0)


def test_last_line(traced):
    name, res = traced
    line = json.dumps(res, allow_nan=False)
    back = json.loads(line)
    assert list(back)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(back)
    assert back["correct"] is True, back["checks"]
    assert back["attempted"] > 0 and back["failed"] == 0
    cell = common.Cell(common.benchmark(), name)
    allowed = {m["name"] for m in cell.metrics("per_layer")}
    assert set(back["metrics"]) <= allowed and back["metrics"]
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert set(back["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(back["breakdown"]["idle_gaps"]) <= 10


def test_end_to_end_line():
    res = harness.run(tiny_cell("parler.serve.stream"), SEED + 1, 3.0, 0,
                      device="cpu")
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"served_audio_s_per_wall_s", "setup_s"}
    assert res["metrics"]["served_audio_s_per_wall_s"]["value"] > 0


def test_trace_that_lost_kernels_fails_loudly(monkeypatch):
    """A traced run none of whose sessions holds the counted launches
    raises, and prints no line that lacks its per-layer metrics."""
    monkeypatch.setattr(harness, "_trace_complete", lambda run: False)
    with pytest.raises(RuntimeError, match="lost kernels"):
        harness.run(tiny_cell("dia.cli"), SEED + 2, 2.0, 1, device="cpu")


def test_streams_credit_the_audio_delivered_in_the_window():
    """A stream's chunks count where they arrived: inside the window, also
    of a request that began before it or ended after it; a failed
    request's count nowhere."""
    class R:
        window = (10.0, 20.0)
        traffic = {"stream": True}

        class fam:
            SAMPLE_RATE = 100
    R.records = [
        {"ok": True, "chunks": [[9.0, 200], [11.0, 200], [19.0, 200]]},
        {"ok": True, "chunks": [[19.5, 400], [21.0, 400]]},
        {"ok": False, "chunks": [[12.0, 800]]},
    ]
    assert harness.window_audio_s(R) == (200 + 200 + 400) / 2 / 100


def test_same_seed_same_requests():
    from port_bench import loadgen
    t = tiny_cell("dia.cli").traffic
    fam = common.family("dia")
    lo, hi = t["prompt_sizes"]
    n = 2 * (hi - lo + 1) * len(t["sampling"])     # whole cycles of both
    a = loadgen.request_specs(t, SEED, fam.prompt, n)
    assert a == loadgen.request_specs(t, SEED, fam.prompt, n)
    b = loadgen.request_specs(t, SEED + 1, fam.prompt, n)
    assert a != b
    for key in ("size", "greedy"):
        assert sorted(x[key] for x in a) == sorted(x[key] for x in b)


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(common.BENCH_DIR / "run.py"),
                        "--workload", "dia.cli", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=common.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_jax_in_the_sources():
    for path in common.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_no_jax_loaded_by_a_run():
    """A whole tiny run in a fresh interpreter, then sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from port_bench import harness\n"
        "from port_bench.tests.tiny import tiny_cell\n"
        "from port_bench.run import forbidden_modules\n"
        "if __name__ == '__main__':\n"
        "    harness.run(tiny_cell('dia.cli'), 5, 1.0, 0, device='cpu')\n"
        "    print(forbidden_modules())\n") % str(common.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole():
    from port_bench.run import forbidden_modules
    import tts_tpu_torch  # noqa: F401 — begins with "tts_tpu", is not it
    assert "tts_tpu" not in forbidden_modules()
