"""Cells, configurations, traffic files and metric readers are found by
name, BENCHMARK.json keeps the contract's form, and a new cell is added as
new entries and files without editing any existing file."""
import json
import re
import shutil

import pytest

from port_bench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


@pytest.fixture(scope="module")
def bench():
    return common.benchmark()


def test_contract_form(bench):
    assert set(bench) == KEYS["top"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert set(e) <= KEYS[kind], (kind, e["name"])
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and kind != "end_to_end" and kind != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_part_found_by_name(bench):
    for w in bench["workloads"]:
        cell = common.Cell(bench, w["name"])
        assert cell.config["family"]
        fam = common.family(cell.config["family"])
        for attr in ("make_raw", "build", "ref_logits", "ref_frames",
                     "prompt", "step_work", "SOURCES"):
            assert hasattr(fam, attr)
        assert cell.traffic["mode"] in ("server", "runner")
        assert (common.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
        for kind in ("end_to_end", "per_layer"):
            assert cell.metrics(kind)
    for c in bench["configs"]:
        assert (common.ROOT / c["file"]).exists()
        cfg = common.load_json(common.ROOT / c["file"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert c["source"] == cfg["source"]
    for m in bench["per_layer"]:
        assert callable(common.metric_reader(m["name"]).read)


def test_new_cell_is_new_files_only(tmp_path, bench):
    """A later cell: a configuration file, a traffic file, a limits file
    and a metric reader added, and entries appended to BENCHMARK.json;
    the harness finds them, and every file it had is unchanged."""
    root = tmp_path / "repo"
    shutil.copytree(common.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "port_bench").rglob("*") if p.is_file()}
    b = json.loads(json.dumps(bench))
    cfg = common.load_json(common.ROOT / b["configs"][0]["file"])
    cfg["max_generation_size"] = 1024
    (root / "port_bench/configs/parler-long.json").write_text(json.dumps(cfg))
    traffic = common.load_json(common.BENCH_DIR / "traffic/serve_stream_16.json")
    traffic["clients"] = traffic["batch_slots"] = 8
    (root / "port_bench/traffic/serve_stream_8.json").write_text(
        json.dumps(traffic))
    (root / "port_bench/limits/parler.long.json").write_text(
        json.dumps({"logit_gap": 1.0, "audio_err": 0.01}))
    (root / "port_bench/metrics/engine.prefills.py").write_text(
        "def read(run):\n    return None\n")
    b["configs"].append(dict(b["configs"][0], name="parler-long",
                             file="port_bench/configs/parler-long.json"))
    b["workloads"].append({"name": "parler.long", "config": "parler-long",
                           "traffic": "serve_stream_8", "chips": 1,
                           "why": "a later cell"})
    b["per_layer"].append({"name": "engine.prefills", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": b["per_layer"][1]["layer"],
                           "moves": "audio_s_per_wall_s",
                           "workloads": ["parler.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = common.Cell(common.benchmark(root), "parler.long", root)
    assert cell.config["max_generation_size"] == 1024
    assert cell.traffic["clients"] == 8
    assert "engine.prefills" in [m["name"] for m in cell.metrics("per_layer")]
    assert common.metric_reader("engine.prefills",
                                root / "port_bench").read(None) is None
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data
