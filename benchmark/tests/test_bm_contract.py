"""BENCHMARK.json and the result line against the benchmark's contract."""
import json
import re
import statistics  # noqa: F401  (the spread rule names its quartiles)
from pathlib import Path

import pytest

from benchmark import registry
from benchmark.run import run_cell
from benchmark.tests._tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and cmd[1].startswith(BENCH["paths"][0])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200
    for group in (names, [w["name"] for w in BENCH["workloads"]],
                  [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        e2e = {m["name"] for m in cell.e2e}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_files_of_each_cell_exist_and_match():
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        assert set(cell.readers) == {m["name"]
                                     for m in cell.e2e + cell.per_layer}
        assert cell.cfg["name"] == w["config"]
        assert cell.system.KIND == cell.cfg["model"]
        assert cell.own["limits"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    out = run_cell(tiny_cell("ffd_oasis.train16"), 3, 0.2, trace=trace,
                   device="cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    assert list(out)[-1] == "checks"
    for k, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)
