"""Cells, configurations, traffic, drivers, metrics and kernel lists are
found by name: a new one is new files and entries, with no edit."""
import json
import shutil
from pathlib import Path

from benchmark import registry

ROOT = Path(__file__).resolve().parents[2]


def test_the_cells_of_benchmark_json_load():
    for w in registry.benchmark()["workloads"]:
        cell = registry.cell(w["name"])
        assert cell.driver.__name__.endswith("." + cell.traffic["driver"])
        assert callable(cell.work.required)


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    # a traffic mix (data only), a cell, a driver, a metric, a kernel list
    mix = json.loads((here / "traffic" / "train16.json").read_text())
    mix.update(batch=8, driver="train_copy")
    (here / "traffic" / "train8.json").write_text(json.dumps(mix))
    shutil.copy(here / "drivers" / "train.py",
                here / "drivers" / "train_copy.py")
    (here / "workloads" / "ffd_oasis.train8.json").write_text(
        (here / "workloads" / "ffd_oasis.train16.json").read_text())
    (here / "metrics" / "new_metric.train8.py").write_text(
        "def read(run):\n    return 42.0\n")
    (here / "kernels" / "newsrc.json").write_text(
        json.dumps({"source": "csrc/new.cu", "kernels": ["new_kernel"]}))
    bench["workloads"].append({"name": "ffd_oasis.train8",
                               "config": "ffd_oasis", "traffic": "train8",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "new_metric.train8", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "kernels", "moves": "step_ms",
        "workloads": ["ffd_oasis.train8"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ffd_oasis.train16" in m["workloads"]:
            m["workloads"].append("ffd_oasis.train8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell("ffd_oasis.train8", root=root, here=here)
    assert cell.traffic["batch"] == 8
    assert cell.driver.__file__ == str(here / "drivers" / "train_copy.py")
    assert cell.readers["new_metric.train8"].read(None) == 42.0
    assert "step_ms" in cell.readers
    assert registry.kernel_sources(here)["newsrc"] == ["new_kernel"]
    after = {p.relative_to(here): p.read_bytes()
             for p in here.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)
