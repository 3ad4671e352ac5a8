"""Find a cell's parts by name.

``BENCHMARK.json`` (the checkout's root) names the cells, their
configurations and traffic mixes, and the metrics.  Each part is a file
of its own under ``benchmark/``:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names
  ``drivers/<driver>.py``;
- ``workloads/<cell>.json``: what belongs to the cell alone (its work
  count ``work/<work>.py``, the limits of its comparison, the traced
  span);
- ``systems/<model>.py``: the program's side of a configuration's
  ``model``;
- ``metrics/<metric>.py``: one reader a metric;
- ``kernels/<source>.json``: the kernel names of one of the program's
  CUDA sources.

Adding a cell, a mix, a metric or a kernel source adds files and
entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(kind, name, here=HERE):
    """``<here>/<kind>/<name>.py`` as ``benchmark.<kind>.<name>`` (its
    relative imports resolve in this package)."""
    if Path(here) == HERE:
        return importlib.import_module(f"benchmark.{kind}.{name}")
    return _load(Path(here) / kind / f"{name}.py",
                 f"benchmark.{kind}.{name}")


def _reader(name, here=HERE):
    return _load(Path(here) / "metrics" / f"{name}.py",
                 "benchmark.metrics._" + re.sub(r"\W", "_", name))


def applies(metric, cell, e2e_names):
    """Whether ``metric`` (an entry of BENCHMARK.json) is reported in
    ``cell``: its ``workloads``, or every cell that reports the metric it
    moves (end-to-end metrics without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name, root=ROOT, here=HERE):
    """Everything a run of cell ``name`` needs, loaded by name."""
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    here = Path(here)
    own = load_json(here / "workloads" / f"{name}.json")
    cfg = load_json(here / "configs" / f"{entry['config']}.json")
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, name, e2e_names)]
    return SimpleNamespace(
        name=name, entry=entry, own=own, cfg=cfg, traffic=traffic,
        driver=_module("drivers", traffic["driver"], here),
        system=_module("systems", cfg["model"], here),
        work=_module("work", own["work"], here),
        e2e=e2e, per_layer=layer,
        readers={m["name"]: _reader(m["name"], here) for m in e2e + layer})


def kernel_sources(here=HERE):
    """{source name: [kernel names]} of ``kernels/*.json``."""
    return {p.stem: load_json(p)["kernels"]
            for p in sorted((Path(here) / "kernels").glob("*.json"))}
