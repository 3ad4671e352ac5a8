"""No module the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program; without a card the measuring
path fails and prints no result."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_compares_whole_top_level_names():
    assert forbidden_modules(["interpol_tpu_torch", "interpol_tpu_torch.ops",
                              "jaxtyping", "benchmark"]) == []
    assert forbidden_modules(["jax.numpy", "interpol_tpu.ops", "flax",
                              "jaxlib"]) == ["flax", "interpol_tpu.ops",
                                             "jax.numpy", "jaxlib"]


def test_what_run_loads_holds_no_jax():
    names = _modules(
        "import json, sys\n"
        "import benchmark.run as r, benchmark.calibrate\n"
        "from benchmark import registry, trace, readings\n"
        "for w in registry.benchmark()['workloads']:\n"
        "    registry.cell(w['name'])\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert "interpol_tpu_torch" in names
    assert not {n for n in names if n.split(".")[0] in FORBIDDEN}


def test_the_reference_loads_nothing_of_the_program():
    names = _modules(
        "import json, sys\n"
        "import benchmark.reference.models, benchmark.reference.ops\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"interpol_tpu_torch", "interpol_tpu", "jax",
                       "jaxlib", "flax"}
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("torch", "numpy", "math",
                                           "itertools", "__future__"), m


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ffd_oasis.train16", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr
