"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s`` from the start of this process) makes the
cell's inputs on the card from the seed, builds or loads the program's
kernels (``interpol_tpu_torch/_build/``, in the checkout) and warms up
the cell's shapes; the window then runs the cell's traffic for
``--seconds``.  With ``--trace 1`` a traced span follows the window and
the per-layer metrics are reported in place of the end-to-end ones.
Once the window has closed and the device's peak memory is read, the
program's state is freed and its results are held to the plain
reference (``reference/``); each number compared is printed beside its
limit as the last lines of standard error and under ``checks``, last in
the result, which is the last line of standard output.

Exits 2, printing no result, without as many CUDA devices as the cell
asks for; 3 if ``jax``, ``jaxlib``, ``flax`` or ``interpol_tpu`` was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "interpol_tpu")
CACHE = ROOT / ".bench_cache"


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def power_limit():
    """The card's ``name, power.limit`` as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


@contextlib.contextmanager
def gc_pauses():
    """Collect the garbage collector's pauses, ``(generation, seconds)``,
    while the block runs."""
    pauses, start = [], [0.0]

    def note(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - start[0]))
    gc.callbacks.append(note)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(note)


def run_cell(cell, seed, seconds, trace=False, device="cuda", fault=None,
             t_start=None):
    """Set up, measure and check one run of ``cell`` (``registry.cell``)
    on ``device``; returns the result line as a dict.  ``fault`` plants
    one of the drivers' faults in the timed path (tests, calibration)."""
    import torch

    from benchmark import data
    from benchmark import trace as tracing
    from benchmark.drivers.common import peak_bytes, reset_peak, sync

    t_start = T_START if t_start is None else t_start
    t_run = time.perf_counter()
    run = SimpleNamespace(
        cell=cell, cfg=cell.cfg, traffic=cell.traffic, own=cell.own,
        system=cell.system, device=torch.device(device), seed=seed,
        gen=data.generator(seed, device), rng=random.Random(seed),
        fault=fault, trace=None, trace_units=0,
        required=cell.work.required(cell.cfg, cell.traffic))
    reset_peak(device)
    state = cell.driver.setup(run)
    sync(device)
    setup_peak = peak_bytes(device)
    # what set-up made lives for the whole run: a collection in the window
    # need not scan it again (the pauses are printed below)
    gc.collect()
    gc.freeze()
    run.setup_s = time.perf_counter() - t_start
    with gc_pauses() as pauses:
        run.window = cell.driver.window(run, state, seconds)
    gc.unfreeze()
    run.window_peak = peak_bytes(device)
    if trace:
        n = cell.traffic["trace_units"]
        run.trace = tracing.profile(
            lambda: cell.driver.span(run, state, n), device)
        run.trace_units = n
    memory_peak = max(setup_peak, run.window_peak, peak_bytes(device))
    names = [m["name"] for m in (cell.per_layer if trace else cell.e2e)]
    units = {m["name"]: m["unit"] for m in cell.e2e + cell.per_layer}
    metrics = {}
    for name in names:
        value = cell.readers[name].read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    t_check = time.perf_counter()
    readings = cell.driver.check(run, state)
    run.check_s = time.perf_counter() - t_check
    limits = cell.own["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()) and set(checks) == set(limits)
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.entry["chips"],
           "memory_peak_bytes": int(memory_peak),
           "power_limit": power_limit() if on_card else "none"}
    out = {"correct": correct, "attempted": run.window["units"],
           "failed": run.window["failed"], "metrics": metrics,
           "device": dev}
    if run.trace is not None:
        dev["busy_s"] = tracing.busy_s(run.trace)
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = tracing.breakdown(run.trace)
    out["checks"] = checks
    print(f"set-up {run.setup_s!r} s, of it before the cell's set-up "
          f"{t_run - t_start!r} s; window {run.window['seconds']!r} s, "
          f"{run.window['units']} units; reference check {run.check_s!r} s",
          file=sys.stderr)
    if pauses:
        print(f"garbage collections in the window: {len(pauses)}, longest "
              f"{max(p for _, p in pauses)!r} s (generation "
              f"{max(pauses, key=lambda g: g[1])[0]})", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's and PyTorch's build caches live in the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import registry
    cell = registry.cell(args.workload)
    print(f"imports {time.perf_counter() - T_START!r} s", file=sys.stderr)

    import torch
    need = int(cell.entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"benchmark: cell {cell.name} needs {need} CUDA device(s), "
              f"found {have}; nothing measured", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"card: {out['device']['kind']}, power limit "
          f"{out['device']['power_limit']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
