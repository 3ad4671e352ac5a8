"""Readings that set the limits of a cell's comparison; not run by the
benchmark's own runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 7,8,9] [--faults half_batch:7,8,9] [--seconds 2] \
        [--out chiprun_out/calib_<cell>.json]

For each of ``--seeds``, a run of the cell (``run.run_cell``) with a
window of ``--seconds``: the program's readings (the lower end of each
limit).  For each of ``--control``, the control: the reference in the
program's place at float32 with TF32 matmuls (the precision below the
configuration's float32 with TF32 off), held to the float64 reference
on the same inputs (the upper end).  For each fault and seed, a run with
the fault planted in the timed path.  One process, so the set-up is
paid once a seed.  Prints one JSON line a reading; ``--out`` collects them.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _ints(s):
    return [int(x) for x in s.split(",") if x] if s else []


def control(cell, seed, device="cuda"):
    """The control's readings on the inputs of ``seed``."""
    import random
    from types import SimpleNamespace

    import torch

    from benchmark import data
    run = SimpleNamespace(
        cell=cell, cfg=cell.cfg, traffic=cell.traffic, own=cell.own,
        system=cell.system, device=torch.device(device), seed=seed,
        gen=data.generator(seed, device), rng=random.Random(seed),
        fault=None)
    drv = cell.driver
    st = drv.setup(run)
    if cell.traffic["driver"] == "train":
        for key in ("model", "step"):
            st.pop(key)
        torch.cuda.empty_cache()
        ref = drv.reference_readings(run, st)
        torch.set_float32_matmul_precision("high")
        try:
            ctl = drv.reference_readings(run, st, torch.float32)
        finally:
            torch.set_float32_matmul_precision("highest")
        return drv.compare([x.cpu() for x in ctl], [r.cpu() for r in ref])
    st.pop("request")
    torch.cuda.empty_cache()
    subjects = list(range(min(cell.traffic["sample"],
                              cell.traffic["subjects"])))
    ref = drv.reference_outputs(run, st, subjects)
    torch.set_float32_matmul_precision("high")
    try:
        ctl = drv.reference_outputs(run, st, subjects, torch.float32)
    finally:
        torch.set_float32_matmul_precision("highest")
    return drv.compare(ctl, ref)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from benchmark import registry
    from benchmark.run import run_cell
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def done():
        gc.collect()
        torch.cuda.empty_cache()

    for seed in _ints(args.seeds):
        t = time.perf_counter()
        out = run_cell(registry.cell(args.workload), seed, args.seconds,
                       t_start=time.perf_counter())
        emit({"kind": "program", "seed": seed, "correct": out["correct"],
              "checks": {k: v["value"] for k, v in out["checks"].items()},
              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
              "seconds": time.perf_counter() - t})
        done()
    for seed in _ints(args.control):
        t = time.perf_counter()
        emit({"kind": "control", "seed": seed,
              "checks": control(registry.cell(args.workload), seed),
              "seconds": time.perf_counter() - t})
        done()
    for spec in args.faults.split(";") if args.faults else []:
        fault, seeds = spec.split(":")
        for seed in _ints(seeds):
            out = run_cell(registry.cell(args.workload), seed, args.seconds,
                           fault=fault, t_start=time.perf_counter())
            emit({"kind": "fault", "fault": fault, "seed": seed,
                  "checks": {k: v["value"]
                             for k, v in out["checks"].items()}})
            done()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
