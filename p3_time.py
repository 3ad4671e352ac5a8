#!/usr/bin/env python3
"""Time P3, one ``svf_train_step`` of the port at 256^3, on one NVIDIA GPU.

    python3 p3_time.py [--root CHECKOUT] [--tag NAME]

The configuration is ``chip_smoke.py``'s P3: ``SVFModel(256^3, coarse
8^3, cubic, dct2, max_disp=4, steps=6)``, parameters 0.5 N(0,1) (numpy
seed 0), moving N(0,1) (seed 0), fixed 0.9 moving, ``jac_weight=0.1``.
Prints one line: the median of 5 CUDA-event timings after a warm-up, the
device memory the step allocates at its peak beyond the live tensors, and
the card's name and power limit.  ``--root`` imports ``interpol_tpu_torch``
from another checkout, so that two versions can be compared in turns on
one card (only public names are used).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, args.root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("p3_time: no CUDA device")
    from interpol_tpu_torch import SVFModel, svf_train_step
    from interpol_tpu_torch.ops import _build
    _build.build_all()
    vol, coarse = (256, 256, 256), (8, 8, 8)
    rng = np.random.default_rng(0)
    moving = torch.tensor(rng.standard_normal((1, 1) + vol),
                          dtype=torch.float32, device="cuda")
    fixed = 0.9 * moving
    svf = SVFModel(vol_shape=vol, coarse_shape=coarse, interpolation=3,
                   bound="dct2", max_disp=4.0, steps=6, device="cuda")
    svf.load_jax_params(0.5 * np.random.default_rng(0).standard_normal(
        (1,) + coarse + (3,)))

    def step():
        return svf_train_step(svf, moving, fixed, jac_weight=0.1)
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - live) / 2**20
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"P3 svf_train_step 256^3 [{args.tag}]: median "
          f"{statistics.median(times):.3f} ms of 5 "
          f"({', '.join(f'{t:.3f}' for t in times)}), peak +{peak:.0f} MiB "
          f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
