#!/usr/bin/env python3
"""Time P3, one ``svf_train_step`` of the port at 256^3, on one NVIDIA GPU.

    python3 p3_time.py [--root CHECKOUT] [--tag NAME] [--splats]

The configuration is ``chip_smoke.py``'s P3: ``SVFModel(256^3, coarse
8^3, cubic, dct2, max_disp=4, steps=6)``, parameters 0.5 N(0,1) (numpy
seed 0), moving N(0,1) (seed 0), fixed 0.9 moving, ``jac_weight=0.1``.
Prints one line: the median of 5 CUDA-event timings after a warm-up, the
device memory the step allocates at its peak beyond the live tensors, and
the card's name and power limit.  ``--root`` imports ``interpol_tpu_torch``
from another checkout, so that two versions can be compared in turns on
one card (only public names are used).  ``--splats`` times instead the
splats that P3 and the scattered paths run, through the public functions
(median of 20): the dense push at 256^3 (cubic and order 1 zero-bound C=1,
linear C=3, as P3's squarings, ``max_disp=4``), pushgrad (cubic C=1,
``max_disp=4``; cubic C=3, ``max_disp=0``, as P3's Jacobian) and
``grid_push`` of 1M points in 256^3 (order 1 and cubic).
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
    ap.add_argument("--splats", action="store_true")
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if args.splats:
        time_splats(vol, coarse, args.tag, card)
        return
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
    print(f"P3 svf_train_step 256^3 [{args.tag}]: median "
          f"{statistics.median(times):.3f} ms of 5 "
          f"({', '.join(f'{t:.3f}' for t in times)}), peak +{peak:.0f} MiB "
          f"[{card}]", flush=True)


def cuda_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_splats(vol, coarse, tag, card):
    import numpy as np
    import torch
    from interpol_tpu_torch import WarpModel, grid_push
    from interpol_tpu_torch.ops.window import pushgrad_window
    model = WarpModel(vol_shape=vol, coarse_shape=coarse, interpolation=3,
                      bound="dct2", max_disp=4.0, device="cuda")
    model.load_jax_params(0.5 * np.random.default_rng(0).standard_normal(
        (1,) + coarse + (3,)))
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        flow = model.dense_flow().contiguous()
        ident = model.dense_flow(torch.zeros_like(model.params)) \
            .contiguous()
        v1 = torch.randn((1, 1) + vol, device="cuda", generator=gen)
        v3 = torch.randn((1, 3) + vol, device="cuda", generator=gen)
        g1 = torch.randn((1, 1) + vol + (3,), device="cuda", generator=gen)
        g3 = torch.randn((1, 3) + vol + (3,), device="cuda", generator=gen)
        rng = np.random.default_rng(0)
        pts = torch.tensor(rng.uniform(0, vol[0] - 1, (1_000_000, 1, 1, 3))
                           .astype(np.float32), device="cuda")
        vals = torch.randn((1, 1_000_000, 1, 1), device="cuda",
                           generator=gen)
        cubic = dict(interpolation=3, bound="dct2", extrapolate=True)
        rows = [
            ("push cubic C=1", lambda: grid_push(v1, flow, max_disp=4.0,
                                                  **cubic)),
            ("push order 1 zero C=1", lambda: grid_push(
                v1, flow, interpolation=1, bound="zero", extrapolate=True,
                max_disp=4.0)),
            ("push linear C=3", lambda: grid_push(
                v3, flow, interpolation=1, bound="dct2", extrapolate=True,
                max_disp=4.0)),
            ("pushgrad cubic C=1", lambda: pushgrad_window(
                g1, flow, (3,) * 3, (3,) * 3, 1, 4.0)),
            ("pushgrad cubic C=3 max_disp 0", lambda: pushgrad_window(
                g3, ident, (3,) * 3, (3,) * 3, 1, 0.0)),
            ("sc_push 1M points order 1", lambda: grid_push(
                vals, pts, shape=vol, interpolation=1, bound="dct2",
                extrapolate=True)),
            ("sc_push 1M points cubic", lambda: grid_push(
                vals, pts, shape=vol, **cubic))]
        for name, fn in rows:
            print(f"splat {name} 256^3 [{tag}]: {cuda_ms(fn):.3f} ms "
                  f"(median of 20) [{card}]", flush=True)


if __name__ == "__main__":
    main()
