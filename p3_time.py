#!/usr/bin/env python3
"""Time P3, one ``svf_train_step`` of the port at 256^3, on one NVIDIA GPU.

    python3 p3_time.py [--root CHECKOUT] [--tag NAME]
                       [--splats | --gathers | --designs | --trace |
                        --lab] [--rows TEXT]

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
``max_disp=4``; cubic C=3, ``max_disp=0``, as P3's Jacobian), the adaptive
push on P8's flow (``tile_spread="auto"``), the push at ``max_disp=8``
(cubic C=1, full window and adaptive, on ``chip_smoke.py``'s flow of that
window, ``tile_spread`` as ``required_tile_spread`` gives it), ``grid_push``
of 1M points in 256^3 (order 1 and cubic) and of P7's 16.7M-point
reslice (cubic), and the scattered pushgrad and pushhess of the 1M points
(cubic), each with the device memory it allocates at its peak (output
included) and a digest of its output (equal digests: equal bits).  ``--designs`` times this tree's splat designs on the same rows
through the wrappers' private keywords (the bits do not depend on them):
the dense push under several site tiles and with no patch, at
``max_disp=4`` and 8, the scattered splat (push at orders 1, 2 and 3,
pushgrad and pushhess at cubic order) direct and by box patches.
``--rows TEXT`` runs only the splat, design or gather rows whose name
holds TEXT, or one of several texts separated by ``|``.  ``--trace`` runs the splat rows under ``torch.profiler`` and
prints each kernel's device time a call (the splat's keep pass, scale,
splat and convert kernels).
``--gathers``
times the gathers the same way: the dense warp at 256^3 (value and
``grid_grad`` at cubic order and at order 1 zero-bound, C=1; linear value
C=3, as P3's squarings; the Hessian at cubic order; value and grad with
P8's adaptive windows, ``tile_spread="auto"``, on P8's flow), and
``grid_pull`` / ``grid_grad`` of 1M random points in 256^3 (order 1 and
cubic) and P7's 16.7M-point affine reslice pull; then the kernels alone,
through their wrappers (``cuda_scattered.gather_cuda`` on the same cloud:
value, grad, hess, value+grad and grad+hess at order 1 and cubic, dct2,
and P7's pull; ``cuda_warp.warp_cuda`` / ``hess_cuda`` on the dense flow:
value, grad and hess at orders 1, 3 and 5, dct2).  ``--gathers`` builds
only the two gather kernels.
``--lab`` times the kernel lab's kernels (``csrc/lab.cu``) through
``ops/lab.py``'s wrappers, each row by its device time
(``torch.profiler``: the kernels a call launches, 20 calls) with its
share of its bound, by one call's time (CUDA events, median of 20; the
host's work in the call included), and with a digest of its output: the
FMA chains of every ``FMA_VARIANTS`` entry (the lab's inputs, numpy seed
0), the bf16 pull at 128^3 and 256^3 (cubic, dct2, ``max_disp=2``,
``lab_case``) beside kernel 1a on the same inputs, the bf16 pull on
``chip_smoke.py``'s lab cases (64^3, three order / bound / mask sets, on
the lab grid and on one that breaks ``max_disp``), and the lane gathers
of every ``GATHER_TABLES`` entry (L2 evicted before each timed call, so
that the table comes from HBM as their bound counts it); a row of
several kernels (the bf16 pull: its pass and the pull) also gives each
kernel's device time.  It builds only ``lab.cu`` and ``warp.cu``.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--tag", default="this tree")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--splats", action="store_true")
    mode.add_argument("--gathers", action="store_true")
    mode.add_argument("--designs", action="store_true")
    mode.add_argument("--trace", action="store_true")
    mode.add_argument("--lab", action="store_true")
    ap.add_argument("--rows", default="")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, args.root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("p3_time: no CUDA device")
    from interpol_tpu_torch import SVFModel, svf_train_step
    from interpol_tpu_torch.ops import _build
    vol, coarse = (256, 256, 256), (8, 8, 8)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if args.gathers:
        for name in ("warp", "gather"):
            _build.load_library(name)
        time_gathers(vol, coarse, args.tag, card, args.rows)
        return
    if args.lab:
        for name in ("lab", "warp"):
            _build.load_library(name)
        time_lab(args.tag, card, args.rows)
        return
    _build.build_all()
    if args.splats or args.designs or args.trace:
        time_splats(vol, coarse, args.tag, card, args.designs, args.rows,
                    args.trace)
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


def l2_evictor():
    """(evict, keys): ``evict()`` reads 200 MiB, four times the card's L2,
    so that the next call reads its inputs from HBM; ``keys``, its kernels'
    profiler keys.  Its own copy of ``ops/lab.py::l2_evictor``."""
    import torch
    # row sums: each block reduces its own rows, so no semaphore memset
    buf = torch.ones((50 * 2**10, 1024), device="cuda")

    def evict():
        buf.sum(1)
    # the keys of three traces: a trace now and then lacks a record
    keys = set()
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            evict()
            torch.cuda.synchronize()
        keys |= {e.key for e in prof.key_averages()
                 if e.device_time_total > 0}
    if not keys:
        raise RuntimeError("l2_evictor: the profiler traced no launch")
    return evict, keys


def cuda_ms(fn, reps=20, cold=False):
    """Median of ``reps`` CUDA-event timings after one warm-up call;
    ``cold``: L2 evicted before each (:func:`l2_evictor`)."""
    import torch
    evict = l2_evictor()[0] if cold else None
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if evict:
            evict()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls=20, by_kernel=None, cold=False):
    """The device time in ms of one call of ``fn``: the kernels and copies
    it launches (``torch.profiler``) over ``calls`` calls after two
    warm-up calls, each kernel's mean duration a launch times its launches
    a call (a trace now and then lacks some records); nan when five traces
    hold none.  ``by_kernel``: a dict that receives each kernel's share.
    ``cold``: L2 evicted before each call (its kernels left out).  Its own
    copy of ``ops/lab.py::device_ms``: the checkout under ``--root`` may
    predate that one."""
    import torch
    evict, skip = l2_evictor() if cold else (None, set())
    for _ in range(2):
        fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if evict:
                    evict()
                fn()
            torch.cuda.synchronize()
        ms = {e.key: e.device_time_total / e.count
              * max(1, round(e.count / calls)) / 1e3
              for e in prof.key_averages()
              if e.device_time_total > 0 and e.key not in skip}
        if ms:
            if by_kernel is not None:
                by_kernel.update(ms)
            return sum(ms.values())
    return float("nan")


def trace_kernels(label, fn, card, calls=10):
    """The device time per call of each kernel that ``fn`` launches,
    heaviest first (``torch.profiler`` over ``calls`` calls after three
    warm-up calls)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
        if e.device_time_total > 0:
            print(f"trace {label}: {e.key[:70]} "
                  f"{e.device_time_total / calls:.1f} us a call "
                  f"({e.count // calls} launches) [{card}]", flush=True)


def wanted(name, only):
    """Whether row ``name`` holds one of the ``|``-separated texts."""
    return any(t in name for t in only.split("|"))


def digest(out):
    """The first 16 hex digits of the sha256 of a tensor's bytes: equal
    digests of two checkouts' outputs are equal bits."""
    import hashlib
    return hashlib.sha256(out.detach().cpu().numpy().tobytes()).hexdigest(
    )[:16]


def peak_mib(fn):
    """Device memory in MiB that ``fn`` allocates at its peak beyond the
    live tensors (its output included)."""
    import torch
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - live) / 2**20


def time_splats(vol, coarse, tag, card, designs=False, only="",
                trace=False):
    import math
    import numpy as np
    import torch
    from interpol_tpu_torch import (WarpModel, affine_grid, grid_push,
                                    required_tile_spread)
    from interpol_tpu_torch.ops import cuda_scattered, cuda_warp
    from interpol_tpu_torch.ops.scattered import pushgrad_scattered
    from interpol_tpu_torch.ops.window import push_window, pushgrad_window
    model = WarpModel(vol_shape=vol, coarse_shape=coarse, interpolation=3,
                      bound="dct2", max_disp=4.0, device="cuda")
    model.load_jax_params(0.5 * np.random.default_rng(0).standard_normal(
        (1,) + coarse + (3,)))
    p8 = WarpModel(vol_shape=vol, coarse_shape=coarse, interpolation=3,
                   bound="dct2", max_disp=4.0, tile_spread="auto",
                   device="cuda")
    p8.load_jax_params(np.full((1,) + coarse + (3,), 0.01))
    sp = p8.auto_tile_spread()
    # chip_smoke.py's max_disp=8 flow
    m8 = WarpModel(vol_shape=vol, coarse_shape=coarse, interpolation=3,
                   bound="dct2", max_disp=8.0, tile_spread="auto",
                   device="cuda")
    m8.load_jax_params(0.5 * np.random.default_rng(0).standard_normal(
        (1,) + coarse + (3,)))
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        flow = model.dense_flow().contiguous()
        flow8 = p8.dense_flow().contiguous()
        wide = m8.dense_flow().contiguous()
        sp8 = tuple(required_tile_spread(wide))
        ident = model.dense_flow(torch.zeros_like(model.params)) \
            .contiguous()
        # P7: 10 degrees about the centre (axes 0, 1), 2 voxels along x
        c, t = (vol[0] - 1) / 2, math.radians(10.0)
        rot = np.array([[math.cos(t), -math.sin(t), 0],
                        [math.sin(t), math.cos(t), 0], [0, 0, 1]])
        mat = np.eye(4)
        mat[:3, :3] = rot
        mat[:3, 3] = np.full(3, c) - rot @ np.full(3, c) + [2, 0, 0]
        reslice = affine_grid(torch.tensor(mat, dtype=torch.float32,
                                           device="cuda"), vol)
        v1 = torch.randn((1, 1) + vol, device="cuda", generator=gen)
        v3 = torch.randn((1, 3) + vol, device="cuda", generator=gen)
        g1 = torch.randn((1, 1) + vol + (3,), device="cuda", generator=gen)
        g3 = torch.randn((1, 3) + vol + (3,), device="cuda", generator=gen)
        rng = np.random.default_rng(0)
        pts = torch.tensor(rng.uniform(0, vol[0] - 1, (1_000_000, 1, 1, 3))
                           .astype(np.float32), device="cuda")
        vals = torch.randn((1, 1_000_000, 1, 1), device="cuda",
                           generator=gen)
        v7 = torch.randn((1, 1) + vol, device="cuda", generator=gen)
        cloud = pts.reshape(1, -1, 3)
        c3 = torch.randn((1, 1, 1_000_000, 3), device="cuda", generator=gen)
        c33 = torch.randn((1, 1, 1_000_000, 3, 3), device="cuda",
                          generator=gen)
        cubic = dict(interpolation=3, bound="dct2", extrapolate=True)
        o3 = ((3,) * 3, (3,) * 3, 1)
        if designs:
            time_designs(v1, v3, flow, vals, cloud, v7, reslice, tag, card,
                         flow8, sp, wide, sp8, c3, c33, only)
            return
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
                vals, pts, shape=vol, **cubic)),
            (f"push_ad cubic C=1 P8 flow spread {sp}", lambda: push_window(
                v1, flow8, *o3, 4.0, sp)),
            ("push cubic C=1 max_disp 8", lambda: grid_push(
                v1, wide, max_disp=8.0, **cubic)),
            (f"push_ad cubic C=1 max_disp 8 spread "
             f"{tuple(round(x, 4) for x in sp8)}",
             lambda: push_window(v1, wide, *o3, 8.0, sp8)),
            ("sc_pushgrad 1M points cubic", lambda: pushgrad_scattered(
                c3[0], cloud[0], vol, *o3)),
            ("sc_pushhess 1M points cubic",
             lambda: cuda_scattered.splat_cuda(c33, cloud, vol, *o3,
                                               spec="pushhess")),
            ("P7 reslice sc_push 16.7M points cubic", lambda: grid_push(
                v7, reslice, shape=vol, interpolation=3, bound="dct2"))]
        for name, fn in rows:
            if not wanted(name, only):
                continue
            if trace:
                trace_kernels(f"splat {name} 256^3 [{tag}]", fn, card)
                continue
            ms = cuda_ms(fn)
            print(f"splat {name} 256^3 [{tag}]: {ms:.3f} ms (median of 20), "
                  f"peak +{peak_mib(fn):.0f} MiB, output sha256 "
                  f"{digest(fn())} [{card}]", flush=True)


def time_designs(v1, v3, flow, vals, cloud, v7, reslice, tag, card, flow8,
                 sp, wide, sp8, c3, c33, only=""):
    """The dense push under several site tiles and with no patch (tile (0,
    0, 0)): at ``max_disp=4`` cubic C=1, linear C=3 (P3's squarings) and
    C=1 on P2's flow, and the adaptive push on P8's flow; at
    ``max_disp=8`` (span 19, no tile's patch within 56 KB) cubic C=1, full
    window and adaptive, on the wide flow.  The scattered splat direct and
    by box patches (8^3, 16^3) on 1M random points (push at orders 1, 2
    and 3, pushgrad and pushhess at cubic order) and on P7's 16.7M ordered
    ones (cubic)."""
    import torch
    from interpol_tpu_torch.ops import cuda_scattered, cuda_warp
    vol = tuple(v1.shape[2:])
    rows = []
    for order, inp in ((3, v1), (1, v3), (1, v1)):
        opts = ((order,) * 3, (3,) * 3, 1, 4.0)
        for tile in (None, (4, 8, 8), (8, 8, 8), (4, 8, 16), (8, 16, 16),
                     (0, 0, 0)):
            rows.append((f"push order {order} C={inp.shape[1]} tile "
                         f"{tile or 'default'}",
                         lambda i=inp, o=opts, t=tile: cuda_warp.push_cuda(
                             i, flow, *o, tile=t)))
    ad = ((3,) * 3, (3,) * 3, 1, 4.0, sp)
    for tile in (None, (4, 8, 8), (0, 0, 0)):
        rows.append((f"push_ad cubic C=1 P8 flow spread {sp} tile "
                     f"{tile or 'default'}",
                     lambda t=tile: cuda_warp.push_cuda(v1, flow8, *ad,
                                                        tile=t)))
    o8 = ((3,) * 3, (3,) * 3, 1, 8.0)
    for spread, tiles in ((None, ((4, 4, 4), (2, 8, 8), (4, 4, 8),
                                  (4, 8, 8), (8, 8, 8), (4, 8, 16))),
                          (sp8, ((4, 4, 4), (4, 4, 8), (4, 8, 8),
                                 (8, 8, 8)))):
        for tile in (None,) + tiles + ((0, 0, 0),):
            rows.append((f"push{'_ad' if spread else ''} cubic C=1 max_disp "
                         f"8 tile {tile or 'default'}",
                         lambda s=spread, t=tile: cuda_warp.push_cuda(
                             v1, wide, *o8, s, tile=t)))
    p7 = reslice.reshape(1, -1, 3).contiguous()
    v7 = v7.reshape(1, 1, -1)
    vv1 = vals.reshape(1, 1, -1)
    for name, pts, vv, orders, spec in (
            ("1M points order 1", cloud, vv1, 1, "push"),
            ("1M points order 2", cloud, vv1, 2, "push"),
            ("1M points cubic", cloud, vv1, 3, "push"),
            ("1M points cubic pushgrad", cloud, c3, 3, "pushgrad"),
            ("1M points cubic pushhess", cloud, c33, 3, "pushhess"),
            ("P7 16.7M points cubic", p7, v7, 3, "push")):
        for box in (False, (8, 8, 8), (16, 16, 16), None):
            rows.append((f"sc_push {name} box {box} (False: direct, None: "
                         f"default)",
                         lambda p=pts, v=vv, o=orders, b=box, k=spec:
                         cuda_scattered.splat_cuda(
                             v, p, vol, (o,) * 3, (3,) * 3, 1, spec=k,
                             box=b)))
    with torch.no_grad():
        for name, fn in rows:
            if not wanted(name, only):
                continue
            ms = cuda_ms(fn)
            print(f"design {name} 256^3 [{tag}]: {ms:.3f} ms (median of "
                  f"20), peak +{peak_mib(fn):.0f} MiB [{card}]", flush=True)


def time_gathers(vol, coarse, tag, card, only=""):
    import math
    import numpy as np
    import torch
    from interpol_tpu_torch import WarpModel, affine_grid, grid_grad, \
        grid_pull
    from interpol_tpu_torch.ops import cuda_scattered, cuda_warp
    from interpol_tpu_torch.ops.window import hess_window
    model = WarpModel(vol_shape=vol, coarse_shape=coarse, interpolation=3,
                      bound="dct2", max_disp=4.0, device="cuda")
    model.load_jax_params(0.5 * np.random.default_rng(0).standard_normal(
        (1,) + coarse + (3,)))
    p8 = WarpModel(vol_shape=vol, coarse_shape=coarse, interpolation=3,
                   bound="dct2", max_disp=4.0, tile_spread="auto",
                   device="cuda")
    p8.load_jax_params(np.full((1,) + coarse + (3,), 0.01))
    sp = p8.auto_tile_spread()
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        flow = model.dense_flow().contiguous()
        flow8 = p8.dense_flow().contiguous()
        v1 = torch.randn((1, 1) + vol, device="cuda", generator=gen)
        v3 = torch.randn((1, 3) + vol, device="cuda", generator=gen)
        rng = np.random.default_rng(0)
        pts = torch.tensor(rng.uniform(0, vol[0] - 1, (1_000_000, 1, 1, 3))
                           .astype(np.float32), device="cuda")
        # P7: 10 degrees about the centre (axes 0, 1), 2 voxels along x
        c, t = (vol[0] - 1) / 2, math.radians(10.0)
        rot = np.array([[math.cos(t), -math.sin(t), 0],
                        [math.sin(t), math.cos(t), 0], [0, 0, 1]])
        mat = np.eye(4)
        mat[:3, :3] = rot
        mat[:3, 3] = np.full(3, c) - rot @ np.full(3, c) + [2, 0, 0]
        reslice = affine_grid(torch.tensor(mat, dtype=torch.float32,
                                           device="cuda"), vol)
        cubic = dict(interpolation=3, bound="dct2", extrapolate=True)
        lin0 = dict(interpolation=1, bound="zero", extrapolate=True)
        ad = dict(max_disp=4.0, tile_spread=sp, **cubic)
        rows = [
            ("value cubic C=1", lambda: grid_pull(v1, flow, max_disp=4.0,
                                                   **cubic)),
            ("grad cubic C=1", lambda: grid_grad(v1, flow, max_disp=4.0,
                                                  **cubic)),
            ("value order 1 zero C=1", lambda: grid_pull(
                v1, flow, max_disp=4.0, **lin0)),
            ("grad order 1 zero C=1", lambda: grid_grad(
                v1, flow, max_disp=4.0, **lin0)),
            ("value linear C=3", lambda: grid_pull(
                v3, flow, interpolation=1, bound="dct2", extrapolate=True,
                max_disp=4.0)),
            ("hess cubic C=1", lambda: hess_window(
                v1, flow, (3,) * 3, (3,) * 3, 1, 4.0)),
            (f"value_ad cubic C=1 P8 flow spread {sp}", lambda: grid_pull(
                v1, flow8, **ad)),
            (f"grad_ad cubic C=1 P8 flow spread {sp}", lambda: grid_grad(
                v1, flow8, **ad)),
            ("sc_value 1M points order 1", lambda: grid_pull(
                v1, pts, interpolation=1, bound="dct2", extrapolate=True)),
            ("sc_grad 1M points order 1", lambda: grid_grad(
                v1, pts, interpolation=1, bound="dct2", extrapolate=True)),
            ("sc_value 1M points cubic", lambda: grid_pull(v1, pts,
                                                           **cubic)),
            ("sc_grad 1M points cubic", lambda: grid_grad(v1, pts,
                                                          **cubic)),
            ("P7 reslice pull 16.7M points cubic", lambda: grid_pull(
                v1, reslice, 3, "dct2"))]
        cloud = pts.reshape(1, -1, 3)
        for order in (1, 3):
            for mode in ("value", "grad", "hess", "value+grad",
                         "grad+hess"):
                flags = {f: f in mode.split("+")
                         for f in ("value", "grad", "hess")}
                rows.append((
                    f"kernel sc_{mode} 1M points order {order}",
                    lambda o=order, f=flags: cuda_scattered.gather_cuda(
                        v1, cloud, (o,) * 3, (3,) * 3, 1, **f)))
        p7 = reslice.reshape(1, -1, 3).contiguous()
        rows.append(("kernel sc_value P7 16.7M points cubic",
                     lambda: cuda_scattered.gather_cuda(
                         v1, p7, (3,) * 3, (3,) * 3, 0)))
        for order in (1, 3, 5):
            opts = ((order,) * 3, (3,) * 3, 1, 4.0)
            rows += [
                (f"kernel value order {order}",
                 lambda o=opts: cuda_warp.warp_cuda(v1, flow, *o)),
                (f"kernel grad order {order}",
                 lambda o=opts: cuda_warp.warp_cuda(v1, flow, *o,
                                                    value=False,
                                                    grad=True)),
                (f"kernel hess order {order}",
                 lambda o=opts: cuda_warp.hess_cuda(v1, flow, *o))]
        for name, fn in rows:
            if not wanted(name, only):
                continue
            print(f"gather {name} 256^3 [{tag}]: {cuda_ms(fn):.3f} ms "
                  f"(median of 20) [{card}]", flush=True)


def lab_inputs():
    """The lab rows' inputs, made alike in every checkout: per FMA variant
    (a, b) from numpy seed 0 as ``lab.fma_probe`` makes them; the pull
    cases; the gather tables and indices as ``lab.gather_probe``."""
    import numpy as np
    import torch
    from interpol_tpu_torch.ops import lab
    fmas = {}
    for v, (shape, reps, nacc, dtype, zero) in lab.FMA_VARIANTS.items():
        rng = np.random.default_rng(0)
        a, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                             device="cuda") for _ in range(2))
        fmas[v] = (a, b, reps, nacc, dtype, zero)
    pulls = {N: lab.lab_case(N, 2.0, "cuda") for N in (128, 256)}
    # chip_smoke.py's phase_lab_kernels: 64^3, seed 3, and the same grid
    # with a fifth of its x coordinates moved by 3 (past max_disp)
    vol, grid = lab.lab_case(64, 2.0, "cuda", seed=3)
    wild = grid.clone()
    wild[..., 0] += 3.0 * (torch.rand(grid.shape[:-1], device="cuda",
                                      generator=torch.Generator("cuda")
                                      .manual_seed(4)) < 0.2)
    cases = [(orders, bounds, ex, name, vol, g)
             for orders, bounds, ex in [((3, 3, 3), (3, 3, 3), 1),
                                        ((0, 1, 2), (5, 0, 6), 0),
                                        ((3, 2, 1), (2, 4, 3), 2)]
             for name, g in (("contract", grid), ("broken", wild))]
    gathers = {}
    for t, (G, S, T, L, r, smem) in lab.GATHER_TABLES.items():
        gen = torch.Generator("cuda").manual_seed(0)
        tbl = torch.randn((G, S, T), generator=gen, device="cuda")
        idx = torch.randint(0, T, (G, S, L), generator=gen, device="cuda",
                            dtype=torch.int32)
        gathers[t] = (tbl, idx, r, smem)
    return fmas, pulls, cases, gathers


def fma_bound_ms(a, reps, dtype):
    """The FMA rows' bound: 2 reps operations an element at the card's
    peak for the chain's type (a, b read and the output written once take
    less)."""
    import torch
    from interpol_tpu_torch.ops import lab
    rate = lab.BF16_OPS_PER_S if dtype == torch.bfloat16 \
        else lab.FP32_OPS_PER_S
    return max(2 * a.numel() * reps / rate, 12 * a.numel()
               / lab.HBM_BYTES_PER_S) * 1e3


def pull_bound_ms(vol):
    """Bytes: the volume, the grid and the output once (float32)."""
    from interpol_tpu_torch.ops import lab
    return 4 * 5 * vol.numel() / lab.HBM_BYTES_PER_S * 1e3


def time_lab(tag, card, only=""):
    import torch
    from interpol_tpu_torch.ops import lab
    from interpol_tpu_torch.ops.cuda_warp import warp_cuda
    fmas, pulls, cases, gathers = lab_inputs()
    cubic = ((3,) * 3, (3,) * 3, 1, 2.0)
    rows = []
    for v, (a, b, reps, nacc, dtype, zero) in fmas.items():
        rows.append((f"fma {v}", lambda a=a, b=b, r=reps, n=nacc, d=dtype,
                     z=zero: lab.fma(a, b, r, n, d, z),
                     fma_bound_ms(a, reps, dtype)))
    for N, (vol, grid) in pulls.items():
        rows += [(f"pull_bf16 {N}^3 cubic dct2 max_disp 2",
                  lambda v=vol, g=grid: lab.pull_bf16(v, g, *cubic),
                  pull_bound_ms(vol)),
                 (f"kernel 1a {N}^3 cubic dct2 max_disp 2",
                  lambda v=vol, g=grid: warp_cuda(v, g, *cubic)[0],
                  pull_bound_ms(vol))]
    for orders, bounds, ex, name, vol, g in cases:
        rows.append((f"pull_bf16 64^3 orders {orders} bounds {bounds} "
                     f"extrapolate {ex} {name} grid",
                     lambda v=vol, g=g, o=(orders, bounds, ex, 2.0):
                     lab.pull_bf16(v, g, *o), pull_bound_ms(vol)))
    for t, (tbl, idx, r, smem) in gathers.items():
        n = idx.numel()
        rows.append((f"gather {t}", lambda tb=tbl, i=idx, r=r, s=smem:
                     lab.gather(tb, i, r, s),
                     4 * (tbl.numel() + 2 * n) / lab.HBM_BYTES_PER_S * 1e3))
    with torch.no_grad():
        for name, fn, bound in rows:
            if not wanted(name, only):
                continue
            parts = {}
            # the gathers' tables come from HBM, as their bound counts them
            cold = name.startswith("gather ")
            # nan: not measured
            dev = device_ms(fn, by_kernel=parts, cold=cold)
            ms = cuda_ms(fn, cold=cold)
            extra = ""
            if len(parts) > 1:      # the bf16 pull's pass and pull
                extra = " (" + ", ".join(
                    f"{(re.search(r'[A-Za-z0-9_]+_kernel', k) or [k])[0]} "
                    f"{v:.4f}" for k, v in sorted(parts.items())) + ")"
            print(f"lab {name} [{tag}]: device {dev:.4f} ms"
                  f"{' (L2 evicted before each call)' if cold else ''}, bound "
                  f"{bound:.4f} ms, {100 * bound / dev:.1f} % of it; a call "
                  f"{ms:.4f} ms (events, median of 20){extra}, output "
                  f"sha256 {digest(fn())} [{card}]", flush=True)


if __name__ == "__main__":
    main()
