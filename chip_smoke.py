#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's forward path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and the exit code is not 0):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   with no CUDA device the script stops here (there is no CPU run);
2. build the kernels from ``interpol_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, float32,
   over orders, bounds, extrapolation modes, odd shapes, a per-axis
   ``max_disp``, 1-D / 2-D warps and a grid that breaks the ``max_disp``
   contract; and the small registration model on the card against the
   same model on the CPU;
4. the main path: ``WarpModel`` at 256^3 (coarse 8^3, cubic, dct2,
   ``max_disp=4``) and ``grid_grad`` at 256^3, with the launch counts,
   agreement with the plain path, and times and peak memory of kernel
   and plain paths beside the card's name and power limit.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from interpol_tpu_torch import WarpModel, grid_grad
from interpol_tpu_torch.ops import _build, cuda_warp, ndkernels
from interpol_tpu_torch.ops.window import _grad_impl_torch, _pull_impl_torch

# kernel vs plain: float32 sums of at most 512 non-zero taps taken in
# another order; the JAX package's float32 parity gate is 1e-5 too
TOL = 1e-5
MAIN_VOL, MAIN_COARSE = (256, 256, 256), (8, 8, 8)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(out: torch.Tensor, ref: torch.Tensor):
    """(max |out - ref|, the tolerance it is held to)."""
    err = (out.double() - ref.double()).abs().max().item()
    return err, TOL * max(1.0, ref.abs().max().item())


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls."""
    for _ in range(warmup):
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


def peak_mib(fn) -> float:
    """Device memory ``fn`` allocates at its peak beyond what was live."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - live) / 2**20


def warp_case(B, C, ishape, disp, seed, break_contract=0.0):
    """Random volume and grid = identity + uniform(-disp, disp); with
    ``break_contract`` a fifth of the displacements are scaled by it."""
    rng = np.random.default_rng(seed)
    D = len(ishape)
    inp = rng.standard_normal((B, C) + tuple(ishape))
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ishape],
                                 indexing="ij"), -1)
    d = rng.uniform(-1, 1, (B,) + tuple(ishape) + (D,)) * np.asarray(disp)
    if break_contract:
        d = d * np.where(rng.uniform(size=d.shape) < 0.2, break_contract,
                         1.0)
    cuda = dict(dtype=torch.float32, device="cuda")
    return torch.tensor(inp, **cuda), torch.tensor(ident + d, **cuda)


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA GPU")
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_kernels(errs) -> None:
    """Kernel vs plain on the card, value and grad, every template mode."""
    def check(tag, inp, grid, orders, bounds, ex, md):
        val, grad = cuda_warp.warp_cuda(inp, grid, orders, bounds, ex, md,
                                        value=True, grad=True)
        v1, _ = cuda_warp.warp_cuda(inp, grid, orders, bounds, ex, md,
                                    value=True, grad=False)
        _, g1 = cuda_warp.warp_cuda(inp, grid, orders, bounds, ex, md,
                                    value=False, grad=True)
        torch.cuda.synchronize()
        if not (torch.equal(val, v1) and torch.equal(grad, g1)):
            raise AssertionError(f"{tag}: fused and single modes differ")
        ev, tv = rel_err(val, _pull_impl_torch(inp, grid, orders, bounds,
                                               ex, md))
        eg, tg = rel_err(grad, _grad_impl_torch(inp, grid, orders, bounds,
                                                ex, md))
        errs["value"] = max(errs["value"], ev)
        errs["grad"] = max(errs["grad"], eg)
        if not (ev <= tv and eg <= tg):
            raise AssertionError(f"{tag}: value err {ev:.3g} (tol "
                                 f"{tv:.3g}), grad err {eg:.3g} (tol "
                                 f"{tg:.3g})")
        return val, ev, eg

    n = 0
    worst = (0.0, 0.0)
    for o in (0, 1, 2, 3, 5, 7):
        for b in range(7):
            ex = (o + b) % 3
            inp, grid = warp_case(1, 2, (12, 13, 20), 1.5, 10 * o + b)
            _, ev, eg = check(f"order {o} bound {b} ex {ex}", inp, grid,
                              (o,) * 3, (b,) * 3, ex, 1.5)
            worst = (max(worst[0], ev), max(worst[1], eg))
            n += 1
    log(f"kernel vs plain: orders 0,1,2,3,5,7 x bounds 0-6 x extrapolate "
        f"0/1/2 ({n} cases, (1,2,12,13,20), max_disp 1.5): max err value "
        f"{worst[0]:.3g}, grad {worst[1]:.3g}")
    for tag, args in [
            ("odd shape B=2 C=3 (19,24,37), orders (3,2,1), bounds "
             "(0,4,5), max_disp 1.5",
             (warp_case(2, 3, (19, 24, 37), 1.5, 1), (3, 2, 1), (0, 4, 5),
              1, 1.5)),
            ("per-axis max_disp (0.5,2,1), (16,17,18), bounds (3,6,2), "
             "extrapolate 0",
             (warp_case(1, 1, (16, 17, 18), (0.5, 2.0, 1.0), 2), (3, 3, 3),
              (3, 6, 2), 0, (0.5, 2.0, 1.0))),
            ("2-D B=2 C=2 (40,33), orders (3,1), bounds (3,4), hist",
             (warp_case(2, 2, (40, 33), 1.5, 3), (3, 1), (3, 4), 2, 1.5)),
            ("1-D C=2 (50,), order 5, dft",
             (warp_case(1, 2, (50,), 1.5, 4), (5,), (6,), 1, 1.5)),
            ("cubic dct2 max_disp 4 at (32,32,32)",
             (warp_case(1, 1, (32, 32, 32), 4.0, 5), (3, 3, 3), (3, 3, 3),
              1, 4.0))]:
        (inp, grid), orders, bounds, ex, md = args
        _, ev, eg = check(tag, inp, grid, orders, bounds, ex, md)
        log(f"kernel vs plain: {tag}: err value {ev:.3g}, grad {eg:.3g}")

    # a grid that breaks max_disp: the kernel drops the out-of-window taps
    # exactly as the plain window version does, unlike the full gather
    inp, grid = warp_case(1, 2, (20, 21, 22), 1.0, 6, break_contract=4.0)
    val, ev, eg = check("contract-breaking grid", inp, grid, (3, 3, 3),
                        (3, 3, 3), 1, 1.0)
    full = ndkernels.pull_core(inp, grid.reshape(1, -1, 3), (3, 3, 3),
                               (3, 3, 3), 1).reshape(val.shape)
    dropped = (val - full).abs().max().item()
    if dropped < 1e-3:
        raise AssertionError("contract-breaking grid dropped no taps")
    log(f"kernel vs plain: contract-breaking grid (20% of displacements "
        f"x4, max_disp 1.0): err value {ev:.3g}, grad {eg:.3g}; differs "
        f"from the full gather by {dropped:.3g} (dropped taps)")

    # zero displacement, linear: the warp is the identity
    inp, grid = warp_case(1, 3, (10, 11, 12), 0.0, 7)
    out, _ = cuda_warp.warp_cuda(inp, grid, (1, 1, 1), (3, 3, 3), 0, 1.0)
    if not torch.equal(out, inp):
        raise AssertionError("identity warp is not the identity")
    log("kernel: linear warp by the identity grid returns the input")

    # the whole slice at a small size: card (kernel) vs CPU (plain)
    cfg = dict(vol_shape=(12, 10, 16), coarse_shape=(4, 4, 4),
               interpolation=3, bound="dct2", max_disp=1.0)
    rng = np.random.default_rng(8)
    params = 0.5 * rng.standard_normal((2, 4, 4, 4, 3))
    moving = rng.standard_normal((2, 3, 12, 10, 16))
    outs = []
    for device in ("cuda", "cpu"):
        m = WarpModel(**cfg, batch=2, device=device)
        m.load_jax_params(params)
        with torch.no_grad():
            outs.append(m(torch.tensor(moving, dtype=torch.float32,
                                       device=device)).cpu())
    e, t = rel_err(outs[0], outs[1])
    errs["value"] = max(errs["value"], e)
    if not e <= t:
        raise AssertionError(f"small WarpModel card vs CPU: err {e:.3g}")
    log(f"WarpModel (12,10,16) coarse (4,4,4) B=2 C=3: card kernel path "
        f"vs CPU plain path err {e:.3g} (tol {t:.3g})")


def phase_main(card: str, errs, times) -> dict:
    """The 256^3 main path, with launch counts, checks and timings."""
    model = WarpModel(vol_shape=MAIN_VOL, coarse_shape=MAIN_COARSE,
                      interpolation=3, bound="dct2", device="cuda")
    rng = np.random.default_rng(0)
    model.load_jax_params(
        0.5 * rng.standard_normal((1,) + MAIN_COARSE + (3,)))
    moving = torch.randn((1, 1) + MAIN_VOL, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    opts = ((3, 3, 3), (3, 3, 3), 1, 4.0)

    with torch.no_grad():
        cuda_warp.reset_launches()
        warped = model(moving)
        flow = model.dense_flow().contiguous()
        grad = grid_grad(moving, flow, 3, "dct2", True, max_disp=4.0)
        torch.cuda.synchronize()
        launches = dict(cuda_warp.LAUNCHES_BY_MODE)
        log(f"main path: WarpModel{MAIN_VOL} coarse {MAIN_COARSE} cubic "
            f"dct2 max_disp 4 + grid_grad: launches {launches} "
            f"(LAUNCHES {cuda_warp.LAUNCHES})")
        if launches["value"] < 1 or launches["grad"] < 1:
            raise AssertionError("the main path did not launch the kernel")
        if warped.shape != (1, 1) + MAIN_VOL or \
                grad.shape != (1, 1) + MAIN_VOL + (3,):
            raise AssertionError(f"shapes {warped.shape}, {grad.shape}")
        if not (torch.isfinite(warped).all() and torch.isfinite(grad).all()):
            raise AssertionError("non-finite output")
        disp = (flow - model.dense_flow(torch.zeros_like(model.params)))
        log(f"main path: |disp| max {disp.abs().max().item():.4f} "
            f"(max_disp 4), warped std {warped.std().item():.4f}")

        ev, tv = rel_err(warped, _pull_impl_torch(moving, flow, *opts))
        eg, tg = rel_err(grad, _grad_impl_torch(moving, flow, *opts))
        errs["value"] = max(errs["value"], ev)
        errs["grad"] = max(errs["grad"], eg)
        log(f"main path vs plain path on the card: value err {ev:.3g} "
            f"(tol {tv:.3g}), grad err {eg:.3g} (tol {tg:.3g})")
        if not (ev <= tv and eg <= tg):
            raise AssertionError("main path disagrees with the plain path")

        runs = {
            "kernel value": (lambda: cuda_warp.warp_cuda(
                moving, flow, *opts, value=True, grad=False), 20),
            "plain value": (lambda: _pull_impl_torch(moving, flow, *opts),
                            3),
            "kernel grad": (lambda: cuda_warp.warp_cuda(
                moving, flow, *opts, value=False, grad=True), 20),
            "plain grad": (lambda: _grad_impl_torch(moving, flow, *opts),
                           3),
            "WarpModel forward, kernel path": (lambda: model(moving), 10),
            "WarpModel forward, plain path": (lambda: _pull_impl_torch(
                moving, model.dense_flow(), *opts), 3),
        }
        for name, (fn, reps) in runs.items():
            ms = cuda_ms(fn, reps)
            mib = peak_mib(fn)
            times[name] = ms
            log(f"time {name} {MAIN_VOL}: {ms:.3f} ms (median of {reps}), "
                f"peak +{mib:.0f} MiB over live tensors [{card}]")
    return launches


def main() -> None:
    card = phase_card()
    phase_build()
    errs = {"value": 0.0, "grad": 0.0}
    times = {}
    phase_kernels(errs)
    launches = phase_main(card, errs, times)
    kernels = [
        {"name": f"warp_{mode}", "route": "cuda",
         "source": "interpol_tpu_torch/csrc/warp.cu",
         "replaces": "interpol_tpu/ops/pallas_warp.py:160",
         "launches": launches[mode], "max_abs_err": errs[mode],
         "ms": times[f"kernel {mode}"], "plain_ms": times[f"plain {mode}"]}
        for mode in ("value", "grad")]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
