#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's dense-warp and scattered paths, forward
and training, and the coarse-to-fine pyramid on the adaptive windows, on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints lines; any failure raises and the exit code is not 0):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   with no CUDA device the script stops here (there is no CPU run);
2. build the kernels from ``interpol_tpu_torch/csrc``, one nvcc per
   source, all at once;
3. each dense-warp kernel mode (pull value / grad / hess, push, pushgrad)
   against its plain PyTorch version on the card, float32, over orders,
   bounds, extrapolation modes, odd shapes, a per-axis ``max_disp``, 1-D /
   2-D warps and a grid that breaks the ``max_disp`` contract; the adjoint
   identities; then each scattered mode (gather value / grad / hess /
   value+grad / grad+hess, splat push / pushgrad / pushhess) against the
   plain cores over orders 0-7, the seven bounds, extrapolate 0/1/2,
   D = 1/2/3, points outside the volume, another output shape and a
   dense cloud; fused modes equal to single ones, every splat equal
   across two runs and under other launch geometries (the dense push
   without its patch, the scattered splat direct and by box patches);
   then the adaptive modes (``tile_spread``: value_ad,
   grad_ad, hess_ad, push_ad, pushgrad_ad) against their plain versions
   on grids that break the declared spread (taps dropped), over orders
   0/1/3/5, bounds, D = 1/2/3, and the wide windows (``max_disp=8`` in one
   launch, an adaptive residual of span 13); the adaptive splats equal
   across two runs; then the splats' scale over the kept items (1e30, inf
   or NaN at every point the mask drops and at every dense site masked or
   outside its window leave every splat, both designs, with and without a
   patch, bit-equal to the call with those values at 0, held to the plain
   versions) and launches past 65535 rows (kernels 2 and 4 at B x C =
   65536 and 70000, kernel 1 at B = 65536);
4. the training steps at a small size on the card (kernels) against the
   same steps on the CPU (plain versions);
5. the main paths at full width, each with the launch counts set to 0
   just before it and read just after: the ``WarpModel`` forward and
   ``grid_grad`` (256^3, coarse 8^3, cubic, dct2, ``max_disp=4``), P2
   ``train_step`` x3, P3 ``svf_train_step`` x3 (``jac_weight=0.1``), P4
   the gradient of ``sum(grid_grad(v, g, max_disp=2)**2)``; P5 the
   scattered forward (``grid_pull``, ``grid_grad``, ``grid_push``,
   ``grid_count`` of 1M points in 256^3, cubic dct2), P6 its gradients
   (and P6b a second order), P7 an affine reslice of 256^3 and the
   gradient of its MSE in volume and matrix; P13 the scattered tier's
   public functions (``ops/scattered.py``) on P5's data: the expert path
   (``auto_box``, ``precompute_tables``, 3 steps of gradient ascent on
   ``pull_scattered`` / ``grad_scattered`` with ``pre=``), the six
   functions once each (``pre=`` equal to no ``pre``, the splats equal
   across two runs, ``interpret=True`` refused), the gradient of
   ``sum(pull_scattered)`` in volume and points, a 2-D cloud (1M points
   in 4096^2) and a 1-D one (100k points on 65536 samples),
   ``examples/torch_scattered.py``, and the times with and without
   ``pre=`` beside ``grid_pull`` / ``grid_grad`` in turns; P8
   ``train_step`` x3 of the
   P2 model with ``tile_spread="auto"``, P9 ``register`` of a
   ``PyramidModel`` (256^3, coarse 8^3, 3 levels 64^3 / 128^3 / 256^3,
   cubic, dct2, ``max_disp=4``, 20 steps per level, ``tile_spread="auto"``)
   on a synthetic pair, P10 the gradients in moving image and control
   points of P8's MSE and those of ``sum(grid_grad(..., tile_spread=)**2)``
   in volume and grid; P11 the interpolating prefilter (256^3 on the matrix
   path, a 4096^2 plane on the blocked scan, cubic) against the CPU in
   float64 and unchanged with TF32 on, the resize-identity through kernel
   1, ``resize`` 128^3 -> 256^3 with its defaults at cubic, the label warp
   (P2's model on a 256^3 int32 map of 32 blobs: kernel 1 per class), the
   label resize 128^3 -> 256^3 (kernel 3 per class) and restrict (kernel
   4), held to the plain paths where the plain top two soft values differ
   by more than 1e-4, and a prefiltered reslice on P7's grid; the kernels'
   outputs in each path held to the plain versions on the same inputs;
6. times and peak memory beside the card's name and power limit, push and
   every splat equal across runs, ``grid_sample`` as the library yardstick
   at order 1 (its output for value, its input gradient for push, its grid
   gradient for the spatial gradient; the adaptive value, grad and push
   on P8's flow, where they drop no tap at order 1, as well); each
   adaptive mode beside its full-window mode on P8's flow
   at 256^3 (``max_disp=4``, and value / push at ``max_disp=8``), held to
   its plain version and to the full window; a torch.profiler breakdown
   of one scattered splat (sc_push of 1M points at order 1 and cubic,
   P7's 16.7M) into its pieces (the workspace's zeroing, scale, splat
   kernel, convert; the box design's key passes, sort, index_select,
   searchsorted) and the host's waits; the device busy time, idle
   share and heaviest kernels of the two train steps and of one 256^3
   pyramid level (torch.profiler);
7. P12, the multi-device layer (``interpol_tpu_torch.parallel``) on a mesh
   of one NCCL rank at full width, each call held to the one-device call:
   the slab-sharded pull / grad / push of P2's 256^3 warp (the window
   branch: kernels 1a, 1b, 2a) and the gradient through the sharded pull,
   the point-sharded pull / push of P5's 1M points (kernels 3, 4),
   ``spline_coeff_nd_sharded`` of 256^3 and ``dryrun_multichip(1)``;
8. the kernel lab (``ops/lab.py``, ``csrc/lab.cu``): the bf16 pull against
   its plain version over orders, bounds and a contract-breaking grid, at
   65536 batches, and the lane gather at 65537 groups on both its paths,
   then the lab's runners at the JAX lab's shapes (its main path, launches
   counted): the FMA probes (float32 at 1/4/8/16 chains, bf16 pairs), the
   lane gathers (the table in shared memory, and in device memory below
   L1, inside L2, of kernel 3's 256^3 volume and beyond L2; each with the
   path it took and its share of the bytes and sector bounds, held to
   its plain version bit for bit), the bf16 pull
   beside kernel 1a, kernel 1a under the block shapes of the dense gather
   and kernel 1d beside it on a smooth field, and the yardsticks
   (``torch.matmul`` in bf16 and float32, an elementwise FMA chain;
   ``torch.gather`` of the lane gather's reads, ``index_select`` of the
   sweeps' 16-byte rows); each
   kernel held to its plain version on the same inputs and timed beside
   its bound (a lab kernel by the device time of the kernels it
   launches, beside one call's time by events).

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import time
from functools import partial

import numpy as np
import torch

from interpol_tpu_torch import (PyramidModel, SVFModel, WarpModel,
                                affine_grid, grid_count, grid_grad,
                                grid_pull, grid_push, identity_grid,
                                jacobian_det, mse_loss, register,
                                required_tile_spread, resize, restrict,
                                spline_coeff_nd, svf_mse_loss,
                                svf_train_step, train_step)
from interpol_tpu_torch.models import pyramid
from interpol_tpu_torch.ops import (_build, coeff, cuda_scattered, cuda_warp,
                                    lab, ndkernels, pushpull, scattered,
                                    window)
from interpol_tpu_torch.ops.lab import card_line, cuda_ms, timed_once
from interpol_tpu_torch.ops.separable import separable_pull
from interpol_tpu_torch.ops.tiles import default_tile
from interpol_tpu_torch.ops.window import (
    _grad_impl_torch, _hess_impl_torch, _pull_impl_torch, _push_impl_torch,
    _pushgrad_impl_torch)

# kernel vs plain: float32 sums of at most 512 non-zero taps taken in
# another order; the JAX package's float32 parity gate is 1e-5 too
TOL = 1e-5
# a whole train step, card vs CPU: the float32 losses and gradients sum
# millions of such terms through several kernels (and resize matmuls)
TOL_STEP = 1e-4
MAIN_VOL, MAIN_COARSE = (256, 256, 256), (8, 8, 8)
# one H100 SXM at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
MODES = ("value", "grad", "hess", "push", "pushgrad")
AD_MODES = tuple(f"{m}_ad" for m in MODES)     # adaptive (tile_spread)
SC_MODES = tuple(cuda_scattered.LAUNCHES_BY_MODE)
ALL_MODES = MODES + AD_MODES + SC_MODES
# the scattered paths: 1M points into 256^3 (scripts/bench_suite.py:183)
SC_N, SC_P = 256, 1_000_000
SC_OPTS = ((3, 3, 3), (3, 3, 3), 1)
# P13's lifted clouds: (D, samples per axis, points)
SC_LIFT = ((2, 4096, 1_000_000), (1, 65536, 100_000))
DEV = "cuda"
PLAIN = {"_pull": _pull_impl_torch, "_grad": _grad_impl_torch,
         "_hess": _hess_impl_torch, "_push": _push_impl_torch,
         "_pushgrad": _pushgrad_impl_torch}
MODE_OF = {"_pull": "value", "_grad": "grad", "_hess": "hess",
           "_push": "push", "_pushgrad": "pushgrad"}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(out: torch.Tensor, ref: torch.Tensor, tol: float = TOL):
    """(max |out - ref|, the tolerance it is held to)."""
    err = (out.double() - ref.double()).abs().max().item()
    return err, tol * max(1.0, ref.abs().max().item())


def hold(errs, mode, tag, out, ref):
    """Hold a kernel output to its plain version; keep the worst error."""
    e, t = rel_err(out, ref)
    errs[mode] = max(errs[mode], e)
    if not e <= t:
        raise AssertionError(f"{tag}: {mode} err {e:.3g} > tol {t:.3g}")
    return e


def with_peak(fn):
    """(fn(), the device memory in MiB that fn allocated at its peak
    beyond what was live)."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - live) / 2**20


def peak_mib(fn) -> float:
    return with_peak(fn)[1]


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
    f32 = dict(dtype=torch.float32, device=DEV)
    return torch.tensor(inp, **f32), torch.tensor(ident + d, **f32)


def cotangent(shape, seed):
    gen = torch.Generator(DEV).manual_seed(seed)
    return torch.randn(shape, device=DEV, generator=gen)


class Drive:
    """Run one main path with the launch counts set to 0 just before it
    and read just after; keep the counts summed over the main paths."""

    def __init__(self):
        self.total = {m: 0 for m in ALL_MODES}

    def __call__(self, name, fn, expect):
        cuda_warp.reset_launches()
        cuda_scattered.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        by_mode = cuda_warp.LAUNCHES_BY_MODE
        counts = {}
        for sfx in ("", "_ad"):
            both = by_mode["value+grad" + sfx]
            counts.update({m + sfx: by_mode[m + sfx]
                           + (both if m in ("value", "grad") else 0)
                           for m in MODES})
        counts.update(cuda_scattered.LAUNCHES_BY_MODE)
        log(f"{name}: launches " + str({m: c for m, c in counts.items()
                                        if c}))
        for mode, (lo, hi) in expect.items():
            if not lo <= counts[mode] <= hi:
                raise AssertionError(f"{name}: {counts[mode]} {mode} "
                                     f"launches, expected {lo}..{hi}")
        for m in ALL_MODES:
            self.total[m] += counts[m]
        return out


class Spy:
    """Keep the first call of each kernel dispatcher of ``ops/window.py``
    in a run (inputs and the kernel's output), so that the backward's
    kernel outputs can be held to the plain versions on the same inputs.
    The dispatchers still launch the kernels and count them."""

    def __init__(self):
        self.calls = {}
        self._saved = {}

    def __enter__(self):
        for name in PLAIN:
            orig = getattr(window, name)
            self._saved[name] = orig

            def spy(inp, grid, opts, _name=name, _orig=orig):
                out = _orig(inp, grid, opts)
                if _name not in self.calls:   # copies: callers may update
                    self.calls[_name] = (inp.clone(), grid.clone(), opts,
                                         out.clone())
                return out
            setattr(window, name, spy)
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(window, name, orig)

    def hold(self, errs, tag, names):
        for name in names:
            if name not in self.calls:
                raise AssertionError(f"{tag}: {name} never ran")
            inp, grid, opts, out = self.calls[name]
            mode = MODE_OF[name] + ("_ad" if opts[4] is not None else "")
            e = hold(errs, mode, tag, out, PLAIN[name](inp, grid, *opts))
            log(f"{tag}: {mode} kernel {tuple(out.shape)} vs plain on the "
                f"same inputs: err {e:.3g}")
        self.calls.clear()


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
    _build.build_all()
    for name in _build.SOURCES:
        _build.load_library(name)
    log(f"build: {time.perf_counter() - t0:.1f} s, "
        f"{' '.join(_build.SOURCES)} in parallel "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def check_modes(errs, tag, inp, grid, orders, bounds, ex, md, sp=None):
    """Every dense mode (``sp``: adaptive) against its plain version on
    the card; fused = single; hess symmetric; the splats equal across two
    runs and without a patch.  Returns (value, {mode: err})."""
    opts = (orders, bounds, ex, md, sp)
    sfx = "" if sp is None else "_ad"
    val, grad = cuda_warp.warp_cuda(inp, grid, *opts, value=True, grad=True)
    v1, _ = cuda_warp.warp_cuda(inp, grid, *opts, value=True, grad=False)
    _, g1 = cuda_warp.warp_cuda(inp, grid, *opts, value=False, grad=True)
    hess = cuda_warp.hess_cuda(inp, grid, *opts)
    ct = cotangent(tuple(grad.shape), 11)
    push = cuda_warp.push_cuda(inp, grid, *opts)
    pushgrad = cuda_warp.push_cuda(ct, grid, *opts, deriv=True)
    torch.cuda.synchronize()
    if not (torch.equal(val, v1) and torch.equal(grad, g1)):
        raise AssertionError(f"{tag}: fused and single modes differ")
    if not torch.equal(hess, hess.transpose(-1, -2)):
        raise AssertionError(f"{tag}: hess is not symmetric")
    # the same bits on a second run and with no patch (every tap straight
    # to the accumulator)
    for kw in ({}, dict(tile=(0, 0, 0))):
        if not (torch.equal(cuda_warp.push_cuda(inp, grid, *opts, **kw),
                            push)
                and torch.equal(cuda_warp.push_cuda(ct, grid, *opts,
                                                    deriv=True, **kw),
                                pushgrad)):
            raise AssertionError(f"{tag}: a splat differs between runs or "
                                 f"launch geometries ({kw})")
    return val, {
        "value": hold(errs, "value" + sfx, tag, val,
                      _pull_impl_torch(inp, grid, *opts)),
        "grad": hold(errs, "grad" + sfx, tag, grad,
                     _grad_impl_torch(inp, grid, *opts)),
        "hess": hold(errs, "hess" + sfx, tag, hess,
                     _hess_impl_torch(inp, grid, *opts)),
        "push": hold(errs, "push" + sfx, tag, push,
                     _push_impl_torch(inp, grid, *opts)),
        "pushgrad": hold(errs, "pushgrad" + sfx, tag, pushgrad,
                         _pushgrad_impl_torch(ct, grid, *opts))}


def phase_kernels(errs) -> None:
    """Kernel vs plain on the card, every mode and template case."""
    check = partial(check_modes, errs)

    def fmt(e):
        return ", ".join(f"{m} {e[m]:.3g}" for m in MODES)

    n = 0
    worst = {m: 0.0 for m in MODES}
    for o in (0, 1, 2, 3, 5, 7):
        for b in range(7):
            ex = (o + b) % 3
            inp, grid = warp_case(1, 2, (12, 13, 20), 1.5, 10 * o + b)
            _, e = check(f"order {o} bound {b} ex {ex}", inp, grid,
                         (o,) * 3, (b,) * 3, ex, 1.5)
            worst = {m: max(worst[m], e[m]) for m in MODES}
            n += 1
    log(f"kernel vs plain: orders 0,1,2,3,5,7 x bounds 0-6 x extrapolate "
        f"0/1/2 ({n} cases, (1,2,12,13,20), max_disp 1.5): max err "
        f"{fmt(worst)}")
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
        _, e = check(tag, inp, grid, orders, bounds, ex, md)
        log(f"kernel vs plain: {tag}: err {fmt(e)}")

    # a grid that breaks max_disp: the kernels drop the out-of-window taps
    # exactly as the plain window versions do, unlike the full gather
    inp, grid = warp_case(1, 2, (20, 21, 22), 1.0, 6, break_contract=4.0)
    val, e = check("contract-breaking grid", inp, grid, (3, 3, 3),
                   (3, 3, 3), 1, 1.0)
    full = ndkernels.pull_core(inp, grid.reshape(1, -1, 3), (3, 3, 3),
                               (3, 3, 3), 1).reshape(val.shape)
    dropped = (val - full).abs().max().item()
    if dropped < 1e-3:
        raise AssertionError("contract-breaking grid dropped no taps")
    log(f"kernel vs plain: contract-breaking grid (20% of displacements "
        f"x4, max_disp 1.0): err {fmt(e)}; the pull differs from the full "
        f"gather by {dropped:.3g} (dropped taps)")

    # zero displacement, linear: the warp is the identity
    inp, grid = warp_case(1, 3, (10, 11, 12), 0.0, 7)
    out, _ = cuda_warp.warp_cuda(inp, grid, (1, 1, 1), (3, 3, 3), 0, 1.0)
    if not torch.equal(out, inp):
        raise AssertionError("identity warp is not the identity")
    log("kernel: linear warp by the identity grid returns the input")

    # adjoint identities, accumulated in float64:
    # <push(u), v> = <u, pull(v)> and <pushgrad(U), v> = <U, grad(v)>
    for tag, (inp, grid), orders, bounds, ex, md in [
            ("(2,3,19,24,37) orders (3,2,1) bounds (0,4,5) hist",
             warp_case(2, 3, (19, 24, 37), 1.5, 8), (3, 2, 1), (0, 4, 5),
             2, 1.5),
            ("(1,1,32,32,32) cubic dct2 max_disp 4",
             warp_case(1, 1, (32, 32, 32), 4.0, 9), (3, 3, 3), (3, 3, 3),
             1, 4.0)]:
        opts = (orders, bounds, ex, md)
        v = cotangent(tuple(inp.shape), 12)
        U = cotangent(tuple(inp.shape) + (3,), 13)
        pv, gv = cuda_warp.warp_cuda(v, grid, *opts, value=True, grad=True)
        for name, a, b in [
                ("<push(u), v> = <u, pull(v)>",
                 cuda_warp.push_cuda(inp, grid, *opts).double() * v.double(),
                 inp.double() * pv.double()),
                ("<pushgrad(U), v> = <U, grad(v)>",
                 cuda_warp.push_cuda(U, grid, *opts, deriv=True).double()
                 * v.double(), U.double() * gv.double())]:
            lhs, rhs = a.sum().item(), b.sum().item()
            scale = max(1.0, b.abs().sum().item())
            if not abs(lhs - rhs) <= TOL * scale:
                raise AssertionError(f"adjoint {name} {tag}: {lhs} vs {rhs}")
            log(f"adjoint {name} {tag}: {lhs:.9g} vs {rhs:.9g} "
                f"(|diff| {abs(lhs - rhs):.3g}, sum|terms| {scale:.4g})")


def small_steps(device):
    """P2-P4 at (12,10,16), coarse 4^3, B=2, C=3, float32 on ``device``:
    (loss, gradient) pairs of one step each."""
    rng = np.random.default_rng(8)
    ish = (12, 10, 16)
    cfg = dict(vol_shape=ish, coarse_shape=(4, 4, 4), interpolation=3,
               bound="dct2", max_disp=1.0, batch=2, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    moving = torch.tensor(rng.standard_normal((2, 3) + ish), **f32)
    out = {}
    model = WarpModel(**cfg)
    model.load_jax_params(0.5 * rng.standard_normal((2, 4, 4, 4, 3)))
    loss = torch.mean((model(moving) - 0.9 * moving) ** 2)
    out["P2 train_step"] = (loss, *torch.autograd.grad(loss,
                                                       [model.params]))
    svf = SVFModel(**cfg, steps=3)
    svf.load_jax_params(0.5 * rng.standard_normal((2, 4, 4, 4, 3)))
    loss = svf_mse_loss(svf, moving, 0.9 * moving, jac_weight=0.1)
    out["P3 svf_train_step"] = (loss, *torch.autograd.grad(loss,
                                                           [svf.params]))
    inp, grid = (t.to(device) for t in warp_case(2, 3, ish, 1.0, 14))
    inp.requires_grad_()
    grid.requires_grad_()
    loss = (grid_grad(inp, grid, 3, "dct2", True, max_disp=1.0) ** 2).sum()
    out["P4 grid_grad"] = (loss, *torch.autograd.grad(loss, [inp, grid]))
    return out


def phase_train_small() -> None:
    card, cpu = small_steps(DEV), small_steps("cpu")
    for name in card:
        for k, (a, b) in enumerate(zip(card[name], cpu[name])):
            e, t = rel_err(a.detach().cpu(), b.detach(), TOL_STEP)
            what = "loss" if k == 0 else f"gradient {k} {tuple(a.shape)}"
            if not e <= t:
                raise AssertionError(f"{name} card vs CPU {what}: err "
                                     f"{e:.3g} > tol {t:.3g}")
            log(f"{name} (12,10,16) B=2 C=3: card kernels vs CPU plain "
                f"{what}: err {e:.3g} (tol {t:.3g})")


def phase_main(errs, drive) -> dict:
    """The 256^3 forward path, with launch counts and checks."""
    model = WarpModel(vol_shape=MAIN_VOL, coarse_shape=MAIN_COARSE,
                      interpolation=3, bound="dct2", device=DEV)
    rng = np.random.default_rng(0)
    model.load_jax_params(
        0.5 * rng.standard_normal((1,) + MAIN_COARSE + (3,)))
    moving = cotangent((1, 1) + MAIN_VOL, 0)
    opts = ((3, 3, 3), (3, 3, 3), 1, 4.0)

    with torch.no_grad():
        def forward():
            warped = model(moving)
            flow = model.dense_flow().contiguous()
            return warped, flow, grid_grad(moving, flow, 3, "dct2", True,
                                           max_disp=4.0)
        warped, flow, grad = drive(
            f"main path: WarpModel{MAIN_VOL} coarse {MAIN_COARSE} cubic "
            f"dct2 max_disp 4 forward + grid_grad", forward,
            {"value": (1, 1), "grad": (1, 1)})
        if warped.shape != (1, 1) + MAIN_VOL or \
                grad.shape != (1, 1) + MAIN_VOL + (3,):
            raise AssertionError(f"shapes {warped.shape}, {grad.shape}")
        if not (torch.isfinite(warped).all() and torch.isfinite(grad).all()):
            raise AssertionError("non-finite output")
        disp = (flow - model.dense_flow(torch.zeros_like(model.params)))
        log(f"main path: |disp| max {disp.abs().max().item():.4f} "
            f"(max_disp 4), warped std {warped.std().item():.4f}")
        ev = hold(errs, "value", "main path", warped,
                  _pull_impl_torch(moving, flow, *opts))
        eg = hold(errs, "grad", "main path", grad,
                  _grad_impl_torch(moving, flow, *opts))
        log(f"main path vs plain path on the card: value err {ev:.3g}, "
            f"grad err {eg:.3g}")
    return dict(model=model, moving=moving, flow=flow, opts=opts)


def decreasing(name, losses):
    if not all(np.isfinite(losses)) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{name}: losses {losses} are not finite and "
                             f"decreasing")
    log(f"{name}: losses {[f'{x:.9g}' for x in losses]} (finite, "
        f"decreasing)")


def phase_train_main(errs, drive) -> dict:
    """P2-P4 at 256^3 with launch counts, losses, and the backward's
    kernel outputs against the plain versions on the same inputs."""
    rng = np.random.default_rng(0)
    moving = torch.tensor(rng.standard_normal((1, 1) + MAIN_VOL),
                          dtype=torch.float32, device=DEV)
    fixed = 0.9 * moving
    model = WarpModel(vol_shape=MAIN_VOL, coarse_shape=MAIN_COARSE,
                      interpolation=3, bound="dct2", max_disp=4.0,
                      device=DEV)
    model.load_jax_params(np.full((1,) + MAIN_COARSE + (3,), 0.01))
    with Spy() as spy:
        losses = drive(
            f"P2: 3 x train_step, WarpModel{MAIN_VOL} coarse "
            f"{MAIN_COARSE} cubic dct2 max_disp 4",
            lambda: [train_step(model, moving, fixed).item()
                     for _ in range(3)],
            {"value": (3, 3), "grad": (3, 3), "push": (0, 0),
             "pushgrad": (0, 0), "hess": (0, 0)})
    decreasing("P2 train_step", losses)
    spy.hold(errs, "P2 backward", ["_grad"])

    rng = np.random.default_rng(0)
    svf = SVFModel(vol_shape=MAIN_VOL, coarse_shape=MAIN_COARSE,
                   interpolation=3, bound="dct2", max_disp=4.0, steps=6,
                   device=DEV)
    svf.load_jax_params(0.5 * rng.standard_normal((1,) + MAIN_COARSE
                                                  + (3,)))
    with Spy() as spy:
        losses = drive(
            f"P3: 3 x svf_train_step jac_weight 0.1, SVFModel{MAIN_VOL} "
            f"coarse {MAIN_COARSE} cubic dct2 max_disp 4 steps 6",
            lambda: [svf_train_step(svf, moving, fixed,
                                    jac_weight=0.1).item()
                     for _ in range(3)],
            {"value": (3, 10 ** 6), "grad": (3, 10 ** 6),
             "push": (3, 10 ** 6), "pushgrad": (3, 10 ** 6)})
    decreasing("P3 svf_train_step", losses)
    spy.hold(errs, "P3 backward", ["_push", "_pushgrad", "_grad"])
    with torch.no_grad():
        det = jacobian_det(svf.flow())
    lo, hi = det.min().item(), det.max().item()
    log(f"P3: det J after the steps: min {lo:.6g}, max {hi:.6g}")
    if not lo > 0:
        raise AssertionError("P3: det J is not positive everywhere")

    rng = np.random.default_rng(0)
    v = torch.tensor(rng.standard_normal((1,) + MAIN_VOL),
                     dtype=torch.float32, device=DEV)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in MAIN_VOL],
                                 indexing="ij"), -1)
    g = torch.tensor(ident + rng.uniform(-2, 2, ident.shape),
                     dtype=torch.float32, device=DEV)

    def p4():
        out = []
        for _ in range(3):
            vv, gg = v.requires_grad_(), g.requires_grad_()
            loss = (grid_grad(vv, gg, 3, "dct2", True, max_disp=2.0)
                    ** 2).sum()
            dv, dg = torch.autograd.grad(loss, [vv, gg])
            with torch.no_grad():
                v.sub_(1e-3 * dv)
                g.sub_(1e-9 * dg)
            out.append(loss.item())
        return out
    with Spy() as spy:
        losses = drive(
            f"P4: 3 x gradient of sum(grid_grad(v, g, cubic, dct2, "
            f"max_disp 2)**2) in v and g, {MAIN_VOL}", p4,
            {"grad": (3, 3), "pushgrad": (3, 3), "hess": (3, 3),
             "value": (0, 0), "push": (0, 0)})
    v.requires_grad_(False)
    g.requires_grad_(False)
    decreasing("P4 grid_grad", losses)
    spy.hold(errs, "P4 backward", ["_pushgrad", "_hess"])
    return dict(model=model, svf=svf, moving=moving, fixed=fixed)


def bound(nbytes, ops):
    """(least ms, what bounds it): bytes over the HBM rate or float32
    operations over the card's peak, the larger."""
    ms_b = nbytes / HBM_BYTES_PER_S * 1e3
    ms_o = ops / FP32_OPS_PER_S * 1e3
    return (ms_b, "bytes") if ms_b >= ms_o else (ms_o, "operations")


def dense_work(n, bases=0):
    """(least bytes, float32 operations) of each dense mode at cubic order
    over n voxels, C=1: inputs read once, outputs written once, FMAs as 2;
    ``bases``: the int32 tile bases an adaptive launch reads besides."""
    T = 4  # taps per axis at cubic order
    extra = 4 * bases
    return {
        "value": (4 * (n + 3 * n + n) + extra, 2 * n * (T**3 + T**2 + T)),
        "grad": (4 * (n + 3 * n + 3 * n) + extra,
                 2 * n * (2 * T**3 + 3 * T**2 + 3 * T)),
        "hess": (4 * (n + 3 * n + 9 * n) + extra,
                 2 * n * (3 * T**3 + 6 * T**2 + 6 * T)),
        "push": (4 * (n + 3 * n + n) + extra, n * (2 * T**3 + T**2)),
        "pushgrad": (4 * (3 * n + 3 * n + n) + extra,
                     n * (4 * T**3 + 4 * T**2)),
    }


def phase_times(card, errs, main, train) -> dict:
    """256^3 cubic dct2 max_disp 4, C=1: each kernel and its plain
    version, the two train steps; median CUDA-event times and peak
    memory beside the card's name and power limit."""
    moving, flow, opts = main["moving"], main["flow"], main["opts"]
    ct = cotangent((1, 1) + MAIN_VOL + (3,), 15)
    work = dense_work(moving.numel())
    runs = {
        "value": (lambda: cuda_warp.warp_cuda(moving, flow, *opts,
                                              value=True, grad=False)[0],
                  lambda: _pull_impl_torch(moving, flow, *opts)),
        "grad": (lambda: cuda_warp.warp_cuda(moving, flow, *opts,
                                             value=False, grad=True)[1],
                 lambda: _grad_impl_torch(moving, flow, *opts)),
        "hess": (lambda: cuda_warp.hess_cuda(moving, flow, *opts),
                 lambda: _hess_impl_torch(moving, flow, *opts)),
        "push": (lambda: cuda_warp.push_cuda(moving, flow, *opts),
                 lambda: _push_impl_torch(moving, flow, *opts)),
        "pushgrad": (lambda: cuda_warp.push_cuda(ct, flow, *opts,
                                                 deriv=True),
                     lambda: _pushgrad_impl_torch(ct, flow, *opts)),
    }
    times = {}
    with torch.no_grad():
        for mode, (kern, plain) in runs.items():
            k_out = kern()
            (p_out, p_ms), p_mib = with_peak(lambda: timed_once(plain))
            hold(errs, mode, f"256^3 {mode}", k_out, p_out)
            del k_out, p_out
            k_ms, k_mib = cuda_ms(kern, 20), peak_mib(kern)
            b_ms, b_by = bound(*work[mode])
            times[mode] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                               bound_by=b_by)
            if mode in ("push", "pushgrad"):
                times[mode]["peak_mib"] = k_mib
            log(f"time {mode} {MAIN_VOL} C=1 cubic dct2 max_disp 4: kernel "
                f"{k_ms:.3f} ms (median of 20, peak +{k_mib:.0f} MiB), "
                f"plain {p_ms:.3f} ms (one run, peak +{p_mib:.0f} "
                f"MiB), bound {b_ms:.3f} ms ({b_by}: "
                f"{work[mode][0] / 1e6:.1f} MB, "
                f"{work[mode][1] / 1e9:.2f} GFLOP) [{card}]")
        for mode, args, kw in [("push", (moving,), {}),
                               ("pushgrad", (ct,), dict(deriv=True))]:
            first = cuda_warp.push_cuda(*args, flow, *opts, **kw)
            if not all(torch.equal(cuda_warp.push_cuda(*args, flow, *opts,
                                                       **kw), first)
                       for _ in range(2)):
                raise AssertionError(f"{mode} differs between runs")
            log(f"{mode} run-to-run at {MAIN_VOL}: three runs torch.equal "
                f"(fixed-point splat)")
            del first

    model = main["model"]
    for name, fn, reps in [
            ("WarpModel forward, kernel path", lambda: model(moving), 10),
            ("WarpModel forward, plain path", lambda: _pull_impl_torch(
                moving, model.dense_flow(), *opts), 3)]:
        with torch.no_grad():
            ms = cuda_ms(fn, reps)
            mib = peak_mib(fn)
        times[name] = ms
        log(f"time {name} {MAIN_VOL}: {ms:.3f} ms (median of {reps}), "
            f"peak +{mib:.0f} MiB over live tensors [{card}]")
    model, svf = train["model"], train["svf"]
    moving, fixed = train["moving"], train["fixed"]
    for name, fn, reps in [
            ("train_step (WarpModel, kernel path)",
             lambda: train_step(model, moving, fixed), 5),
            ("svf_train_step jac_weight 0.1 (SVFModel steps 6, kernel path)",
             lambda: svf_train_step(svf, moving, fixed, jac_weight=0.1), 5)]:
        ms = cuda_ms(fn, reps)
        mib = peak_mib(fn)
        times[name] = ms
        log(f"time {name} {MAIN_VOL}: {ms:.3f} ms (median of {reps}), "
            f"peak +{mib:.0f} MiB over live tensors [{card}]")
    return times


# ------------------------------------------------------------ scattered
# kernel 3 (csrc/gather.cu) modes: (value, grad, hess) flags
GATHER = {"sc_value": (True, False, False), "sc_grad": (False, True, False),
          "sc_hess": (False, False, True),
          "sc_value+grad": (True, True, False),
          "sc_grad+hess": (False, True, True)}
# kernel 4 (csrc/splat.cu) specs: plain core, trailing D axes of the values
SPLAT = {"sc_push": (ndkernels.push_core, 0),
         "sc_pushgrad": (ndkernels.pushgrad_core, 1),
         "sc_pushhess": (ndkernels.pushhess_core, 2)}


def gather_mode(value, grad, hess):
    return next(m for m, f in GATHER.items() if f == (value, grad, hess))


def gather_plain(inp, grid, opts, mode):
    """The plain cores of one gather mode, in the kernel's output order."""
    v, g, h = GATHER[mode]
    return [core(inp, grid, *opts) for on, core in (
        (v, ndkernels.pull_core), (g, ndkernels.grad_core),
        (h, ndkernels.hess_core)) if on]


def gather_kernel(inp, grid, opts, mode):
    v, g, h = GATHER[mode]
    return [t for t in cuda_scattered.gather_cuda(inp, grid, *opts, value=v,
                                                  grad=g, hess=h)
            if t is not None]


def splat_kernel(vals, grid, oshape, opts, mode, **kw):
    return cuda_scattered.splat_cuda(vals, grid, oshape, *opts,
                                     spec=mode[3:], **kw)


def sc_cloud(ish, P, seed, B=1, C=2):
    """Volume N(0,1) and P points uniform over [-2.5, n + 1.5] per axis:
    outliers on both sides of every axis."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=DEV)
    inp = torch.tensor(rng.standard_normal((B, C) + tuple(ish)), **f32)
    g = -2.5 + (np.asarray(ish) + 3.0) * rng.uniform(size=(B, P, len(ish)))
    return inp, torch.tensor(g, **f32)


def sc_check(errs, tag, inp, grid, orders, bounds, ex, oshape=None):
    """Every gather mode and splat spec against the plain cores; fused
    modes equal to the single ones; every splat equal across two runs and
    in each design (direct, box patches)."""
    opts = (orders, bounds, ex)
    B, C = inp.shape[:2]
    P, D = grid.shape[1:]
    oshape = oshape or tuple(inp.shape[2:])
    outs = {}
    for mode in GATHER:
        outs[mode] = gather_kernel(inp, grid, opts, mode)
        for k, r in zip(outs[mode], gather_plain(inp, grid, opts, mode)):
            hold(errs, mode, tag, k, r)
    (v, g), (g2, h) = outs["sc_value+grad"], outs["sc_grad+hess"]
    if not (torch.equal(v, outs["sc_value"][0])
            and torch.equal(g, outs["sc_grad"][0]) and torch.equal(g2, g)
            and torch.equal(h, outs["sc_hess"][0])):
        raise AssertionError(f"{tag}: fused and single gather modes differ")
    for k, (mode, (core, nd)) in enumerate(SPLAT.items()):
        vals = cotangent((B, C, P) + (D,) * nd, 40 + k)
        out = splat_kernel(vals, grid, oshape, opts, mode)
        if not all(torch.equal(out, splat_kernel(vals, grid, oshape, opts,
                                                 mode, box=b))
                   for b in (None, False, True)):
            raise AssertionError(f"{tag}: {mode} differs between runs or "
                                 f"designs")
        hold(errs, mode, tag, out, core(vals, grid, oshape, *opts))


def phase_sc_kernels(errs) -> None:
    """Kernels 3 and 4 against the plain cores on the card: orders 0-7 x
    the seven bounds x extrapolate 0/1/2, D = 1/2/3, odd shapes, points
    outside the volume, another output shape, a dense cloud."""
    def fmt():
        return ", ".join(f"{m[3:]} {errs[m]:.3g}" for m in SC_MODES)
    n = 0
    for o in range(8):
        for b in range(7):
            ex = (o + b) % 3
            inp, grid = sc_cloud((12, 13, 20), 2000, 10 * o + b)
            sc_check(errs, f"scattered order {o} bound {b} ex {ex}", inp,
                     grid, (o,) * 3, (b,) * 3, ex)
            n += 1
    log(f"scattered kernels vs plain: orders 0-7 x bounds 0-6 x "
        f"extrapolate 0/1/2 ({n} cases, C=2, (12,13,20), 2000 points over "
        f"[-2.5, n+1.5]): max err so far {fmt()}; fused = single, two "
        f"runs and every design of every splat torch.equal")
    for tag, (ish, P, seed, B, C), orders, bounds, ex, osh in [
            ("odd shape B=2 C=3 (19,24,37), orders (3,2,1), bounds "
             "(0,4,5)", ((19, 24, 37), 5000, 1, 2, 3), (3, 2, 1),
             (0, 4, 5), 1, None),
            ("2-D B=2 (40,33), orders (3,1), bounds (3,4), hist",
             ((40, 33), 3000, 2, 2, 2), (3, 1), (3, 4), 2, None),
            ("1-D (50,), order 5, dft", ((50,), 500, 3, 1, 2), (5,), (6,),
             1, None),
            ("2-D orders (7,0), bounds (6,1), splat onto (23,31)",
             ((17, 19), 1500, 4, 1, 2), (7, 0), (6, 1), 0, (23, 31)),
            ("cubic dct2, splat onto (13,17,9)",
             ((12, 13, 20), 3000, 5, 1, 2), (3, 3, 3), (3, 3, 3), 1,
             (13, 17, 9))]:
        inp, grid = sc_cloud(ish, P, seed, B, C)
        sc_check(errs, tag, inp, grid, orders, bounds, ex, osh)
        log(f"scattered kernels vs plain: {tag}: ok")
    # the dense-cloud regime of P7: one point per voxel (8^3 boxes)
    inp, warp = warp_case(1, 2, (32, 32, 32), 1.0, 6)
    sc_check(errs, "dense cloud 32^3 points, identity + U(-1,1)", inp,
             warp.reshape(1, -1, 3), (3, 3, 3), (3, 3, 3), 0)
    log(f"scattered kernels vs plain: dense cloud 32^3: ok; max err "
        f"{fmt()}")


class ScSpy:
    """Keep the first call of each gather mode and splat spec of
    ``ops/pushpull.py`` in a run (inputs and the kernel's outputs), so
    that they can be held to the plain cores on the same inputs.  The
    dispatchers still launch the kernels and count them."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        self._gather, self._splat = pushpull._gather, pushpull._splat

        def gather(inp, grid, opts, value=False, grad=False, hess=False):
            out = self._gather(inp, grid, opts, value, grad, hess)
            mode = gather_mode(value, grad, hess)
            if grid.shape[-1] <= 3 and mode not in self.calls:
                self.calls[mode] = (inp.clone(), grid.clone(), None, opts,
                                    [t.clone() for t in out
                                     if t is not None])
            return out

        def splat(vals, grid, oshape, opts, spec):
            out = self._splat(vals, grid, oshape, opts, spec)
            if f"sc_{spec}" not in self.calls:
                self.calls[f"sc_{spec}"] = (vals.clone(), grid.clone(),
                                            oshape, opts, [out.clone()])
            return out
        pushpull._gather, pushpull._splat = gather, splat
        return self

    def __exit__(self, *exc):
        pushpull._gather, pushpull._splat = self._gather, self._splat

    def hold(self, errs, tag, modes):
        for mode in modes:
            if mode not in self.calls:
                raise AssertionError(f"{tag}: {mode} never ran")
            inp, grid, oshape, opts, outs = self.calls.pop(mode)
            refs = gather_plain(inp, grid, opts, mode) if mode in GATHER \
                else [SPLAT[mode][0](inp, grid, oshape, *opts)]
            e = max(hold(errs, mode, tag, k, r) for k, r in zip(outs, refs))
            log(f"{tag}: {mode} kernel {tuple(outs[0].shape)} vs plain on "
                f"the same inputs: err {e:.3g}")
        self.calls.clear()


def sc_data():
    """The JAX suite's scattered data (scripts/bench_suite.py:183-204):
    a 256^3 N(0,1) volume and 1M points uniform in [0, 255]^3 (numpy seed
    0), 1M N(0,1) values (seed 7), all float32."""
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=DEV)
    vol = torch.tensor(rng.standard_normal((1,) + (SC_N,) * 3)
                       .astype(np.float32), **f32)
    pts = torch.tensor(rng.uniform(0, SC_N - 1, (SC_P, 3))
                       .astype(np.float32), **f32)
    vals = torch.tensor(np.random.default_rng(7).standard_normal((1, SC_P))
                        .astype(np.float32), **f32)
    return vol, pts, vals


def finite(tag, *ts):
    if not all(torch.isfinite(t).all() for t in ts):
        raise AssertionError(f"{tag}: non-finite output")


def phase_sc_main(errs, drive) -> dict:
    """P5-P7 at full width: the scattered forward, its training and second
    order, and the affine reslice with its gradient."""
    vol, pts, vals = sc_data()
    N, P = SC_N, SC_P
    cubic = dict(interpolation=3, bound="dct2", extrapolate=True)
    # the API's point-cloud layout: grid (P, 1, 1, 3), values (1, P, 1, 1)
    pts_g, vals_g = pts.reshape(P, 1, 1, 3), vals.reshape(1, P, 1, 1)
    with torch.no_grad(), ScSpy() as spy:
        pull, grad, push, count = drive(
            f"P5: grid_pull, grid_grad, grid_push, grid_count of {P} points "
            f"in {N}^3, cubic dct2 extrapolate",
            lambda: (grid_pull(vol, pts_g, **cubic),
                     grid_grad(vol, pts_g, **cubic),
                     grid_push(vals_g, pts_g, shape=(N,) * 3, **cubic),
                     grid_count(pts_g, shape=(N,) * 3, **cubic)),
            {"sc_value": (1, 1), "sc_grad": (1, 1), "sc_push": (2, 2),
             "sc_hess": (0, 0), "value": (0, 0), "push": (0, 0)})
        spy.hold(errs, "P5", ["sc_value", "sc_grad", "sc_push"])
    finite("P5", pull, grad, push, count)
    if pull.shape != (1, P, 1, 1) or grad.shape != (1, P, 1, 1, 3) \
            or push.shape != (1, N, N, N) or count.shape != (N, N, N):
        raise AssertionError(f"P5 shapes {pull.shape} {grad.shape} "
                             f"{push.shape} {count.shape}")
    # dct2 folds keep mass: the count sums to P, the push to sum(vals)
    mass = (count.double().sum().item(), push.double().sum().item(),
            vals.double().sum().item())
    if not (abs(mass[0] / P - 1) < 1e-5 and abs(mass[1] - mass[2])
            < 1e-5 * vals.abs().sum().item()):
        raise AssertionError(f"P5: mass not kept {mass}")
    log(f"P5: sum(count) {mass[0]:.3f} (P = {P}), sum(push) {mass[1]:.4f} "
        f"vs sum(values) {mass[2]:.4f}; pull std {pull.std().item():.4f}")
    del grad, push, count

    vr, pr = vol.clone().requires_grad_(), pts_g.clone().requires_grad_()

    def p6():
        out = []
        for fn in (grid_pull, grid_grad):
            loss = (fn(vr, pr, **cubic) ** 2).sum()
            out.append((loss.item(),
                        *torch.autograd.grad(loss, [vr, pr])))
        return out
    with ScSpy() as spy:
        res = drive(
            f"P6: gradient in volume and points of sum(grid_pull**2) and of "
            f"sum(grid_grad**2), {P} points in {N}^3", p6,
            {"sc_value+grad": (1, 1), "sc_push": (1, 1),
             "sc_grad+hess": (1, 1), "sc_pushgrad": (1, 1),
             "sc_value": (0, 0), "sc_grad": (0, 0), "sc_hess": (0, 0)})
        spy.hold(errs, "P6 backward", ["sc_value+grad", "sc_push",
                                       "sc_grad+hess", "sc_pushgrad"])
    for (loss, dv, dp), name in zip(res, ("pull", "grad")):
        finite(f"P6 {name}", dv, dp)
        log(f"P6 {name}: loss {loss:.6g}, |d vol| max "
            f"{dv.abs().max().item():.4g}, |d points| max "
            f"{dp.abs().max().item():.4g}")
    del res

    def p6b():
        out = []
        for fn in (grid_pull, grid_grad):
            loss = (fn(vr, pr, **cubic) ** 2).sum()
            (dp,) = torch.autograd.grad(loss, [pr], create_graph=True)
            out.append(torch.autograd.grad(dp.square().sum(), [vr, pr]))
        return out
    with ScSpy() as spy:
        res = drive(
            f"P6b: second order, gradient in volume and points of "
            f"|d_points sum(op**2)|^2 for grid_pull and grid_grad, {P} "
            f"points in {N}^3", p6b,
            {"sc_value+grad": (1, 1), "sc_grad+hess": (1, 1),
             "sc_hess": (1, 1), "sc_pushhess": (1, 1),
             "sc_push": (2, 2), "sc_pushgrad": (3, 3)})
        spy.hold(errs, "P6b backward", ["sc_hess", "sc_pushhess"])
    for (dv, dp), name in zip(res, ("pull", "grad")):
        finite(f"P6b {name}", dv, dp)
    log("P6b: second-order gradients finite")
    del res, vr, pr

    # P7: a 10 degree rotation about the centre (axes 0, 1) and a 2-voxel
    # shift along axis 0: 256^3 points sampled from the 256^3 volume
    c = (N - 1) / 2
    t = math.radians(10.0)
    rot = np.array([[math.cos(t), -math.sin(t), 0], [math.sin(t),
                    math.cos(t), 0], [0, 0, 1]])
    mat = np.eye(4)
    mat[:3, :3] = rot
    mat[:3, 3] = np.full(3, c) - rot @ np.full(3, c) + np.array([2, 0, 0])
    vol7 = vol[0]
    fixed = 0.9 * vol7
    mat_t = torch.tensor(mat, dtype=torch.float32, device=DEV)

    def p7():
        m, v = mat_t.clone().requires_grad_(), vol7.clone().requires_grad_()
        out = grid_pull(v, affine_grid(m, (N,) * 3), 3, "dct2")
        loss = ((out - fixed) ** 2).mean()
        return (loss.item(), *torch.autograd.grad(loss, [v, m]))
    with ScSpy() as spy:
        loss, dv, dm = drive(
            f"P7: affine reslice (10 deg about the centre + 2 voxels) of "
            f"{N}^3, cubic dct2, gradient of the MSE in volume and matrix",
            p7, {"sc_value+grad": (1, 1), "sc_push": (1, 1),
                 "sc_value": (0, 0)})
        spy.hold(errs, "P7", ["sc_value+grad", "sc_push"])
    finite("P7", dv, dm)
    log(f"P7: loss {loss:.6g}, d matrix {dm[:3].flatten().tolist()}")
    return dict(vol=vol, pts=pts, vals=vals, mat=mat_t)


# the public functions of ops/scattered.py: (function, kernel mode)
SC_PUBLIC = (("pull_scattered", "sc_value"), ("grad_scattered", "sc_grad"),
             ("hess_scattered", "sc_hess"), ("push_scattered", "sc_push"),
             ("pushgrad_scattered", "sc_pushgrad"),
             ("count_scattered", "sc_push"))


def sc_public_plain(name, inp, grid, oshape, opts):
    """The plain core of a public scattered function, unbatched."""
    if name == "count_scattered":
        return ndkernels.count_core(grid[None], oshape, *opts)[0]
    core = {"pull_scattered": ndkernels.pull_core,
            "grad_scattered": ndkernels.grad_core,
            "hess_scattered": ndkernels.hess_core,
            "push_scattered": ndkernels.push_core,
            "pushgrad_scattered": ndkernels.pushgrad_core}[name]
    args = (inp[None], grid[None]) + ((oshape,) if "push" in name else ())
    return core(*args, *opts)[0]


def sc_public_all(tag, errs, drive, vol, pts, opts, seed):
    """Every public scattered function once on ``vol`` (C, *shape) and
    ``pts`` (P, D) in one driven run, each held to its plain core on the
    same inputs; the gathers with pre= equal without, the splats equal
    across two runs, interpret=True refused.  Returns the outputs."""
    shape = tuple(vol.shape[1:])
    C, (P, D) = vol.shape[0], pts.shape
    vals = cotangent((C, P), seed)
    ct = cotangent((C, P, D), seed + 1)
    box = scattered.auto_box(shape, P)
    first = {"push_scattered": vals, "pushgrad_scattered": ct,
             "count_scattered": None}

    def call(name, **kw):
        fn = getattr(scattered, name)
        if name == "count_scattered":
            return fn(pts, shape, *opts, **kw)
        if name in first:
            return fn(first[name], pts, shape, *opts, **kw)
        return fn(vol, pts, *opts, **kw)
    with torch.no_grad():
        outs = drive(f"{tag}: the six public functions",
                     lambda: [call(n) for n, _ in SC_PUBLIC],
                     {"sc_value": (1, 1), "sc_grad": (1, 1),
                      "sc_hess": (1, 1), "sc_push": (2, 2),
                      "sc_pushgrad": (1, 1)})
        pre = scattered.precompute_tables(vol, *opts[:2], box)
        for (name, mode), out in zip(SC_PUBLIC, outs):
            inp = first.get(name, vol)
            e = hold(errs, mode, f"{tag} {name}", out,
                     sc_public_plain(name, inp, pts, shape, opts))
            if name in first:
                again = call(name)
            else:
                again = call(name, box=box, pre=pre)
            if not torch.equal(again, out):
                raise AssertionError(f"{tag} {name}: a second run (the "
                                     f"gathers with pre=) differs")
            try:
                call(name, interpret=True)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{tag} {name}: interpret=True ran on "
                                     f"the card")
            log(f"{tag}: {name} {tuple(out.shape)} ({mode}) vs plain: err "
                f"{e:.3g}; {'a second run' if name in first else 'pre='} "
                f"torch.equal; interpret=True refused")
    finite(tag, *outs)
    return outs


def phase_sc_public(card, errs, drive, sc) -> None:
    """P13: the scattered tier's public functions (``ops/scattered.py``)
    on P5's data (1M points in 256^3, cubic, dct2, extrapolate): the
    expert path (``auto_box``, ``precompute_tables``, three steps of
    gradient ascent on ``pull_scattered`` / ``grad_scattered`` with
    ``pre=``), the six functions once each, the autograd gradient of
    ``sum(pull_scattered)`` in volume and points, a 2-D cloud (1M points
    in a 4096^2 plane) and a 1-D one (100k points on 65536 samples) for
    the lift, ``examples/torch_scattered.py`` on the card, and the times
    of ``pull_scattered`` / ``grad_scattered`` with and without ``pre=``
    beside ``grid_pull`` / ``grid_grad`` on the same cloud, in turns."""
    import importlib.util
    import os

    vol, pts = sc["vol"], sc["pts"]
    N, P = SC_N, SC_P
    opts = SC_OPTS
    shape = (N,) * 3
    box = scattered.auto_box(shape, P)
    pre = scattered.precompute_tables(vol, *opts[:2], box)
    if pre.shape != (1,) + shape or pre.data_ptr() != vol.data_ptr():
        raise AssertionError(f"P13: precompute_tables {tuple(pre.shape)} "
                             f"is not the float32 volume itself")

    def expert():
        moved, means = pts, []
        for _ in range(3):
            v = scattered.pull_scattered(vol, moved, *opts, box=box, pre=pre)
            dv = scattered.grad_scattered(vol, moved, *opts, box=box,
                                          pre=pre)
            moved = moved + 0.5 * dv[0]
            means.append(v.mean().item())
        return moved, means
    with torch.no_grad(), ScSpy() as spy:
        moved, means = drive(
            f"P13: the expert path, auto_box {box}, precompute_tables, 3 "
            f"steps of pull_scattered + grad_scattered with pre= on {P} "
            f"points in {N}^3", expert, {"sc_value": (3, 3),
                                         "sc_grad": (3, 3)})
        spy.hold(errs, "P13 expert path", ["sc_value", "sc_grad"])
    finite("P13 expert path", moved)
    if not means[2] > means[0]:
        raise AssertionError(f"P13: gradient ascent did not brighten the "
                             f"points: {means}")
    log(f"P13 expert path: mean value per step "
        f"{[round(m, 6) for m in means]}")

    sc_public_all(f"P13 3-D {P} points in {N}^3", errs, drive, vol, pts,
                  opts, 60)

    vr, pr = vol.clone().requires_grad_(), pts.clone().requires_grad_()

    def autograd():
        loss = scattered.pull_scattered(vr, pr, *opts).sum()
        return torch.autograd.grad(loss, [vr, pr])
    with ScSpy() as spy:
        dv, dp = drive(f"P13: gradient of sum(pull_scattered) in volume and "
                       f"points, {P} points in {N}^3", autograd,
                       {"sc_value+grad": (1, 1), "sc_push": (1, 1),
                        "sc_value": (0, 0)})
        spy.hold(errs, "P13 autograd", ["sc_value+grad", "sc_push"])
    finite("P13 autograd", dv, dp)
    del vr, pr, dv, dp

    rng = np.random.default_rng(13)
    f32 = dict(dtype=torch.float32, device=DEV)
    for D, n, p in SC_LIFT:
        img = torch.tensor(rng.standard_normal((1,) + (n,) * D), **f32)
        cloud = torch.tensor(rng.uniform(0, n - 1, (p, D)), **f32)
        sc_public_all(f"P13 {D}-D {p} points in {n}^{D}", errs, drive, img,
                      cloud, ((3,) * D, (3,) * D, 1), 70 + D)
        del img, cloud

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch_scattered.py")
    spec = importlib.util.spec_from_file_location("torch_scattered", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    moved = drive("P13: examples/torch_scattered.py on the card",
                  lambda: example.main(DEV),
                  {"sc_value": (4, 4), "sc_value+grad": (1, 1),
                   "sc_grad": (3, 3)})
    finite("P13 example", moved)

    pts_g = pts.reshape(P, 1, 1, 3)
    cubic = dict(interpolation=3, bound="dct2", extrapolate=True)
    rows = [("pull_scattered, pre=",
             lambda: scattered.pull_scattered(vol, pts, *opts, box=box,
                                              pre=pre)),
            ("pull_scattered",
             lambda: scattered.pull_scattered(vol, pts, *opts)),
            ("grid_pull", lambda: grid_pull(vol, pts_g, **cubic)),
            ("grad_scattered, pre=",
             lambda: scattered.grad_scattered(vol, pts, *opts, box=box,
                                              pre=pre)),
            ("grad_scattered",
             lambda: scattered.grad_scattered(vol, pts, *opts)),
            ("grid_grad", lambda: grid_grad(vol, pts_g, **cubic))]
    # in turns: six rounds, the order reversed every other round, so that
    # no row always runs first
    times = {name: [] for name, _ in rows}
    with torch.no_grad():
        for k in range(6):
            for name, fn in rows[::1 if k % 2 == 0 else -1]:
                times[name].append(cuda_ms(fn, 20, 2))
    for name, ts in times.items():
        log(f"time P13 {name} {P} points in {N}^3 C=1 cubic dct2 "
            f"extrapolate: {statistics.median(ts):.4f} ms (median of 6 "
            f"rounds in turns, each a median of 20 after 2; rounds "
            f"{', '.join(f'{t:.4f}' for t in ts)}) [{card}]")


def phase_sc_times(card, errs, sc) -> dict:
    """Each scattered mode at P5's shapes (1M points, 256^3, cubic dct2
    extrapolate, C=1), and P7's reslice: kernel and plain times, peak
    memory, bound."""
    N, P = SC_N, SC_P
    vol = sc["vol"].reshape(1, 1, N, N, N)
    pts = sc["pts"].reshape(1, P, 3)
    vals = sc["vals"].reshape(1, 1, P)
    opts = SC_OPTS
    T = 4
    vb, gb = 4 * N ** 3, 12 * P
    ops_pull = {"sc_value": 2 * P * (T**3 + T**2 + T),
                "sc_grad": 2 * P * (2 * T**3 + 3 * T**2 + 3 * T),
                "sc_hess": 2 * P * (3 * T**3 + 6 * T**2 + 6 * T)}
    ops_pull["sc_value+grad"] = ops_pull["sc_grad"] + 2 * P * T**3
    ops_pull["sc_grad+hess"] = ops_pull["sc_hess"] + 2 * P * T**3
    # (least bytes: inputs read once, outputs written once; FMAs as 2)
    work = {m: (vb + gb + 4 * P * w, ops_pull[m]) for m, w in
            (("sc_value", 1), ("sc_grad", 3), ("sc_hess", 9),
             ("sc_value+grad", 4), ("sc_grad+hess", 12))}
    work.update({"sc_push": (gb + 4 * P + vb, P * (2 * T**3 + T**2)),
                 "sc_pushgrad": (gb + 12 * P + vb, P * (4 * T**3 + 4 * T**2)),
                 "sc_pushhess": (gb + 36 * P + vb,
                                 P * (12 * T**3 + 12 * T**2))})
    cts = {"sc_push": vals, "sc_pushgrad": cotangent((1, 1, P, 3), 50),
           "sc_pushhess": cotangent((1, 1, P, 3, 3), 51)}
    times = {}
    with torch.no_grad():
        for mode in SC_MODES:
            if mode in GATHER:
                kern = lambda m=mode: gather_kernel(vol, pts, opts, m)
                plain = lambda m=mode: gather_plain(vol, pts, opts, m)
            else:
                kern = lambda m=mode: splat_kernel(cts[m], pts, (N,) * 3,
                                                   opts, m)
                plain = lambda m=mode: SPLAT[m][0](cts[m], pts, (N,) * 3,
                                                   *opts)
            k_out = kern()
            (p_out, p_ms), p_mib = with_peak(lambda: timed_once(plain))
            for k, r in zip(k_out if mode in GATHER else [k_out],
                            p_out if mode in GATHER else [p_out]):
                hold(errs, mode, f"{P} points {mode}", k, r)
            if mode in SPLAT and not torch.equal(kern(), k_out):
                raise AssertionError(f"{mode} differs between runs")
            del k_out, p_out
            k_ms, k_mib = cuda_ms(kern, 20), peak_mib(kern)
            b_ms, b_by = bound(*work[mode])
            times[mode] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                               bound_by=b_by)
            if mode in SPLAT:
                times[mode]["peak_mib"] = k_mib
            log(f"time {mode} {P} points in {N}^3 C=1 cubic dct2 "
                f"extrapolate: kernel {k_ms:.3f} ms (median of 20, peak "
                f"+{k_mib:.0f} MiB), plain {p_ms:.3f} ms (one run, "
                f"peak +{p_mib:.0f} MiB), bound {b_ms:.4f} ms ({b_by}: "
                f"{work[mode][0] / 1e6:.1f} MB, "
                f"{work[mode][1] / 1e9:.2f} GFLOP) [{card}]")
        log(f"splat run-to-run at {P} points: every spec torch.equal")
        # P7's shapes: the reslice pull and its image adjoint, one point per
        # voxel (the dense-cloud regime of the splat)
        grid = affine_grid(sc["mat"], (N,) * 3).reshape(1, -1, 3)
        ct = cotangent((1, 1, N ** 3), 52)
        for mode, kern, plain, nbytes in [
                ("sc_value",
                 lambda: gather_kernel(vol, grid, opts[:2] + (0,),
                                       "sc_value")[0],
                 lambda: gather_plain(vol, grid, opts[:2] + (0,),
                                      "sc_value")[0], vb + 12 * N**3 + vb),
                ("sc_push",
                 lambda: splat_kernel(ct, grid, (N,) * 3, opts[:2] + (0,),
                                      "sc_push"),
                 lambda: SPLAT["sc_push"][0](ct, grid, (N,) * 3,
                                             *opts[:2], 0),
                 12 * N**3 + vb + vb)]:
            name = f"P7 reslice {'pull' if mode in GATHER else 'push'} " \
                f"({mode})"
            # N(0,1) values at full size: the dense-cloud regime held to
            # the plain version (P7's own cotangents are ~1e-7)
            p_out, p_ms = timed_once(plain)
            e = hold(errs, mode, name, kern(), p_out)
            del p_out
            k_ms = cuda_ms(kern, 10)
            k_mib = peak_mib(kern)
            log(f"time {name} {N}^3 points from {N}^3 cubic dct2: kernel "
                f"{k_ms:.3f} ms (median of 10, peak +{k_mib:.0f} MiB), "
                f"plain {p_ms:.3f} ms (one run), bound "
                f"{bound(nbytes, 0)[0]:.4f} ms ({nbytes / 1e6:.1f} MB), "
                f"err vs plain {e:.3g} [{card}]")
    return times


def phase_library(card, main, sc, ad) -> dict:
    """The one PyTorch call that computes the same function where there is
    one: at order 1, bound zero, extrapolate, F.grid_sample (5-D bilinear,
    align_corners, zeros) is pull, its input gradient is push, and its
    grid gradient, rescaled from [-1, 1] to voxels (times 2 / (n - 1) per
    axis) and flipped to (x, y, z), is the spatial gradient.  Each is held
    to the plain version on the coordinates it computes with (it rounds
    voxel coordinates through [-1, 1] in float32, ~1e-5 voxel at 256),
    then timed beside the kernel at order 1.  The adaptive value, grad
    and push run on P8's flow with its ``tile_spread``, where they drop
    no tap at order 1: each kernel is held to the full window's plain
    version, so ``grid_sample`` computes their function too.  Returns
    {mode: (library ms, kernel ms at order 1)}."""
    import torch.nn.functional as F

    def normalized(g, shape):
        # voxel (i, j, k) -> grid_sample's (x, y, z) = (k, j, i) in [-1, 1]
        scale = torch.tensor([2 / (n - 1) for n in shape], device=DEV)
        gn = (g * scale - 1).flip(-1)
        # the voxel coordinates grid_sample samples at (align_corners)
        size = torch.tensor([n - 1 for n in shape], device=DEV,
                            dtype=g.dtype)
        return gn, (((gn.flip(-1) + 1) / 2) * size).contiguous()

    N, P = SC_N, SC_P
    moving, flow = main["moving"], main["flow"]
    vol, pts = sc["vol"].reshape(1, 1, N, N, N), sc["pts"].reshape(1, P, 3)
    vals = sc["vals"].reshape(1, 1, P)
    o1 = ((1, 1, 1), (0, 0, 0), 1)
    dense_g, dense_at = normalized(flow, MAIN_VOL)
    cloud_g, cloud_at = normalized(pts, (N,) * 3)
    cloud_g = cloud_g.reshape(1, 1, 1, P, 3)
    flow8, sp8 = ad["flow"], ad["model"].auto_tile_spread()
    ad_g, ad_at = normalized(flow8, MAIN_VOL)
    # (mode, name, image, normalized grid, cotangent or "grid" for the
    # grid gradient, kernel, plain at voxel coordinates, the coordinates
    # grid_sample samples at, the kernel's grid)
    rows = [
        ("value", "dense pull (warp value)", moving, dense_g, None,
         lambda: cuda_warp.warp_cuda(moving, flow, *o1, 4.0)[0],
         lambda g: _pull_impl_torch(moving, g, *o1, 4.0), dense_at, flow),
        ("grad", "dense spatial gradient (warp grad)", moving, dense_g,
         "grid",
         lambda: cuda_warp.warp_cuda(moving, flow, *o1, 4.0, value=False,
                                     grad=True)[1],
         lambda g: _grad_impl_torch(moving, g, *o1, 4.0), dense_at, flow),
        ("push", "dense push", moving, dense_g, moving,
         lambda: cuda_warp.push_cuda(moving, flow, *o1, 4.0),
         lambda g: _push_impl_torch(moving, g, *o1, 4.0), dense_at, flow),
        ("value_ad", "adaptive dense pull (warp value_ad, P8's flow)",
         moving, ad_g, None,
         lambda: cuda_warp.warp_cuda(moving, flow8, *o1, 4.0, sp8)[0],
         lambda g: _pull_impl_torch(moving, g, *o1, 4.0), ad_at, flow8),
        ("grad_ad", "adaptive dense spatial gradient (warp grad_ad, P8's "
         "flow)", moving, ad_g, "grid",
         lambda: cuda_warp.warp_cuda(moving, flow8, *o1, 4.0, sp8,
                                     value=False, grad=True)[1],
         lambda g: _grad_impl_torch(moving, g, *o1, 4.0), ad_at, flow8),
        ("push_ad", "adaptive dense push (push_ad, P8's flow)", moving, ad_g,
         moving, lambda: cuda_warp.push_cuda(moving, flow8, *o1, 4.0, sp8),
         lambda g: _push_impl_torch(moving, g, *o1, 4.0), ad_at, flow8),
        ("sc_value", "scattered pull (sc_value)", vol, cloud_g, None,
         lambda: gather_kernel(vol, pts, o1, "sc_value")[0],
         lambda g: ndkernels.pull_core(vol, g, *o1), cloud_at, pts),
        ("sc_grad", "scattered spatial gradient (sc_grad)", vol, cloud_g,
         "grid", lambda: gather_kernel(vol, pts, o1, "sc_grad")[0],
         lambda g: ndkernels.grad_core(vol, g, *o1), cloud_at, pts),
        ("sc_push", "scattered push (sc_push)", vol, cloud_g, vals,
         lambda: splat_kernel(vals, pts, (N,) * 3, o1, "sc_push"),
         lambda g: ndkernels.push_core(vals, g, (N,) * 3, *o1), cloud_at,
         pts)]
    out_ms = {}
    for mode, name, inp, g, ct, kern, plain, lib_at, grid0 in rows:
        if ct is None:
            def lib(inp=inp, g=g):
                return F.grid_sample(inp, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=True)
        elif isinstance(ct, str):
            # d out / d voxel coordinate: the grid gradient of each
            # sample's own output (C=1) times 2 / (n - 1), axes flipped
            gleaf = g.detach().clone().requires_grad_()
            out = F.grid_sample(inp, gleaf, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
            ones = torch.ones_like(out)
            scale = torch.tensor([2 / (n - 1) for n in inp.shape[2:]],
                                 device=DEV)

            def lib(out=out, gleaf=gleaf, ones=ones, scale=scale):
                dg = torch.autograd.grad(out, gleaf, ones,
                                         retain_graph=True)[0]
                return dg.flip(-1) * scale
        else:
            leaf = inp.detach().clone().requires_grad_()
            out = F.grid_sample(leaf, g, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
            ctr = ct.reshape(out.shape)

            def lib(out=out, leaf=leaf, ctr=ctr):
                return torch.autograd.grad(out, leaf, ctr,
                                           retain_graph=True)[0]
        with torch.no_grad():
            ref_lib, ref = plain(lib_at), plain(grid0)
            e_lib, t_lib = rel_err(lib().reshape(ref.shape), ref_lib)
            e_k, t_k = rel_err(kern().reshape(ref.shape), ref)
            if not (e_lib <= t_lib and e_k <= t_k):
                raise AssertionError(f"library {name}: grid_sample err "
                                     f"{e_lib:.3g}, kernel err {e_k:.3g}")
            del ref, ref_lib
            l_ms, k_ms = cuda_ms(lib, 10), cuda_ms(kern, 10)
        out_ms[mode] = (l_ms, k_ms)
        log(f"library {name}, order 1 zero extrapolate: grid_sample "
            f"{l_ms:.3f} ms (err vs plain {e_lib:.3g}), kernel {k_ms:.3f} "
            f"ms (err {e_k:.3g}), median of 10 [{card}]")
    return out_ms


# ------------------------------------------------------------ adaptive
def phase_adaptive_kernels(errs) -> None:
    """The adaptive modes against their plain versions on grids that break
    the declared spread (taps dropped), over orders, bounds and D; the
    wide windows in one launch."""
    check = partial(check_modes, errs)

    def fmt(e):
        return ", ".join(f"{m} {e[m]:.3g}" for m in MODES)

    # several tiles of both tilings (pull (8, 8, 140), push (8, 8, 128)),
    # bases that differ between tiles
    inp, grid = warp_case(2, 2, (20, 17, 140), 2.0, 20)
    grid[0, :8] += 1.0
    opts = ((3, 3, 3), (3, 3, 3), 1, 2.0)
    val, e = check("adaptive, spread-breaking grid", inp, grid, *opts, 0.5)
    full = cuda_warp.warp_cuda(inp, grid, *opts)[0]
    dropped = (val - full).abs().max().item()
    if dropped < 1e-3:
        raise AssertionError("spread-breaking grid dropped no taps")
    log(f"adaptive kernel vs plain: (2,2,20,17,140) cubic dct2 max_disp 2, "
        f"tile_spread 0.5, |disp| <= 2 (breaks it): err {fmt(e)}; the pull "
        f"differs from the full window by {dropped:.3g} (dropped taps); "
        f"push_ad, pushgrad_ad two runs torch.equal")
    worst = {m: 0.0 for m in MODES}
    n = 0
    for D, ish in ((3, (12, 13, 20)), (2, (30, 17)), (1, (150,))):
        for o in (0, 1, 3, 5):
            for b in (0, 3, 6):
                ex = (o + b) % 3
                inp, grid = warp_case(1, 2, ish, 1.5, 100 * D + 10 * o + b)
                _, e = check(f"adaptive D={D} order {o} bound {b} ex {ex}",
                             inp, grid, (o,) * D, (b,) * D, ex, 1.5,
                             (0.5,) * (D - 1) + (1.0,))
                worst = {m: max(worst[m], e[m]) for m in MODES}
                n += 1
    log(f"adaptive kernel vs plain: D = 3/2/1 x orders 0,1,3,5 x bounds "
        f"0,3,6 ({n} cases, max_disp 1.5, tile_spread 0.5 / last axis 1, "
        f"|disp| <= 1.5): max err {fmt(worst)}")
    # the wide windows: the TPU kernels chunk a span over 14 (12 adaptive);
    # one launch here
    inp, grid = warp_case(1, 2, (24, 20, 36), 8.0, 21)
    _, e = check("max_disp 8", inp, grid, (3, 3, 3), (3, 3, 3), 1, 8.0)
    log(f"kernel vs plain: (1,2,24,20,36) cubic max_disp 8 (window span "
        f"20, one launch): err {fmt(e)}")
    _, e = check("adaptive max_disp 8 tile_spread 4.5", inp, grid,
                 (3, 3, 3), (3, 3, 3), 1, 8.0, 4.5)
    log(f"adaptive kernel vs plain: (1,2,24,20,36) cubic max_disp 8, "
        f"tile_spread 4.5 (residual span 13, union 29, one launch): err "
        f"{fmt(e)}")


# ------------------------------------------------------------ faults
# values that an item the splat drops may carry: none may reach its slice's
# scale (csrc/fixed_splat.cuh), so none may change a bit of the output
DROPPED = (1e30, math.inf, math.nan)


def dense_kept(grid, orders, ex, md, sp):
    """(B, *ishape) bool: the sites that kernel 2 keeps (site_kept): the
    plain versions' mask (``window._mask``: the extrapolation mask, and in
    adaptive mode the window test shifted by each push tile's base) and,
    in the plain mode, the window test of the node origin's offset."""
    D = grid.shape[-1]
    ishape = tuple(grid.shape[1:-1])
    m = window._mask(grid, ishape, ex, torch.float32, orders, md, sp,
                     push=True)
    keep = torch.ones(grid.shape[:-1], dtype=torch.bool, device=grid.device)
    if m is not None:
        keep &= m > 0
    if sp is None:
        for d, mdd in enumerate(window._md_tuple(md, D)):
            n0 = torch.floor(grid[..., d] - 0.5 * (orders[d] - 1)) \
                if orders[d] else torch.round(grid[..., d])
            shape = [1] * (D + 1)
            shape[1 + d] = ishape[d]
            r = n0 - torch.arange(ishape[d], device=grid.device
                                  ).reshape(shape)
            smin, smax = window.window_range(orders[d], mdd)
            keep &= (r >= smin) & (r <= smax - orders[d])
    return keep


def dirty_and_zero(vals, keep):
    """(vals with every dropped item's values zeroed, the same with each
    of DROPPED there in turn)."""
    k = keep[:, None].reshape(keep.shape[:1] + (1,) + keep.shape[1:]
                              + (1,) * (vals.ndim - keep.ndim - 1))
    return (torch.where(k, vals, 0.0),
            [torch.where(k, vals, bad) for bad in DROPPED])


def phase_faults(errs) -> None:
    """The splats' scale over the kept items and the launches past 65535
    rows, on the card against the plain versions.  (1) An item the splat
    drops (a point the mask drops; a dense site masked or outside its
    window) sets no scale: with 1e30, inf or NaN at every dropped item,
    kernels 2 (push, pushgrad, full window and adaptive, with and without
    a patch) and 4 (every spec, direct and box) equal bit for bit their
    own calls with those values zeroed, held to the plain versions of the
    zeroed values.  (2) More than 65535 slices, channels or batches:
    kernels 2 and 4 at B x C = 65536 and 70000, kernel 1 at B = 65536,
    held to the plain versions."""
    n = 0
    # (1) dense: a fifth of the displacements x4 (window-dropped), masked
    # sites at the edges (extrapolate 0), adaptive on a spread-breaking grid
    for spec, orders, bounds, ex, ish, md, sp, brk in [
            ("push", (3, 3, 3), (3, 3, 3), 0, (19, 21, 37), 1.5, None, 4.0),
            ("pushgrad", (3, 3, 3), (6, 0, 4), 0, (19, 21, 37), 1.5, None,
             4.0),
            ("push", (3, 3, 3), (3, 3, 3), 0, (20, 17, 140), 2.0, 0.5, 0.0),
            ("pushgrad", (3, 1), (3, 0), 1, (30, 140), 2.0, 0.5, 0.0)]:
        inp, grid = warp_case(2, 3, ish, md, 30 + n, break_contract=brk)
        if sp is not None:
            grid[0, :8] += 1.0
        D = len(ish)
        keep = dense_kept(grid, orders, ex, md, sp)
        vals = inp if spec == "push" else cotangent(inp.shape + (D,), 31)
        zero, dirty = dirty_and_zero(vals, keep)
        opts = (orders, bounds, ex, md, sp)
        deriv = spec == "pushgrad"
        plain = _pushgrad_impl_torch if deriv else _push_impl_torch
        clean = cuda_warp.push_cuda(zero, grid, *opts, deriv=deriv)
        mode = spec + ("" if sp is None else "_ad")
        e = hold(errs, mode, f"fault 1 {mode} {ish}", clean,
                 plain(zero, grid, *opts))
        for bad in dirty:
            for tile in (None, (0, 0, 0)):
                if not torch.equal(cuda_warp.push_cuda(
                        bad, grid, *opts, deriv=deriv, tile=tile), clean):
                    raise AssertionError(
                        f"fault 1: {mode} {ish}: a value at a dropped site "
                        f"changed the output (tile {tile})")
        log(f"fault 1: {mode} (2,3,{','.join(map(str, ish))}) orders "
            f"{orders} ex {ex} max_disp {md} tile_spread {sp}: "
            f"{int((~keep).sum())} of {keep.numel()} sites dropped, at "
            f"1e30 / inf / NaN equal to the call with them zeroed (default "
            f"tile and no patch); vs plain err {e:.3g}")
        n += 1
    # (1) scattered: points outside the mask on every side; the last cloud
    # has more than 32 points per output voxel and channel (the keep bits
    # in the workspace, not in the output)
    for orders, bounds, ex, ish, P in [
            ((3, 3, 3), (3, 3, 3), 0, (19, 21, 37), 3000),
            ((1, 2), (6, 4), 2, (33, 18), 700),
            ((1, 1), (3, 3), 0, (4, 3), 3000)]:
        _, grid = sc_cloud(ish, P, 40 + n, B=2)
        keep = ndkernels.inbounds_mask(grid, ish, ex, torch.float32) > 0
        opts = (orders, bounds, ex)
        for k, (mode, (core, nd_)) in enumerate(SPLAT.items()):
            vals = cotangent((2, 3, P) + (len(ish),) * nd_, 50 + k)
            zero, dirty = dirty_and_zero(vals, keep)
            clean = splat_kernel(zero, grid, ish, opts, mode)
            e = hold(errs, mode, f"fault 1 {mode} {ish}", clean,
                     core(zero, grid, ish, *opts))
            for bad in dirty:
                for box in (False, True):
                    if not torch.equal(splat_kernel(bad, grid, ish, opts,
                                                    mode, box=box), clean):
                        raise AssertionError(
                            f"fault 1: {mode} {ish}: a value at a masked "
                            f"point changed the output (box {box})")
            log(f"fault 1: {mode} (2,3) {P} points in {ish} orders {orders} "
                f"ex {ex}: {int((~keep).sum())} masked, at 1e30 / inf / NaN "
                f"equal to the call with them zeroed (direct and box); vs "
                f"plain err {e:.3g}")
        n += 1
    # (2) more than 65535 slices, channels or batches, tiny volumes
    ish = (3, 4, 5)
    opts = ((3, 1, 2), (3, 6, 0), 1)
    gen = torch.Generator(DEV).manual_seed(60)
    for B, C in ((1, 65536), (70000, 1)):
        inp, grid = warp_case(B, C, ish, 0.5, 61)
        ct = torch.randn(inp.shape + (3,), device=DEV, generator=gen)
        for mode, vals, deriv, plain in [
                ("push", inp, False, _push_impl_torch),
                ("pushgrad", ct, True, _pushgrad_impl_torch)]:
            out = cuda_warp.push_cuda(vals, grid, *opts, 0.5, deriv=deriv)
            e = hold(errs, mode, f"fault 2 {mode} B={B} C={C}", out,
                     plain(vals, grid, *opts, 0.5))
            if not torch.equal(out, cuda_warp.push_cuda(
                    vals, grid, *opts, 0.5, deriv=deriv, tile=(0, 0, 0))):
                raise AssertionError(f"fault 2: {mode} B={B} C={C}: no "
                                     f"patch gives other bits")
            log(f"fault 2: {mode} B={B} C={C} {ish}: err {e:.3g}, the same "
                f"bits without a patch")
        pts = torch.rand((B, 7, 3), device=DEV, generator=gen) \
            * torch.tensor(ish, device=DEV) - 0.5
        vals = torch.randn((B, C, 7), device=DEV, generator=gen)
        out = splat_kernel(vals, pts, ish, opts, "sc_push", box=False)
        e = hold(errs, "sc_push", f"fault 2 sc_push B={B} C={C}", out,
                 ndkernels.push_core(vals, pts, ish, *opts))
        if not torch.equal(out, splat_kernel(vals, pts, ish, opts,
                                             "sc_push", box=True)):
            raise AssertionError(f"fault 2: sc_push B={B} C={C}: the "
                                 f"designs give other bits")
        log(f"fault 2: sc_push B={B} C={C}, 7 points a batch into {ish}: "
            f"err {e:.3g}, direct and box the same bits")
    inp, grid = warp_case(65536, 1, ish, 0.5, 62)
    val, g = cuda_warp.warp_cuda(inp, grid, (3, 3, 3), (3, 3, 3), 1, 0.5,
                                 value=True, grad=True)
    e = max(hold(errs, "value", "fault 2 value B=65536", val,
                 _pull_impl_torch(inp, grid, (3, 3, 3), (3, 3, 3), 1, 0.5)),
            hold(errs, "grad", "fault 2 grad B=65536", g,
                 _grad_impl_torch(inp, grid, (3, 3, 3), (3, 3, 3), 1, 0.5)))
    log(f"fault 2: kernel 1 value+grad B=65536 {ish}: err {e:.3g}")


class LevelTimer:
    """Time each ``run_level`` that ``register`` makes (host clock around
    work that ends in a synchronize)."""

    def __enter__(self):
        self.ms = []
        self._orig = pyramid.run_level

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*args, **kw)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        pyramid.run_level = timed
        return self

    def __exit__(self, *exc):
        pyramid.run_level = self._orig


def phase_adaptive_main(card, errs, drive, train) -> dict:
    """P8-P10: the adaptive train step, the pyramid, template learning."""
    moving, fixed = train["moving"], train["fixed"]
    model = WarpModel(vol_shape=MAIN_VOL, coarse_shape=MAIN_COARSE,
                      interpolation=3, bound="dct2", max_disp=4.0,
                      tile_spread="auto", device=DEV)
    model.load_jax_params(np.full((1,) + MAIN_COARSE + (3,), 0.01))
    sp = model.auto_tile_spread()
    losses = drive(
        f"P8: 3 x train_step, WarpModel{MAIN_VOL} coarse {MAIN_COARSE} "
        f"cubic dct2 max_disp 4 tile_spread auto {sp}",
        lambda: [train_step(model, moving, fixed).item() for _ in range(3)],
        {"value_ad": (3, 3), "grad_ad": (3, 3), "value": (0, 0),
         "grad": (0, 0), "push_ad": (0, 0)})
    decreasing("P8 train_step (adaptive)", losses)
    for name, m in [("P2 train_step (full window)", train["model"]),
                    ("P8 train_step (adaptive)", model)]:
        ms = cuda_ms(lambda: train_step(m, moving, fixed), 5)
        mib = peak_mib(lambda: train_step(m, moving, fixed))
        log(f"time {name} {MAIN_VOL}: {ms:.3f} ms (median of 5), peak "
            f"+{mib:.0f} MiB over live tensors [{card}]")

    # P9: the pyramid on a synthetic pair (examples/registration.py:29-39)
    pm = PyramidModel(vol_shape=MAIN_VOL, coarse_shape=MAIN_COARSE,
                      levels=3, interpolation=3, bound="dct2", max_disp=4.0,
                      steps_per_level=20, tile_spread="auto", device=DEV)
    rng = np.random.default_rng(0)
    mov = torch.tensor(rng.standard_normal((1, 1) + MAIN_VOL)
                       .astype(np.float32), device=DEV)
    mov = resize(restrict(mov, factor=2, interpolation=1),
                 shape=list(MAIN_VOL), interpolation=3)
    true = torch.tensor(rng.uniform(-2, 2, (1,) + MAIN_COARSE + (3,))
                        .astype(np.float32), device=DEV)
    finest = pm.finest()
    with torch.no_grad():
        fix = finest.warp(mov, true)
    t0 = time.perf_counter()
    with LevelTimer() as lt:
        (params, losses), mib = drive(
            f"P9: register, PyramidModel{MAIN_VOL} coarse {MAIN_COARSE} 3 "
            f"levels {pm.level_shapes()} cubic dct2 max_disp 4, 20 steps "
            f"per level, tile_spread auto, lr 1",
            lambda: with_peak(lambda: register(pm, mov, fix, lr=1.0)),
            {"value_ad": (60, 60), "grad_ad": (60, 60), "value": (0, 0),
             "grad": (0, 0), "push_ad": (0, 0)})
    wall = (time.perf_counter() - t0) * 1e3
    losses = losses.cpu().numpy()
    if losses.shape != (3, 20) or not np.isfinite(losses).all():
        raise AssertionError(f"P9: losses {losses.shape} not finite")
    for lev in range(3):
        tr = losses[lev]
        if not tr[-1] < tr[0]:
            raise AssertionError(f"P9 level {lev}: loss did not decrease "
                                 f"({tr[0]} -> {tr[-1]})")
        log(f"P9 level {lev} {pm.level_shapes()[lev]} max_disp "
            f"{pm.level_model(lev).max_disp} tile_spread "
            f"{pm.level_model(lev)._spread()}: loss {tr[0]:.9g} -> "
            f"{tr[-1]:.9g} (every step lower: "
            f"{bool(np.all(np.diff(tr) < 0))}), {lt.ms[lev]:.1f} ms for 20 "
            f"steps [{card}]")
    with torch.no_grad():
        before = mse_loss(finest, mov, fix,
                          params=pm.init_params(1)).item()
        after = mse_loss(finest, mov, fix, params=params).item()
    if not after < before:
        raise AssertionError(f"P9: final MSE {after} not below the "
                             f"unregistered {before}")
    log(f"P9: finest-level MSE unregistered {before:.9g}, registered "
        f"{after:.9g}; wall {wall:.1f} ms in all (pyramids + 3 levels), "
        f"peak +{mib:.0f} MiB over live tensors [{card}]")

    # P10: template learning through the adaptive warp, and the grid_grad
    # second order with tile_spread
    flow = model.dense_flow().detach().contiguous()

    def p10():
        mv = moving.clone().requires_grad_()
        p = model.params.detach().clone().requires_grad_()
        loss = mse_loss(model, mv, fixed, params=p)
        d_mv, d_p = torch.autograd.grad(loss, [mv, p])
        v = moving[0].clone().requires_grad_()
        g = flow.clone().requires_grad_()
        loss2 = (grid_grad(v, g, 3, "dct2", True, max_disp=4.0,
                           tile_spread=sp) ** 2).sum()
        dv, dg = torch.autograd.grad(loss2, [v, g])
        return loss.item(), d_mv, d_p, loss2.item(), dv, dg
    with Spy() as spy:
        loss, d_mv, d_p, loss2, dv, dg = drive(
            f"P10: gradient in moving image and control points of P8's MSE, "
            f"and in volume and grid of sum(grid_grad(v, flow, cubic, dct2, "
            f"max_disp 4, tile_spread {sp})**2), {MAIN_VOL}", p10,
            {"value_ad": (1, 1), "push_ad": (1, 1), "grad_ad": (2, 2),
             "pushgrad_ad": (1, 1), "hess_ad": (1, 1), "value": (0, 0),
             "push": (0, 0), "pushgrad": (0, 0), "hess": (0, 0)})
        spy.hold(errs, "P10 backward", ["_push", "_pushgrad"])
    finite("P10", d_mv, d_p, dv, dg)
    log(f"P10: MSE {loss:.9g}, |d moving| max {d_mv.abs().max().item():.4g}"
        f", |d params| max {d_p.abs().max().item():.4g}; grid_grad loss "
        f"{loss2:.6g}, |d v| max {dv.abs().max().item():.4g}, |d grid| max "
        f"{dg.abs().max().item():.4g}")
    return dict(model=model, flow=flow, finest=finest, mov=mov, fix=fix,
                params=params)


def phase_adaptive_times(card, errs, ad, train) -> dict:
    """Each adaptive mode beside its full-window mode on P8's flow (256^3,
    cubic, dct2, max_disp 4, C=1): held to its plain version (one run,
    timed) and to the full-window kernel; kernel times median of 20; then
    value and push at max_disp 8 (the TPU's chunked window)."""
    moving, flow = train["moving"], ad["flow"]
    sp = ad["model"].auto_tile_spread()
    ct = cotangent((1, 1) + MAIN_VOL + (3,), 16)
    o3 = ((3, 3, 3), (3, 3, 3), 1)

    def runs(flow, md, sp):
        opts = o3 + (md, sp)
        return {
            "value": (lambda: cuda_warp.warp_cuda(moving, flow, *opts)[0],
                      lambda: _pull_impl_torch(moving, flow, *opts)),
            "grad": (lambda: cuda_warp.warp_cuda(moving, flow, *opts,
                                                 value=False, grad=True)[1],
                     lambda: _grad_impl_torch(moving, flow, *opts)),
            "hess": (lambda: cuda_warp.hess_cuda(moving, flow, *opts),
                     lambda: _hess_impl_torch(moving, flow, *opts)),
            "push": (lambda: cuda_warp.push_cuda(moving, flow, *opts),
                     lambda: _push_impl_torch(moving, flow, *opts)),
            "pushgrad": (lambda: cuda_warp.push_cuda(ct, flow, *opts,
                                                     deriv=True),
                         lambda: _pushgrad_impl_torch(ct, flow, *opts))}
    tile = default_tile(MAIN_VOL)
    ntiles = math.prod(-(-v // t) for v, t in zip(MAIN_VOL, tile))
    work = dense_work(moving.numel(), bases=3 * ntiles)
    times = {}
    with torch.no_grad():
        full, adap = runs(flow, 4.0, None), runs(flow, 4.0, sp)
        for mode in MODES:
            k_ad, k_full = adap[mode][0](), full[mode][0]()
            p_out, p_ms = timed_once(adap[mode][1])
            e = hold(errs, mode + "_ad", f"256^3 {mode}_ad", k_ad, p_out)
            e_full, t_full = rel_err(k_ad, k_full)
            if not e_full <= t_full:
                raise AssertionError(f"256^3 {mode}_ad differs from the "
                                     f"full window: {e_full:.3g}")
            del k_ad, k_full, p_out
            if mode in ("push", "pushgrad"):
                first = adap[mode][0]()
                if not torch.equal(adap[mode][0](), first):
                    raise AssertionError(f"{mode}_ad differs between runs")
                del first
            ms_full, ms_ad = cuda_ms(full[mode][0], 20), \
                cuda_ms(adap[mode][0], 20)
            mib_full, mib_ad = peak_mib(full[mode][0]), \
                peak_mib(adap[mode][0])
            b_ms, b_by = bound(*work[mode])
            times[mode + "_ad"] = dict(ms=ms_ad, plain_ms=p_ms,
                                       bound_ms=b_ms, bound_by=b_by)
            if mode in ("push", "pushgrad"):
                times[mode + "_ad"]["peak_mib"] = mib_ad
            log(f"time {mode}_ad {MAIN_VOL} C=1 cubic dct2 max_disp 4 "
                f"tile_spread {tuple(round(x, 4) for x in sp)} on P8's "
                f"flow: kernel {ms_ad:.3f} ms (median of 20, peak "
                f"+{mib_ad:.0f} MiB) beside the full window {ms_full:.3f} "
                f"ms (peak +{mib_full:.0f} MiB); plain {p_ms:.3f} ms (one "
                f"run); err vs plain {e:.3g}, vs full window {e_full:.3g}; "
                f"bound {b_ms:.3f} ms ({b_by}) [{card}]")
        # max_disp 8: the TPU chunks this window (span 20 > 14); one launch
        m8 = WarpModel(vol_shape=MAIN_VOL, coarse_shape=MAIN_COARSE,
                       interpolation=3, bound="dct2", max_disp=8.0,
                       tile_spread="auto", device=DEV)
        m8.load_jax_params(
            0.5 * np.random.default_rng(0).standard_normal(
                (1,) + MAIN_COARSE + (3,)))
        flow8 = m8.dense_flow().contiguous()
        # the geometric "auto" bound need not hold for this flow (its
        # control points vary far more than P8's); declare what it needs
        auto8 = m8.auto_tile_spread()
        sp8 = required_tile_spread(flow8)
        log(f"max_disp 8 flow: tile_spread auto "
            f"{tuple(round(x, 4) for x in auto8)}, required "
            f"{tuple(round(x, 4) for x in sp8)} (required_tile_spread)")
        full8, adap8 = runs(flow8, 8.0, None), runs(flow8, 8.0, sp8)
        k_out = full8["value"][0]()
        p_out, p_ms = timed_once(full8["value"][1])
        e = hold(errs, "value", "256^3 max_disp 8 value", k_out, p_out)
        e_ad, t_ad = rel_err(adap8["value"][0](), k_out)
        if not e_ad <= t_ad:
            raise AssertionError(f"max_disp 8 value_ad differs from the "
                                 f"full window: {e_ad:.3g}")
        del k_out, p_out
        b_ms, b_by = bound(*work["value"])
        times["value md8"] = dict(ms=cuda_ms(full8["value"][0], 20),
                                  plain_ms=p_ms, bound_ms=b_ms)
        ident = m8.dense_flow(torch.zeros_like(m8.params))
        log(f"time value {MAIN_VOL} cubic dct2 max_disp 8 (|disp| max "
            f"{(flow8 - ident).abs().max().item():.3f}, window span 20, "
            f"one launch): kernel "
            f"{times['value md8']['ms']:.3f} ms (median of 20), plain "
            f"{p_ms:.3f} ms (one run), err {e:.3g}, bound {b_ms:.3f} ms "
            f"({b_by}) [{card}]")
        for mode in ("value", "push"):
            ms_full = cuda_ms(full8[mode][0], 20)
            ms_ad = cuda_ms(adap8[mode][0], 20)
            log(f"time {mode} vs {mode}_ad {MAIN_VOL} cubic max_disp 8, "
                f"tile_spread {tuple(round(x, 4) for x in sp8)}: full window "
                f"{ms_full:.3f} ms, adaptive {ms_ad:.3f} ms (median of 20) "
                f"[{card}]")
    return times


# the pieces of one scattered splat, by device kernel name (lower case);
# "sort" is the box sort and, when a cloud has outliers, their pair sort
# ------------------------------------------------ prefilter and labels
# P11: the interpolating prefilter (ops/coeff.py: float64 products, no
# kernel) and the label-map paths through the four kernels
LABEL_CLASSES = 32      # the order of a whole-brain segmentation's count
MARGIN = 1e-4           # labels are held where the plain top two differ


def prefilter_work(shape, order=3, scan=False):
    """(least bytes, operations) of spline_coeff_nd over every axis of a
    float32 volume: read once, written once; the matrix path does 2 n
    operations per voxel and axis, the blocked scan per pole two chunk
    products of 2 * 128 and two carries per voxel and axis."""
    n = math.prod(shape)
    poles = {2: 1, 3: 1, 4: 2, 5: 2, 6: 3, 7: 3}[order]
    per = [2 * 2 * (2 * 128 + 2) * poles if scan else 2 * s for s in shape]
    return 8 * n, n * sum(per)


def separable_ops(ishape, oshape, order=3):
    """Operations of resize's prefilter and its D sampling products."""
    ops = prefilter_work(ishape, order)[1]
    cur = list(ishape)
    for d, o in enumerate(oshape):
        ops += 2 * o * math.prod(cur)
        cur[d] = o
    return ops


def bound_text(nbytes, ops) -> str:
    ms, by = bound(nbytes, ops)
    return (f"bound {ms:.3f} ms ({by}: {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} GFLOP)")


def blobs(shape, classes, seed):
    """A (1, 1, *shape) int32 map of ``classes`` smooth blobs: the argmax
    of ``classes`` N(0, 1) fields on a 16x coarser grid, upsampled."""
    gen = torch.Generator(DEV).manual_seed(seed)
    coarse = torch.randn((classes, 1) + tuple(s // 16 for s in shape),
                         device=DEV, generator=gen)
    lab = torch.zeros((1, 1) + tuple(shape), dtype=torch.int32, device=DEV)
    best = torch.full(lab.shape, -math.inf, device=DEV)
    for c in range(classes):
        f = resize(coarse[c:c + 1], shape=list(shape), interpolation=3,
                   prefilter=False, anchor="e")
        lab[f > best] = c
        best = torch.maximum(best, f)
    return lab


def plain_labels(lab, pull, prefilter=None):
    """The label pull on plain versions: each class's soft map (prefiltered
    by ``prefilter``) pulled by ``pull``, the strict argmax from (0, label
    0); and the margin between each voxel's top two values (0 among
    them)."""
    top = None
    out = None
    for c in range(LABEL_CLASSES):
        soft = (lab == c).float()
        if prefilter is not None:
            soft = prefilter(soft)
        soft = pull(soft)
        if top is None:
            out = torch.zeros(soft.shape, dtype=lab.dtype, device=DEV)
            top = torch.stack([torch.zeros_like(soft)] * 2)
        out[soft > top[0]] = c
        top = torch.stack([torch.maximum(top[0], soft),
                           torch.maximum(top[1], torch.minimum(top[0],
                                                               soft))])
    return out, top[0] - top[1]


def hold_labels(tag, out, ref, margin):
    """Labels equal wherever the plain top two differ by more than
    MARGIN; returns the share of voxels inside the margin."""
    sure = margin > MARGIN
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{tag}: {out.shape} {out.dtype} vs "
                             f"{ref.shape} {ref.dtype}")
    bad = int((out != ref)[sure].sum())
    inside = int((~sure).sum())
    if bad:
        raise AssertionError(f"{tag}: {bad} labels differ from the plain "
                             f"path outside the {MARGIN} margin")
    log(f"{tag}: labels equal to the plain path on the card wherever the "
        f"plain top two differ by more than {MARGIN}; {inside} of "
        f"{out.numel()} voxels inside the margin, "
        f"{int((out != ref)[~sure].sum())} of them differ")
    return inside


def phase_prefilter_labels(card, errs, drive, train, sc) -> None:
    """P11: the prefilter on both paths against the CPU in float64, with
    TF32 on; the resize-identity through kernel 1; resize with its
    defaults at cubic; the label warp, the label resize and the label
    restrict (kernels 1, 3, 4) held to their plain versions; a
    prefiltered reslice (kernel 3)."""
    def held(name, out, ref, tol=TOL):
        e, t = rel_err(out.cpu(), ref, tol)
        if not e <= t:
            raise AssertionError(f"{name}: err {e:.3g} > tol {t:.3g}")
        log(f"{name}: err {e:.3g} (tol {t:.3g})")

    rng = np.random.default_rng(11)
    # the matrix path: 256^3, cubic, dct2, every axis
    x = torch.tensor(rng.standard_normal((1, 1) + MAIN_VOL)
                     .astype(np.float32), device=DEV)
    coeffs = lambda: spline_coeff_nd(x, 3, "dct2", dim=3)
    out = coeffs()
    ref = spline_coeff_nd(x.cpu().double(), 3, "dct2", dim=3)
    held(f"prefilter {MAIN_VOL} cubic dct2 (matrix path), card vs CPU "
         f"float64", out, ref)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        a = x[0, 0, 0]
        tf32 = (a @ a - (a.double() @ a.double()).float()).abs().max()
        same = torch.equal(coeffs(), out)
    finally:
        torch.set_float32_matmul_precision(before)
    if not same:
        raise AssertionError("prefilter: TF32 moved the result")
    log(f"prefilter with set_float32_matmul_precision('high'): result "
        f"torch.equal to the default's (a float32 256x256 product moves "
        f"by {tf32.item():.3g} under it)")
    flow = identity_grid(MAIN_VOL, device=DEV)[None]
    back = drive("P11: resize-identity, grid_pull(x, identity, cubic, dct2, "
                 "prefilter, max_disp 1)",
                 lambda: grid_pull(x, flow, 3, "dct2", prefilter=True,
                                   max_disp=1.0), {"value": (1, 1)})
    held(f"resize-identity {MAIN_VOL} through kernel 1 (float32 "
         f"coefficients, then a float32 pull)", back, x.cpu(), TOL_STEP)
    del back, flow
    w = prefilter_work(MAIN_VOL)
    b_ms, b_by = bound(*w)
    ms = cuda_ms(coeffs, 20)
    log(f"time prefilter {MAIN_VOL} C=1 cubic dct2 (matrix path, float64 "
        f"products): {ms:.3f} ms (median of 20, peak +{peak_mib(coeffs):.0f}"
        f" MiB), bound {b_ms:.3f} ms ({b_by}: {w[0] / 1e6:.1f} MB, "
        f"{w[1] / 1e9:.2f} GFLOP) [{card}]")
    # the same products in float32 (TF32 off), which the port does not use
    coeff._WORK = torch.float32
    try:
        e, _ = rel_err(coeffs().cpu(), ref)
        f32_ms = cuda_ms(coeffs, 20)
    finally:
        coeff._WORK = torch.float64
    log(f"time prefilter {MAIN_VOL} with float32 products (not used): "
        f"{f32_ms:.3f} ms (median of 20), err vs CPU float64 {e:.3g} "
        f"[{card}]")
    del out, ref

    # the blocked scan: a 4096 x 4096 plane, cubic, dct1
    y = torch.tensor(rng.standard_normal((1, 1, 4096, 4096))
                     .astype(np.float32), device=DEV)
    scan = lambda: spline_coeff_nd(y, 3, "dct1", dim=2)
    held("prefilter (4096, 4096) cubic dct1 (blocked scan), card vs CPU "
         "float64", scan(), spline_coeff_nd(y.cpu().double(), 3, "dct1",
                                            dim=2))
    w = prefilter_work((4096, 4096), scan=True)
    b_ms, b_by = bound(*w)
    log(f"time prefilter (4096, 4096) C=1 cubic dct1 (blocked scan, "
        f"float64): {cuda_ms(scan, 10):.3f} ms (median of 10, peak "
        f"+{peak_mib(scan):.0f} MiB), bound {b_ms:.3f} ms ({b_by}: "
        f"{w[0] / 1e6:.1f} MB, {w[1] / 1e9:.2f} GFLOP) [{card}]")
    del y

    # resize with its defaults at cubic: 128^3 -> 256^3
    half = tuple(n // 2 for n in MAIN_VOL)
    small = x[..., ::2, ::2, ::2].contiguous()
    up = lambda: resize(small, factor=[2, 2, 2], interpolation=3)
    # the CPU's float64 evaluation at the card's own float32 sample
    # positions (a float32 position is off by up to 4e-6 voxel at 127,
    # which moves a cubic N(0, 1) image by ~1e-5 on its own; reported too)
    out = up()
    lines = [torch.linspace(0, h - 1, n, device=DEV).cpu().double()
             for h, n in zip(half, MAIN_VOL)]
    coef = spline_coeff_nd(small.cpu().double(), 3, "nearest", dim=3)
    held(f"resize {half} -> {MAIN_VOL} cubic, defaults (prefilter, "
         f"nearest, extrapolate), card vs CPU float64 at the same sample "
         f"positions", out, separable_pull(coef, lines, (3,) * 3, (1,) * 3,
                                           1))
    e, _ = rel_err(out.cpu(), resize(small.cpu().double(), factor=[2, 2, 2],
                                     interpolation=3))
    log(f"resize {half} -> {MAIN_VOL}: err {e:.3g} against the CPU's "
        f"float64 call (float64 sample positions)")
    del out, coef
    work = (4 * small.numel() + 4 * x.numel(), separable_ops(half, MAIN_VOL))
    log(f"time resize {half} -> {MAIN_VOL} cubic with the prefilter: "
        f"{cuda_ms(up, 20):.3f} ms (median of 20, peak "
        f"+{peak_mib(up):.0f} MiB), {bound_text(*work)} [{card}]")
    del small, x

    # the label warp: P2's model and flow, a 256^3 map of 32 blobs
    lab = blobs(MAIN_VOL, LABEL_CLASSES, 12)
    model = train["model"]
    with torch.no_grad():
        flow = model.dense_flow().contiguous()
    present = len(torch.unique(lab))
    with Spy() as spy:
        (warped, mib) = drive(
            f"P11: label warp, WarpModel{MAIN_VOL} (P2's, after its steps)"
            f".warp of a {MAIN_VOL} int32 map of {present} classes",
            lambda: with_peak(lambda: model.warp(lab)),
            {"value": (present, present), "grad": (0, 0)})
        spy.hold(errs, "P11 label warp, first class", ["_pull"])
    opts = ((3, 3, 3), (3, 3, 3), 1, 4.0, None)
    ref, margin = plain_labels(lab, lambda s: _pull_impl_torch(s, flow,
                                                               *opts))
    hold_labels(f"P11 label warp {MAIN_VOL}, {present} classes", warped,
                ref, margin)
    del ref, margin, warped
    ms = cuda_ms(lambda: model.warp(lab), 3)
    # the map and the flow read once, the labels written once; a cubic
    # pull per class
    n = lab.numel()
    log(f"time label warp {MAIN_VOL} int32, {present} classes (kernel 1 "
        f"per class): {ms:.3f} ms (median of 3), peak +{mib:.0f} MiB over "
        f"live tensors, "
        f"{bound_text(20 * n, present * dense_work(n)['value'][1])} "
        f"[{card}]")

    # the label resize: that map at 128^3 back to 256^3, cubic, prefilter
    lab128 = lab[..., ::2, ::2, ::2].contiguous()
    present = len(torch.unique(lab128))
    with ScSpy() as spy:
        (big, mib) = drive(
            f"P11: resize of the {half} map ({present} classes) to "
            f"{MAIN_VOL}, cubic, prefilter (defaults)",
            lambda: with_peak(lambda: resize(lab128, factor=[2, 2, 2],
                                             interpolation=3)),
            {"sc_value": (present, present), "value": (0, 0)})
        spy.hold(errs, "P11 label resize, first class", ["sc_value"])
    lines = [torch.linspace(0, h - 1, n, device=DEV)
             for h, n in zip(half, MAIN_VOL)]
    grid = torch.stack(torch.meshgrid(*lines, indexing="ij"), -1)
    grid = grid.reshape(1, -1, 3)
    ropts = ((3, 3, 3), (1, 1, 1), 1)
    ref, margin = plain_labels(
        lab128, lambda s: ndkernels.pull_core(s, grid, *ropts)
        .reshape((1, 1) + MAIN_VOL),
        lambda s: spline_coeff_nd(s, 3, "replicate", dim=3))
    hold_labels(f"P11 label resize {half} -> {MAIN_VOL}", big, ref,
                margin)
    del ref, margin, big, grid
    ms = cuda_ms(lambda: resize(lab128, factor=[2, 2, 2],
                                interpolation=3), 3)
    ops = present * (prefilter_work(half)[1] + dense_work(n)['value'][1])
    log(f"time label resize {half} -> {MAIN_VOL} int32, {present} classes "
        f"(prefilter and kernel 3 per class): {ms:.3f} ms (median of 3), "
        f"peak +{mib:.0f} MiB over live tensors, "
        f"{bound_text(4 * lab128.numel() + 4 * n, ops)} [{card}]")

    # the label restrict: the 256^3 map by 2 (kernel 4, as floats)
    with ScSpy() as spy:
        small = drive(f"P11: restrict of the {MAIN_VOL} label map by 2",
                      lambda: restrict(lab, factor=[2, 2, 2]),
                      {"sc_push": (1, 1)})
        spy.hold(errs, "P11 label restrict", ["sc_push"])
    if small.dtype != torch.float32 or small.shape != (1, 1) + half:
        raise AssertionError(f"label restrict: {small.dtype} {small.shape}")
    ms = cuda_ms(lambda: restrict(lab, factor=[2, 2, 2]), 10)
    # a linear splat: 2 x 8 weight products and 4 more per voxel
    log(f"time label restrict {MAIN_VOL} -> {half} (kernel 4): {ms:.3f} ms "
        f"(median of 10), {bound_text(4 * n + 4 * n // 8, 20 * n)} "
        f"[{card}]")
    del small, lab, lab128

    # a prefiltered reslice: P7's affine grid, cubic, dct2
    N = SC_N
    vol7 = sc["vol"][0]
    agrid = affine_grid(sc["mat"], (N,) * 3)
    reslice = lambda: grid_pull(vol7, agrid, 3, "dct2", prefilter=True)
    with torch.no_grad(), ScSpy() as spy:
        out = drive(f"P11: prefiltered reslice of {N}^3 (P7's matrix), "
                    f"cubic dct2", reslice, {"sc_value": (1, 1)})
        spy.hold(errs, "P11 prefiltered reslice", ["sc_value"])
        finite("P11 reslice", out)
        ms = cuda_ms(reslice, 10)
    ops = prefilter_work((N,) * 3)[1] + dense_work(N ** 3)['value'][1]
    log(f"time prefiltered reslice {N}^3 from {N}^3 cubic dct2 (prefilter "
        f"+ kernel 3): {ms:.3f} ms (median of 10), "
        f"{bound_text(8 * N ** 3, ops)} [{card}]")


# ------------------------------------------------------------ kernel lab
# csrc/lab.cu: the counterparts of the JAX kernel lab's Pallas functions
# (scripts/tpu_kernel_lab*.py), each row of the kernels line: (runner
# result key, the TPU function's pallas_call it replaces)
LAB_ROWS = {
    "lab_fma_f32": ("fma2", "scripts/tpu_kernel_lab.py:347"),
    "lab_fma_bf16x2": ("fma2bf", "scripts/tpu_kernel_lab.py:347"),
    "lab_gather_smem": ("smem", "scripts/tpu_kernel_lab5.py:48"),
    "lab_gather_global": ("hbm", "scripts/tpu_kernel_lab.py:465"),
    "lab_pad_bf16": ("pad_bf16", "scripts/tpu_kernel_lab2.py:183"),
    "lab_pull_bf16": ("pull_bf16", "scripts/tpu_kernel_lab2.py:183"),
}
# the JAX lab's shapes: the pulls at 128^3, the products 1024^2 x 64, the
# elementwise chain 256^3 x 64
LAB_N, LAB_MM, LAB_CHAIN = 128, 1024, (256,) * 3
PEAK_SOURCE = {"float32": ", data sheet",
               "bfloat16": ", Hopper white paper, bf16 outside the tensor "
                           "cores"}


def share(bound_ms, ms) -> str:
    """A time's share of its bound, in per cent."""
    return f"{100 * bound_ms / ms:.1f} %"


def phase_lab_kernels() -> None:
    """The bf16 pull against its plain version beyond the lab's own case
    (the runners hold every lab kernel at the lab's shapes): other orders
    and bounds, the extrapolation masks, a grid that breaks ``max_disp``
    (the samples it drops read 0 in both), and its bf16 pass against
    the pass's plain version bit for bit under each z bound; then more
    batches and groups than a grid's y axis holds: the bf16 pull at B =
    65536 and the lane gather at G = 65537, held to their plain
    versions."""
    with torch.no_grad(), lab.uncounted():
        vol, grid = lab.lab_case(64, 2.0, DEV, seed=3)
        wild = grid.clone()
        wild[..., 0] += 3.0 * (torch.rand(grid.shape[:-1], device=DEV,
                                          generator=torch.Generator(DEV)
                                          .manual_seed(4)) < 0.2)
        for orders, bounds, ex in [((3, 3, 3), (3, 3, 3), 1),
                                   ((0, 1, 2), (5, 0, 6), 0),
                                   ((3, 2, 1), (2, 4, 3), 2)]:
            for name, g in (("contract", grid), ("broken", wild)):
                out = lab.pull_bf16(vol, g, orders, bounds, ex, 2.0)
                ref = lab.pull_bf16_plain(vol, g, orders, bounds, ex, 2.0)
                e, t = rel_err(out, ref, lab.TOL_PULL_BF16)
                if not (e <= t and torch.equal(out == 0, ref == 0)):
                    raise AssertionError(f"lab_pull_bf16 {orders} {bounds} "
                                         f"{ex} {name}: err {e:.3g}")
                log(f"lab_pull_bf16 64^3 orders {orders} bounds {bounds} "
                    f"extrapolate {ex}, {name} grid: err vs plain {e:.3g} "
                    f"(tol {t:.3g})")
            margins = lab.pad_margins(orders[2], 2.0)
            if not torch.equal(lab.pad_bf16(vol, bounds[2], *margins),
                               lab.pad_bf16_plain(vol, bounds[2], *margins)):
                raise AssertionError(f"lab_pad_bf16 bound {bounds[2]} "
                                     f"margins {margins}: differs")
            log(f"lab_pad_bf16 64^3 bound {bounds[2]} margins {margins}: "
                f"equal to plain")
        gen = torch.Generator(DEV).manual_seed(5)
        vol = torch.randn((65536, 1, 4, 4, 4), generator=gen, device=DEV)
        grid = lab.lab_case(4, 1.0, DEV, seed=6)[1].expand(
            65536, -1, -1, -1, -1) + 0.3 * torch.randn(
                (65536, 4, 4, 4, 3), generator=gen, device=DEV)
        out = lab.pull_bf16(vol, grid, (3, 1, 2), (3, 4, 0), 1, 1.0)
        e, t = rel_err(out, lab.pull_bf16_plain(vol, grid, (3, 1, 2),
                                                (3, 4, 0), 1, 1.0),
                       lab.TOL_PULL_BF16)
        # the lane gather on both paths: T = 5 (4-byte reads) and T = 8
        # (16-byte copies and reads in shared memory), runs of 3 that wrap
        paths, same = [], True
        for T in (5, 8):
            table = torch.randn((65537, 2, T), generator=gen, device=DEV)
            idx = torch.randint(-T, 2 * T, (65537, 2, 3), generator=gen,
                                device=DEV, dtype=torch.int32)
            for smem in (True, False):
                out, path = lab.gather_and_path(table, idx, 3, smem)
                paths.append(path)
                same = same and torch.equal(out,
                                            lab.gather_plain(table, idx, 3))
        if not (e <= t and same
                and paths == ["scalar", "scalar", "vector", "scalar"]):
            raise AssertionError(f"lab past 65535: bf16 pull err {e:.3g}, "
                                 f"gather equal {same}, paths {paths}")
        log(f"lab past 65535: lab_pull_bf16 B=65536 4^3 err vs plain "
            f"{e:.3g} (tol {t:.3g}); lab_gather G=65537 equal to plain at "
            f"T = 5 and 8 in shared and device memory, paths {paths}")


def phase_lab(card) -> dict:
    """The kernel lab's main path: its runners at the JAX lab's shapes,
    the launch counts set to 0 just before and read just after (the
    launches that hold a kernel to its plain version are not counted).
    A lab row's ``ms`` is its kernels' device time (``lab.device_ms``),
    printed beside the time of one call by events.  Returns the kernels
    line's lab rows by name, and the launches."""
    lab.reset_launches()
    res = {}
    for v in lab.FMA_VARIANTS:
        r = res[v] = lab.fma_probe(v, DEV)
        log(f"lab fma {v} {r['shape']} reps {r['reps']} nacc {r['nacc']} "
            f"{r['dtype']}: {r['ms']:.4f} ms device (a call by events "
            f"{r['call_ms']:.4f}), {r['tflop_s']:.2f} TFLOP/s "
            f"(peak {r['peak_tflop_s']:.1f}{PEAK_SOURCE[r['dtype']]}; bound "
            f"{r['bound_ms']:.4f} ms, {share(r['bound_ms'], r['ms'])} of "
            f"it), "
            f"err vs plain {r['max_abs_err']:.3g} (tol {r['tol']:.3g}), "
            f"plain {r['plain_ms']:.1f} ms [{card}]")
    for t in lab.GATHER_TABLES:
        r = res[t] = lab.gather_probe(t, DEV)
        # a random read from device memory moves a 32-byte sector
        sectors = "" if r["smem"] else (
            f", 32-byte sectors {r['sector_mb']:.1f} MB = "
            f"{r['sector_ms']:.4f} ms "
            f"({100 * r['sector_share']:.1f} % of it): "
            f"{'sectors' if r['sector_ms'] > r['bound_ms'] else 'bytes'} "
            f"bound it")
        log(f"lab gather {t}: table ({r['G']}, {r['S']}, {r['T']}) "
            f"{r['table_mb']:.1f} MB {'shared' if r['smem'] else 'device'} "
            f"memory, {r['path']} path, {r['G'] * r['S'] * r['L']} lanes x "
            f"{r['reps']} reads: {r['ms']:.4f} ms device (L2 evicted before "
            f"each call; a call by events {r['call_ms']:.4f}), "
            f"{r['greads_s']:.1f} G reads/s; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{100 * r['bound_share']:.1f} % of it){sectors}; "
            f"equal to plain (err {r['max_abs_err']:.3g}), plain "
            f"{r['plain_ms']:.2f} ms; library: torch.gather of the same "
            f"{r['G'] * r['S'] * r['L'] * r['reps']} reads "
            f"{r['lib_gather_ms']:.4f} ms (the sum over reads undone; err "
            f"of its sum vs plain {r['lib_gather_err']:.3g})"
            + ("" if r["lib_rows_ms"] is None else
               f", index_select of the {r['G'] * r['S'] * r['L']} 16-byte "
               f"rows {r['lib_rows_ms']:.4f} ms as 4 floats, "
               f"{r['lib_rows16_ms']:.4f} ms as one complex128")
            + f" [{card}]")
    r = res["pull_bf16"] = lab.pull_bf16_probe(LAB_N, 2.0, DEV)
    log(f"lab pull_bf16 {LAB_N}^3 cubic dct2 max_disp 2: {r['ms']:.4f} ms "
        f"device, the bf16 pass included ({share(r['bound_ms'], r['ms'])} "
        f"of its bound; a call by events {r['call_ms']:.4f}; +"
        f"{r['extra_mib']:.1f} MiB beside the output) beside the f32 "
        f"pull, kernel 1a, on the same inputs: {r['ms_f32']:.4f} ms "
        f"({share(r['bound_ms'], r['ms_f32'])}; a call "
        f"{r['call_ms_f32']:.4f}); bound "
        f"{r['bound_ms']:.4f} ms, err vs plain {r['max_abs_err']:.3g} (tol "
        f"{r['tol']:.3g}), vs the f32 pull {r['vs_f32']:.3g}, plain "
        f"{r['plain_ms']:.1f} ms [{card}]")
    r = res["pad_bf16"] = r["pad"]
    log(f"lab pad_bf16 {LAB_N}^3 dct2, its bf16 pass alone: {r['ms']:.4f} "
        f"ms device ({share(r['bound_ms'], r['ms'])} of its bound "
        f"{r['bound_ms']:.4f} ms, {r['bound_by']}), err vs plain "
        f"{r['max_abs_err']:.3g} (equal bits), plain {r['plain_ms']:.2f} ms "
        f"[{card}]")
    for r in lab.pull_variants(LAB_N, 2.0, DEV):
        extra = f", spread {tuple(round(s, 3) for s in r['spread'])}, " \
            f"vs 1a {r['vs_full']:.3g}" if r.get("spread") else ""
        log(f"lab pull variant {r['variant']} {LAB_N}^3 cubic dct2 "
            f"max_disp 2: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f}){extra} [{card}]")
        if r.get("spread") and not r["vs_full"] <= TOL * 10:
            raise AssertionError(f"1d on smooth_grid: {r['vs_full']:.3g}")
    for dt in (torch.bfloat16, torch.float32):
        r = lab.matmul_probe(dt, LAB_MM, 64, DEV)
        log(f"lab yardstick torch.matmul {r['dtype']} {r['M']}^2 x "
            f"{r['reps']}: {r['ms']:.3f} ms, {r['tflop_s']:.1f} TFLOP/s "
            f"[{card}]")
    r = lab.chain_probe(64, LAB_CHAIN, DEV)
    log(f"lab yardstick elementwise FMA chain {LAB_CHAIN} x 64 (torch): "
        f"{r['ms']:.3f} ms, {r['tfma_s']:.3f} T-FMA/s [{card}]")
    torch.cuda.synchronize()
    launches = dict(lab.LAUNCHES_BY_MODE)
    log(f"lab: launches {launches}")
    rows = {}
    for name, (key, line) in LAB_ROWS.items():
        r = res[key]
        rows[name] = {"name": name, "route": "cuda",
                      "source": "interpol_tpu_torch/csrc/lab.cu",
                      "replaces": line, "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r.get("lib_gather_ms")}
    return rows


# ------------------------------------------------------------ multi-device
def phase_multidevice(card, errs, drive, main, sc) -> dict:
    """P12: ``interpol_tpu_torch.parallel`` on a mesh of one NCCL rank at
    full width, each call held to the one-device call at TOL: the
    slab-sharded pull / grad / push of P2's 256^3 case (the window branch:
    kernels 1a, 1b, 2a), the gradient through the sharded pull, the
    point-sharded pull / push of P5's 1M points (kernels 3, 4),
    ``spline_coeff_nd_sharded`` of 256^3 and ``dryrun_multichip(1)``.
    Returns {name: (sharded ms, one-device ms)}."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from interpol_tpu_torch import entry, parallel

    moving, flow = main["moving"], main["flow"]
    opts = ((3, 3, 3), (3, 3, 3), 1)
    # the slab ops sample in the halo-extended frame, x + H in float32 (H
    # the halo; the JAX package's frame too): the one-device references
    # run on the coordinates that frame holds, (x + H) - H, exactly
    H = parallel.halo_width(opts[0], 4.0)
    frame = flow.clone()
    frame[..., 0] = (flow[..., 0] + H) - H
    N, P = SC_N, SC_P
    vol = sc["vol"].reshape(1, 1, N, N, N)
    pts, vals = sc["pts"].reshape(1, P, 3), sc["vals"].reshape(1, 1, P)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, timeout=timedelta(seconds=60))
        try:
            mx = init_device_mesh("cuda", (1,), mesh_dim_names=("x",))
            md = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            kw = dict(mesh=mx, max_disp=4.0)
            cases = [
                ("pull_sharded", lambda: parallel.pull_sharded(
                    moving, flow, *opts, **kw),
                 lambda g=frame: window.pull_window(moving, g, *opts, 4.0),
                 {"value": (1, 1)}),
                ("grad_sharded", lambda: parallel.grad_sharded(
                    moving, flow, *opts, **kw),
                 lambda g=frame: window.grad_window(moving, g, *opts, 4.0),
                 {"grad": (1, 1)}),
                ("push_sharded", lambda: parallel.push_sharded(
                    moving, flow, MAIN_VOL, *opts, **kw),
                 lambda g=frame: window.push_window(moving, g, *opts, 4.0),
                 {"push": (1, 1)}),
                ("pull_points", lambda: parallel.pull_points(
                    vol, pts, *opts, mesh=md),
                 lambda: pushpull.pull(vol, pts, *opts),
                 {"sc_value": (1, 1)}),
                ("push_points", lambda: parallel.push_points(
                    vals, pts, (N,) * 3, *opts, mesh=md),
                 lambda: pushpull.push(vals, pts, (N,) * 3, *opts),
                 {"sc_push": (1, 1)}),
                ("spline_coeff_nd_sharded", lambda: (
                    parallel.spline_coeff_nd_sharded(
                        moving, (3,) * 3, (3,) * 3, 3, mesh=mx)),
                 lambda: coeff.spline_coeff_nd(moving, (3,) * 3, (3,) * 3,
                                               3), {}),
            ]
            with torch.no_grad():
                for name, fn, ref_fn, expect in cases:
                    out = drive(f"P12 {name} on a one-rank NCCL mesh",
                                lambda: fn().to_local(), expect)
                    ref = ref_fn()
                    e, t = rel_err(out, ref)
                    if not e <= t:
                        raise AssertionError(f"P12 {name}: err {e:.3g} > "
                                             f"{t:.3g}")
                    times[name] = (cuda_ms(fn, 5), cuda_ms(ref_fn, 5))
                    log(f"P12 {name}: vs the one-device call err {e:.3g} "
                        f"(tol {t:.3g}); {times[name][0]:.3f} ms sharded, "
                        f"{times[name][1]:.3f} ms one-device (median of 5)"
                        f" [{card}]")
                    if name in ("pull_sharded", "grad_sharded",
                                "push_sharded"):
                        e0 = rel_err(out, ref_fn(flow))[0]
                        log(f"P12 {name}: vs the one-device call on the "
                            f"unshifted grid {e0:.3g} (the frame's float32 "
                            f"rounding of x + {H})")
                    del out, ref

            def sharded_loss():
                v = moving.clone().requires_grad_()
                g = flow.clone().requires_grad_()
                out = parallel.pull_sharded(v, g, *opts, **kw)
                loss = (out.full_tensor() ** 2).sum()
                return torch.autograd.grad(loss, [v, g])
            dv, dg = drive("P12 gradient of sum(pull_sharded**2) in volume "
                           "and grid", sharded_loss,
                           {"grad": (1, 1), "push": (1, 1)})
            v = moving.clone().requires_grad_()
            g = frame.clone().requires_grad_()
            rv, rg = torch.autograd.grad(
                (window.pull_window(v, g, *opts, 4.0) ** 2).sum(), [v, g])
            ev, eg = rel_err(dv, rv)[0], rel_err(dg, rg)[0]
            if not (ev <= rel_err(dv, rv)[1] and eg <= rel_err(dg, rg)[1]):
                raise AssertionError(f"P12 gradients: {ev:.3g} {eg:.3g}")
            log(f"P12 gradient through pull_sharded vs one device: volume "
                f"{ev:.3g}, grid {eg:.3g}")
            del dv, dg, rv, rg, v, g
            loss = drive("P12 dryrun_multichip(1)",
                         lambda: entry.dryrun_multichip(1),
                         {"value": (1, 1), "grad": (1, 1), "push": (0, 0)})
            log(f"P12 dryrun_multichip(1): loss {loss:.6f}")
        finally:
            dist.destroy_process_group()
    return times


SPLAT_PIECES = (("splat kernel", ("splat_direct", "splat_box")),
                ("scale", ("scale_kernel",)),
                ("convert", ("convert_kernel",)),
                ("zero", ("fill", "memset")),
                ("searchsorted", ("searchsorted",)),
                ("sort", ("radixsort", "sort")),
                ("index_select", ("index", "gather")))


def splat_piece(name: str) -> str:
    low = name.lower()
    for piece, keys in SPLAT_PIECES:
        if any(k in low for k in keys):
            return piece
    return "elementwise (keys, mask, lift, rows)"


def phase_splat_profile(card, sc) -> None:
    """torch.profiler breakdown of one scattered splat (sc_push) at P5's
    shapes, order 1 and cubic, and of P7's dense splat: device time per
    piece, the host's waits (cudaStreamSynchronize: none since the
    fixed-point splat), wall time and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    N, P = SC_N, SC_P
    pts, vals = sc["pts"].reshape(1, P, 3), sc["vals"].reshape(1, 1, P)
    grid7 = affine_grid(sc["mat"], (N,) * 3).reshape(1, -1, 3)
    ct7 = cotangent((1, 1, N ** 3), 52)
    for name, fn in [
            ("sc_push 1M points in 256^3, order 1, dct2, extrapolate",
             lambda: splat_kernel(vals, pts, (N,) * 3,
                                  ((1,) * 3, (3,) * 3, 1), "sc_push")),
            ("sc_push 1M points in 256^3, cubic, dct2, extrapolate",
             lambda: splat_kernel(vals, pts, (N,) * 3, SC_OPTS, "sc_push")),
            ("P7 reslice splat, 256^3 points onto 256^3, cubic, dct2",
             lambda: splat_kernel(ct7, grid7, (N,) * 3,
                                  ((3,) * 3, (3,) * 3, 0), "sc_push"))]:
        reps = 5
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / reps * 1e3
        pieces, busy, wait = {}, 0.0, 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms = e.self_device_time_total / reps / 1e3
                piece = splat_piece(e.key)
                pieces[piece] = pieces.get(piece, 0.0) + ms
                busy += ms
            elif e.key == "cudaStreamSynchronize":
                wait += e.cpu_time_total / reps / 1e3
        if busy == 0:
            log(f"splat profile {name}: no device time in the trace (not "
                f"measured)")
            continue
        log(f"splat profile {name}: wall {wall:.3f} ms per call (profiler "
            f"on), device busy {busy:.3f} ms, idle "
            f"{100 * (1 - busy / wall):.1f} %, host waits {wait:.3f} ms in "
            f"cudaStreamSynchronize; device ms: "
            + "; ".join(f"{k} {v:.4f}" for k, v in
                        sorted(pieces.items(), key=lambda kv: -kv[1]))
            + f" [{card}]")


def short(kernel_name: str) -> str:
    for prefix in ("void ", "(anonymous namespace)::", "at::native::"):
        kernel_name = kernel_name.replace(prefix, "")
    return kernel_name[:60]


def phase_profile(train, ad) -> None:
    """Device busy time per step, its idle share and the heaviest kernels
    of ``train_step``, ``svf_train_step`` and one step of the finest
    (256^3) pyramid level (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    model, svf = train["model"], train["svf"]
    moving, fixed = train["moving"], train["fixed"]
    for name, fn, reps in [
            ("train_step", lambda: train_step(model, moving, fixed), 5),
            ("svf_train_step jac_weight 0.1",
             lambda: svf_train_step(svf, moving, fixed, jac_weight=0.1), 3),
            ("P9 finest pyramid level, one run_level step (adaptive)",
             lambda: pyramid.run_level(ad["finest"], ad["params"],
                                       ad["mov"], ad["fix"], 1), 5)]:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / reps / 1e3
        if busy == 0:
            log(f"profile {name}: no device time in the trace (not "
                f"measured)")
            continue
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        ops = sum(e.count for e in kernels) // reps
        log(f"profile {name} {MAIN_VOL}: wall {wall:.3f} ms/step (profiler "
            f"on), device busy {busy:.3f} ms/step, idle "
            f"{100 * (1 - busy / wall):.1f} %, {ops} device ops/step; "
            f"heaviest: " + "; ".join(
                f"{short(e.key)} {e.self_device_time_total / reps / 1e3:.3f}"
                f" ms x{e.count // reps}" for e in top))


def main() -> None:
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    errs = {m: 0.0 for m in ALL_MODES}
    drive = Drive()
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - clock[0]:.1f} s")
        clock[0] = now
    phase_kernels(errs)
    lap("kernels")
    phase_sc_kernels(errs)
    lap("scattered kernels")
    phase_adaptive_kernels(errs)
    lap("adaptive kernels")
    phase_faults(errs)
    lap("faults")
    phase_train_small()
    lap("small train steps")
    main_path = phase_main(errs, drive)
    train = phase_train_main(errs, drive)
    lap("main path, P2-P4")
    sc = phase_sc_main(errs, drive)
    lap("P5-P7")
    phase_sc_public(card, errs, drive, sc)
    lap("P13")
    ad = phase_adaptive_main(card, errs, drive, train)
    lap("P8-P10")
    phase_prefilter_labels(card, errs, drive, train, sc)
    lap("P11")
    phase_multidevice(card, errs, drive, main_path, sc)
    lap("P12")
    phase_lab_kernels()
    lab_rows = phase_lab(card)
    lap("kernel lab")
    times = phase_times(card, errs, main_path, train)
    lap("dense times")
    times.update(phase_sc_times(card, errs, sc))
    lap("scattered times")
    times.update(phase_adaptive_times(card, errs, ad, train))
    lap("adaptive times")
    library = phase_library(card, main_path, sc, ad)
    phase_splat_profile(card, sc)
    phase_profile(train, ad)
    lap("library and profile")
    missing = [m for m in ALL_MODES if drive.total[m] == 0]
    if missing:
        raise AssertionError(f"modes never launched on a main path: "
                             f"{missing}")

    def row(m):
        if m in SC_MODES:
            src_, line = ("gather.cu", "scattered.py:324") if m in GATHER \
                else ("splat.cu", "scattered.py:997")
            name = m
        else:
            src_ = "push.cu" if m.startswith("push") else "warp.cu"
            line = "pallas_warp.py:619" if src_ == "push.cu" \
                else "pallas_warp.py:160"
            name = m if src_ == "push.cu" else f"warp_{m}"
        return {"name": name, "route": "cuda",
                "source": f"interpol_tpu_torch/csrc/{src_}",
                "replaces": f"interpol_tpu/ops/{line}",
                "launches": drive.total[m], "max_abs_err": errs[m],
                **times[m], "library_ms": library.get(m, (None,))[0],
                "kernel_ms_order1": library.get(m, (None, None))[1]}
    kernels = [row(m) for m in ALL_MODES] + list(lab_rows.values())
    missing = [r["name"] for r in kernels if not r["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")
    log(f"total run time {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
