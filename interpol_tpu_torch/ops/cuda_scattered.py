"""Wrappers of the scattered CUDA kernels (``csrc/gather.cu``,
``csrc/splat.cu``).

The Hopper counterparts of ``interpol_tpu/ops/scattered.py``:
``_gather_kernel`` in value, grad, hess, value+grad and grad+hess modes
(``gather_cuda``) and ``_splat_kernel`` in push, pushgrad and pushhess
specs (``splat_cuda``); see the notes at the top of the sources.  Their
plain PyTorch versions are ``ops/ndkernels.py``'s ``pull_core``,
``grad_core``, ``hess_core``, ``push_core``, ``pushgrad_core`` and
``pushhess_core``.  The host half of the tier (3-D lift, box schedule) is
``ops/scattered.py``.

Conventions of ``ops/cuda_warp.py``: CUDA float32 contiguous tensors only,
anything else raises, nothing falls back to a plain version; an input that
requires grad raises while grad mode is on; the launch runs on the current
stream.  Each call adds one to ``LAUNCHES_BY_MODE`` under its mode.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ._fixed import SplatGeom, workspace
from .scattered import box_schedule, lift3, splat_box, splat_margins

__all__ = ["gather_cuda", "splat_cuda", "LAUNCHES_BY_MODE",
           "reset_launches", "SPECS"]

LAUNCHES_BY_MODE: Dict[str, int] = {
    "sc_value": 0, "sc_grad": 0, "sc_hess": 0, "sc_value+grad": 0,
    "sc_grad+hess": 0, "sc_push": 0, "sc_pushgrad": 0, "sc_pushhess": 0}

# splat specs: kernel template number and value rows
SPECS = {"push": (0, 1), "pushgrad": (1, 3), "pushhess": (2, 6)}


def reset_launches() -> None:
    for k in LAUNCHES_BY_MODE:
        LAUNCHES_BY_MODE[k] = 0


class _PointParams(ctypes.Structure):
    """Mirror of ``struct PointParams`` in ``csrc/spline_taps.cuh``."""
    _fields_ = [
        ("B", ctypes.c_longlong),
        ("C", ctypes.c_longlong),
        ("P", ctypes.c_longlong),
        ("shape", ctypes.c_int * 3),
        ("order", ctypes.c_int * 3),
        ("bound", ctypes.c_int * 3),
        ("thr_hi", ctypes.c_float * 3),
        ("thr_lo", ctypes.c_float),
        ("masked", ctypes.c_int),
    ]


_fns = {}


def _entry(name: str):
    """``interpol_gather`` (csrc/gather.cu) or ``interpol_splat``
    (csrc/splat.cu), built at first use."""
    if name not in _fns:
        from ._build import load_library
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pp = ctypes.POINTER(_PointParams)
        lib = load_library("gather" if name == "gather" else "splat")
        fn = getattr(lib, f"interpol_{name}")
        fn.argtypes = {
            "gather": [vp, vp, vp, vp, vp, pp, i, i, i, vp],
            "splat": [vp, vp, vp, vp, ll, vp, vp, vp, vp, pp,
                      ctypes.POINTER(SplatGeom), i, vp],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _call(name, t, *args):
    """Launch on ``t``'s device and current stream; raise on a refusal."""
    fn = _entry(name)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"interpol_{name} launch failed: cudaError_t "
                           f"{err}")


def _check(name, tensors, grid, orders, bounds):
    for arg, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel "
                            f"takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name}: {arg} requires grad, and a direct kernel call "
                f"would lose that gradient; call the differentiable "
                f"ops/pushpull.py functions, or run under torch.no_grad()")
        if t.device != grid.device:
            raise ValueError(f"{name}: {arg} on {t.device}, grid on "
                             f"{grid.device}")
    if grid.ndim != 3 or not 1 <= grid.shape[-1] <= 3:
        raise ValueError(f"{name}: need grid (B, P, D), D in 1..3; got "
                         f"{tuple(grid.shape)}")
    D = grid.shape[-1]
    if len(orders) != D or len(bounds) != D \
            or not all(0 <= int(o) <= 7 for o in orders) \
            or not all(0 <= int(b) <= 6 for b in bounds):
        raise ValueError(f"{name}: one order in 0..7 and one bound in 0..6 "
                         f"per axis; got {orders}, {bounds}")


def _params(B, C, P, shape3, orders3, bounds3, extrapolate):
    p = _PointParams()
    p.B, p.C, p.P = B, C, P
    thr = 0.05 if extrapolate == 0 else 0.55
    for d in range(3):
        p.shape[d] = shape3[d]
        p.order[d] = int(orders3[d])
        p.bound[d] = int(bounds3[d])
        # the same float32 constants the plain mask compares against
        p.thr_hi[d] = float(torch.tensor((shape3[d] - 1) + thr,
                                         dtype=torch.float32))
    p.thr_lo = float(torch.tensor(-thr, dtype=torch.float32))
    p.masked = int(extrapolate != 1)
    return p


def gather_cuda(inp: torch.Tensor, grid: torch.Tensor,
                orders: Sequence[int], bounds: Sequence[int],
                extrapolate: int, value: bool = True, grad: bool = False,
                hess: bool = False
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """Scattered pull, spatial gradient and/or Hessian on the card.

    inp (B, C, *ishape), grid (B, P, D), D in 1..3.  Returns ``(val,
    grad, hess)``: (B, C, P), (B, C, P, D), (B, C, P, D, D), each None
    unless asked for.  Modes: value, grad, hess, value+grad, grad+hess.
    Same semantics as ``ndkernels.pull_core`` / ``grad_core`` /
    ``hess_core``.
    """
    name = "gather_cuda"
    mode = "+".join(m for m, on in (("value", value), ("grad", grad),
                                    ("hess", hess)) if on)
    if mode not in ("value", "grad", "hess", "value+grad", "grad+hess"):
        raise ValueError(f"{name}: no kernel mode {mode or 'none'}")
    _check(name, [("inp", inp), ("grid", grid)], grid, orders, bounds)
    B, P, D = grid.shape
    C = inp.shape[1]
    ishape = tuple(inp.shape[2:])
    if inp.ndim != D + 2 or inp.shape[0] != B:
        raise ValueError(f"{name}: need inp (B, C, *ishape) with {D} "
                         f"spatial axes; got {tuple(inp.shape)}")
    grid3, shape3, orders3, bounds3 = lift3(grid, ishape, orders, bounds)
    new = inp.new_empty
    val = new((B, C, P)) if value else None
    g3 = new((B, C, P, 3)) if grad else None
    h3 = new((B, C, P, 3, 3)) if hess else None
    if B * C * P and math.prod(ishape):
        p = _params(B, C, P, shape3, orders3, bounds3, extrapolate)
        _call("gather", inp, inp.data_ptr(), grid3.data_ptr(),
              val.data_ptr() if value else None,
              g3.data_ptr() if grad else None,
              h3.data_ptr() if hess else None, ctypes.byref(p),
              int(value), int(grad), int(hess))
        LAUNCHES_BY_MODE[f"sc_{mode}"] += 1
    g = g3[..., :D] if grad and D < 3 else g3
    h = h3[..., :D, :D] if hess and D < 3 else h3
    return (val, None if g is None else g.contiguous(),
            None if h is None else h.contiguous())


def _rows(vals, spec, D):
    """The splat's value rows (C, NV, B*P) from (B, C, P[, D[, D]])."""
    B, C, P = vals.shape[:3]
    if spec == "push":
        rows = vals[..., None]
    elif spec == "pushgrad":
        rows = torch.cat([vals, vals.new_zeros((B, C, P, 3 - D))], -1)
    else:
        full = vals.new_zeros((B, C, P, 3, 3))
        full[..., :D, :D] = vals
        rows = torch.stack(
            [full[..., 0, 0], full[..., 1, 1], full[..., 2, 2],
             full[..., 0, 1] + full[..., 1, 0],
             full[..., 0, 2] + full[..., 2, 0],
             full[..., 1, 2] + full[..., 2, 1]], -1)
    return rows.permute(1, 3, 0, 2).reshape(C, rows.shape[-1], B * P)


# The design of the scattered splat, fixed by the cloud (PERF.md §6, PR 10,
# in turns on the H100): the box design where a point has more than 32 taps
# and the cloud is sparser than BOX_DENSITY points per output voxel (1M
# random points in 256^3 at cubic order: box 1.165 ms, direct 1.654); the
# direct one elsewhere: few taps (order 1: direct 0.506, box 1.105) or a
# dense cloud, whose box sort costs more than its atomics save (P7's
# reslice, 16.7M points in order: direct 4.941, box 5.714).
BOX_TAPS = 32
BOX_DENSITY = 0.25


def splat_cuda(vals: torch.Tensor, grid: torch.Tensor,
               oshape: Sequence[int], orders: Sequence[int],
               bounds: Sequence[int], extrapolate: int,
               spec: str = "push", box=None) -> torch.Tensor:
    """Scattered splat on the card: the adjoint of :func:`gather_cuda` in
    the image.

    ``spec`` "push": vals (B, C, P); "pushgrad": (B, C, P, D); "pushhess":
    (B, C, P, D, D) (both triangles count); grid (B, P, D), D in 1..3 ->
    (B, C, *oshape).  Same semantics as ``ndkernels.push_core`` /
    ``pushgrad_core`` / ``pushhess_core`` up to the fixed point's rounding
    (``csrc/fixed_splat.cuh``); two runs give the same bits.  The scale of
    a slice (b, c) sums |v| over the points the mask keeps, so a masked
    point adds nothing whatever its value (1e30, inf or NaN); a
    non-finite value of a kept point, or a non-finite coordinate of a
    kept point of batch b, makes the whole slice NaN.  Takes an int64
    accumulator, twice the output (and a bit per point for a cloud of
    more than 32 points per output voxel and channel); no host sync; any
    B and C.  ``box``: the
    design, chosen by the taps per point and the cloud's density by
    default: ``False`` direct (every tap straight to the accumulator),
    ``True`` or a core per axis of the lifted volume the box design (the
    points sorted by box, a shared patch per box; ``splat_box``'s core for
    ``True``).  The bits do not depend on it.
    """
    name = "splat_cuda"
    if spec not in SPECS:
        raise ValueError(f"{name}: spec {spec!r} not in {tuple(SPECS)}")
    _check(name, [("vals", vals), ("grid", grid)], grid, orders, bounds)
    B, P, D = grid.shape
    extra = {"push": 0, "pushgrad": 1, "pushhess": 2}[spec]
    if vals.ndim != 3 + extra or tuple(vals.shape[:1]) + \
            tuple(vals.shape[2:]) != (B, P) + (D,) * extra:
        raise ValueError(f"{name}: {spec} needs vals (B, C, P"
                         f"{', D' * extra}); got {tuple(vals.shape)} for "
                         f"grid {tuple(grid.shape)}")
    C = vals.shape[1]
    oshape = tuple(int(s) for s in oshape)
    if len(oshape) != D:
        raise ValueError(f"{name}: oshape {oshape} for a {D}-D cloud")
    out = vals.new_empty((B, C) + oshape)
    if not (B * C * P and math.prod(oshape)):
        return out.zero_()
    grid3, shape3, orders3, bounds3 = lift3(grid, oshape, orders, bounds)
    kspec, _ = SPECS[spec]
    p = _params(B, C, P, shape3, orders3, bounds3, extrapolate)
    coords = orig = grid3.reshape(-1, 3)
    rows = _rows(vals, spec, D)
    g = SplatGeom()
    keys = seg = None
    if box is None:
        box = math.prod(o + 1 for o in orders3) > BOX_TAPS \
            and P < BOX_DENSITY * math.prod(shape3)
    if box is not False:
        box = splat_box(shape3, P) if box is True else tuple(
            max(1, min(int(t), n)) for t, n in zip(box, shape3))
        keys, perm, seg, nb = box_schedule(grid3, shape3, box, extrapolate)
        coords = coords.index_select(0, perm)
        rows = rows.index_select(2, perm)
        for d in range(3):
            lo, hi = splat_margins(orders3[d])
            g.T[d], g.lo[d], g.E[d], g.NB[d] = box[d], lo, box[d] + hi - lo, \
                nb[d]
    rows = rows.contiguous()
    ws = workspace(B * C, math.prod(shape3), B, P, vals.device)
    _call("splat", vals, coords.data_ptr(), rows.data_ptr(), orig.data_ptr(),
          vals.data_ptr(), vals.numel() // (B * C),
          None if keys is None else keys.data_ptr(),
          None if seg is None else seg.data_ptr(), ws.data_ptr(),
          out.data_ptr(), ctypes.byref(p), ctypes.byref(g), kspec)
    LAUNCHES_BY_MODE[f"sc_{spec}"] += 1
    return out
