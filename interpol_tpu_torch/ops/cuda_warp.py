"""Wrapper of the dense-warp CUDA kernel (``csrc/warp.cu``).

The Hopper counterpart of ``interpol_tpu/ops/pallas_warp.py::_warp_kernel``
in value and gradient modes (see the note at the top of ``csrc/warp.cu``).
Its plain PyTorch version is ``ops/window.py::_pull_impl_torch`` /
``_grad_impl_torch``, a different formulation (shift-FMA), so comparing the
two on the card is a real check.

``warp_cuda`` takes CUDA float32 contiguous tensors only and raises on
anything else; it never falls back to the plain version.  Each launch adds
one to ``LAUNCHES`` (and to ``LAUNCHES_BY_MODE``), so a run can show that
it went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from .window import _md_tuple, window_range

__all__ = ["warp_cuda", "LAUNCHES", "LAUNCHES_BY_MODE", "reset_launches"]

LAUNCHES = 0
LAUNCHES_BY_MODE: Dict[str, int] = {"value": 0, "grad": 0, "value+grad": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_MODE:
        LAUNCHES_BY_MODE[k] = 0


class _WarpParams(ctypes.Structure):
    """Mirror of ``struct WarpParams`` in ``csrc/warp.cu``."""
    _fields_ = [
        ("B", ctypes.c_longlong),
        ("C", ctypes.c_longlong),
        ("shape", ctypes.c_int * 3),
        ("order", ctypes.c_int * 3),
        ("bound", ctypes.c_int * 3),
        ("d0min", ctypes.c_int * 3),
        ("d0max", ctypes.c_int * 3),
        ("thr_hi", ctypes.c_float * 3),
        ("thr_lo", ctypes.c_float),
        ("masked", ctypes.c_int),
    ]


_fn = None


def _entry():
    global _fn
    if _fn is None:
        from ._build import load_library
        fn = load_library().interpol_warp
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.POINTER(_WarpParams),
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _lift3(inp, grid, orders, bounds, md):
    """Lift a D<3 dense warp to 3-D with leading dummy axes (order 0, zero
    displacement, replicate bound, window span 1), as the JAX package's
    ``window._lift3`` does.  Copies the grid once."""
    D = grid.shape[-1]
    nd = 3 - D
    B = grid.shape[0]
    zeros = grid.new_zeros(grid.shape[:-1] + (nd,))
    grid = torch.cat([zeros, grid], dim=-1)
    grid = grid.reshape((B,) + (1,) * nd + tuple(grid.shape[1:]))
    inp = inp.reshape(tuple(inp.shape[:2]) + (1,) * nd
                      + tuple(inp.shape[2:]))
    return (inp, grid, (0,) * nd + tuple(orders), (1,) * nd + tuple(bounds),
            (0.0,) * nd + md, nd)


def warp_cuda(inp: torch.Tensor, grid: torch.Tensor,
              orders: Sequence[int], bounds: Sequence[int],
              extrapolate: int, max_disp, value: bool = True,
              grad: bool = False
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Dense-warp pull and/or spatial gradient on the card.

    inp (B, C, *ishape) and grid (B, *ishape, D), D in 1..3, both CUDA,
    float32, contiguous, without ``requires_grad`` (the adjoint kernels are
    not ported yet).  Returns ``(val, grad)``: ``val`` (B, C, *ishape) if
    ``value`` else None, ``grad`` (B, C, *ishape, D) if ``grad`` else None.
    Same semantics as ``window._pull_impl_torch`` / ``_grad_impl_torch``.
    """
    global LAUNCHES
    if not (value or grad):
        raise ValueError("nothing to compute")
    _check_inputs(inp, grid)
    D = grid.shape[-1]
    orders = tuple(int(o) for o in orders)
    bounds = tuple(int(b) for b in bounds)
    if len(orders) != D or len(bounds) != D:
        raise ValueError("warp_cuda: one order and one bound per axis")
    if not all(0 <= o <= 7 for o in orders) \
            or not all(0 <= b <= 6 for b in bounds):
        raise ValueError(f"warp_cuda: orders {orders} / bounds {bounds} "
                         f"out of range")
    md = _md_tuple(max_disp, D)

    B, C = inp.shape[:2]
    ishape = tuple(inp.shape[2:])
    val = inp.new_empty((B, C) + ishape) if value else None
    gout = inp.new_empty((B, C) + ishape + (D,)) if grad else None
    nd = 0
    if D < 3:
        inp, grid, orders, bounds, md, nd = _lift3(inp, grid, orders,
                                                   bounds, md)
    if B * C * math.prod(ishape) == 0:
        return val, gout
    # the lifted gradient has 3 components; the kernel writes it whole
    g3 = gout if nd == 0 or not grad \
        else inp.new_empty((B, C) + tuple(inp.shape[2:]) + (3,))

    p = _WarpParams()
    p.B, p.C = B, C
    shape3 = tuple(inp.shape[2:])
    thr = 0.05 if extrapolate == 0 else 0.55
    for d in range(3):
        smin, smax = window_range(orders[d], md[d])
        p.shape[d] = shape3[d]
        p.order[d] = orders[d]
        p.bound[d] = bounds[d]
        p.d0min[d] = smin
        p.d0max[d] = smax - orders[d]
        # the same float32 constants the plain mask compares against
        p.thr_hi[d] = float(torch.tensor((shape3[d] - 1) + thr,
                                         dtype=torch.float32))
    p.thr_lo = float(torch.tensor(-thr, dtype=torch.float32))
    p.masked = int(extrapolate != 1)

    fn = _entry()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = fn(inp.data_ptr(), grid.data_ptr(),
                 val.data_ptr() if value else None,
                 g3.data_ptr() if grad else None,
                 ctypes.byref(p), int(value), int(grad), stream)
    if err != 0:
        raise RuntimeError(f"interpol_warp launch failed: cudaError_t {err}")
    LAUNCHES += 1
    mode = "value+grad" if value and grad else ("value" if value else "grad")
    LAUNCHES_BY_MODE[mode] += 1
    if grad and nd:
        gout.copy_(g3[..., nd:].reshape(gout.shape))
    return val, gout


def _check_inputs(inp, grid):
    """Raise on anything the kernel does not take."""
    for name, t in (("inp", inp), ("grid", grid)):
        if t.device.type != "cuda":
            raise ValueError(f"warp_cuda: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"warp_cuda: {name} is {t.dtype}; the kernel "
                            f"takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"warp_cuda: {name} is not contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                f"warp_cuda: {name} requires grad, but the adjoint kernels "
                f"are not ported yet; run under torch.no_grad()")
    D = grid.shape[-1]
    if not 1 <= D <= 3:
        raise NotImplementedError(f"warp_cuda: {D}-D warps (1-3 only)")
    if inp.ndim != D + 2 or grid.ndim != D + 2 \
            or tuple(inp.shape[2:]) != tuple(grid.shape[1:-1]) \
            or inp.shape[0] != grid.shape[0]:
        raise ValueError(
            f"warp_cuda: need inp (B, C, *ishape) and grid (B, *ishape, "
            f"D); got {tuple(inp.shape)} and {tuple(grid.shape)}")
    if inp.device != grid.device:
        raise ValueError(f"warp_cuda: inp on {inp.device}, grid on "
                         f"{grid.device}")
