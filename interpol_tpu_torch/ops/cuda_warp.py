"""Wrappers of the dense-warp CUDA kernels (``csrc/warp.cu``,
``csrc/push.cu``).

The Hopper counterparts of ``interpol_tpu/ops/pallas_warp.py``:
``_warp_kernel`` in value, grad and hess modes (``warp_cuda``,
``hess_cuda``) and ``_push_kernel`` in plain and deriv modes
(``push_cuda``); see the notes at the top of the sources.  Their plain
PyTorch versions are ``ops/window.py``'s ``_pull_impl_torch``,
``_grad_impl_torch``, ``_hess_impl_torch``, ``_push_impl_torch`` and
``_pushgrad_impl_torch``, a different formulation (shift-FMA), so
comparing the two on the card is a real check.

``spread`` selects the adaptive mode of the TPU kernels (1d, 2c): the
wrapper computes the per-tile bases once, on the card (``ops/tiles.py``,
the same function the plain versions call), and hands the kernel three
int32 base arrays and the TPU tile; the kernel shifts each sample's window
test by its tile's base, a runtime branch with no template of its own.
The push's patch then covers the union of the residual windows.  The
JAX package's chunked mode (sub-windows under the TPU's VMEM cap, whose
launches sum) has no counterpart: one launch takes any window.

The push is the race-free patch splat (``csrc/patch_splat.cuh``, host
half in ``ops/_patch.py``): two runs give the same bits.

Each wrapper takes CUDA float32 contiguous tensors only and raises on
anything else; it never falls back to the plain version.  It also raises
when grad mode is on and an input requires grad: a direct call would lose
that gradient (the autograd Functions of ``ops/window.py`` call the
wrappers with detached tensors).  Each launch adds one to ``LAUNCHES``
and to its mode in ``LAUNCHES_BY_MODE``, so a run can show that it went
through the kernels.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ._patch import PatchGeom, patch_geom
from .tiles import lifted_tile, tile_bases
from .window import _md_tuple, window_range

__all__ = ["warp_cuda", "hess_cuda", "push_cuda", "warp_block",
           "LAUNCHES", "LAUNCHES_BY_MODE", "reset_launches"]

LAUNCHES = 0
LAUNCHES_BY_MODE: Dict[str, int] = {
    "value": 0, "grad": 0, "value+grad": 0, "hess": 0, "push": 0,
    "pushgrad": 0, "value_ad": 0, "grad_ad": 0, "value+grad_ad": 0,
    "hess_ad": 0, "push_ad": 0, "pushgrad_ad": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_MODE:
        LAUNCHES_BY_MODE[k] = 0


def _count(mode: str, adaptive: bool) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode + ("_ad" if adaptive else "")] += 1


class _WarpParams(ctypes.Structure):
    """Mirror of ``struct WarpParams`` in ``csrc/spline_taps.cuh``."""
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
        ("base", ctypes.c_void_p * 3),
        ("tile", ctypes.c_int * 3),
        ("ntile", ctypes.c_int * 3),
        ("block", ctypes.c_int * 3),
    ]


def warp_block(shape3: Sequence[int]) -> Tuple[int, int, int]:
    """log2 of the dense gather's block tile (x, y, z) over a 3-D (lifted)
    volume: z takes up to 32 voxels (128 for a lifted 1-D volume), then y
    and x grow in turn up to 8 each, within 256 threads and the volume's
    own extent.  Every extent is a power of two that divides the TPU tile
    of its axis (8, 8, and 128 or the full z span; ``ops/tiles.py``), so
    a block aligned on its extent lies inside one TPU tile and shares its
    adaptive base."""
    def clog2(n):
        return max(int(n) - 1, 0).bit_length()
    X, Y, Z = shape3
    lz = min(7 if X == Y == 1 else 5, clog2(Z))
    cap = [min(3, clog2(X)), min(3, clog2(Y))]
    lxy = [0, 0]
    for _ in range(8 - lz):
        # grow y first, then alternate: 2 x 4 x 32 at 256^3
        d = 1 if lxy[1] <= lxy[0] else 0
        if lxy[d] >= cap[d]:
            d = 1 - d
        if lxy[d] >= cap[d]:
            break
        lxy[d] += 1
    return lxy[0], lxy[1], lz


_fns = {}


def _entry(name: str):
    """``interpol_warp`` (csrc/warp.cu) or ``interpol_push``
    (csrc/push.cu), built at first use."""
    if name not in _fns:
        from ._build import load_library
        vp, i = ctypes.c_void_p, ctypes.c_int
        if name == "warp":
            fn = load_library("warp").interpol_warp
            fn.argtypes = [vp, vp, vp, vp, vp, ctypes.POINTER(_WarpParams),
                           i, i, i, vp]
        else:
            fn = load_library("push").interpol_push
            fn.argtypes = [vp, vp, vp, vp, ctypes.POINTER(_WarpParams),
                           ctypes.POINTER(PatchGeom), i, vp]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _lift3(inp, grid, orders, bounds, md, deriv=False):
    """Lift a D<3 dense warp to 3-D with leading dummy axes (order 0, zero
    displacement, replicate bound, window span 1), as the JAX package's
    ``window._lift3`` does.  ``deriv``: ``inp`` carries a trailing
    per-axis component dim (pushgrad cotangents), zero on the dummy axes.
    Copies the grid once."""
    D = grid.shape[-1]
    nd = 3 - D
    B = grid.shape[0]
    zeros = grid.new_zeros(grid.shape[:-1] + (nd,))
    grid = torch.cat([zeros, grid], dim=-1)
    grid = grid.reshape((B,) + (1,) * nd + tuple(grid.shape[1:]))
    lead = tuple(inp.shape[:2]) + (1,) * nd
    if deriv:
        inp = torch.cat([inp.new_zeros(inp.shape[:-1] + (nd,)), inp], -1)
    inp = inp.reshape(lead + tuple(inp.shape[2:]))
    return (inp, grid, (0,) * nd + tuple(orders), (1,) * nd + tuple(bounds),
            (0.0,) * nd + md, nd)


def _launch_setup(name, inp, grid, orders, bounds, extrapolate, max_disp,
                  spread=None, deriv=False, push=False, block=None):
    """Check the inputs, lift 1-D/2-D to 3-D and fill the kernel
    parameters; in adaptive mode (``spread``) compute the tile bases of
    the pull family's tiles or, with ``push``, of the push's.  ``block``:
    the dense gather's block tile (log2 per axis of the lifted volume),
    :func:`warp_block`'s by default.  Returns
    (inp3, grid3, params, nd, bases), or None when there is nothing to
    compute; keep ``bases`` alive until the kernel has run."""
    _check_inputs(name, inp, grid, deriv)
    D = grid.shape[-1]
    orders = tuple(int(o) for o in orders)
    bounds = tuple(int(b) for b in bounds)
    if len(orders) != D or len(bounds) != D:
        raise ValueError(f"{name}: one order and one bound per axis")
    if not all(0 <= o <= 7 for o in orders) \
            or not all(0 <= b <= 6 for b in bounds):
        raise ValueError(f"{name}: orders {orders} / bounds {bounds} "
                         f"out of range")
    md = _md_tuple(max_disp, D)
    B, C = inp.shape[:2]
    ishape = tuple(grid.shape[1:-1])
    if B * C * math.prod(ishape) == 0:
        return None
    bases = None
    if spread is not None:
        tile = lifted_tile(ishape, push)
        bases = tile_bases(grid, md, tile)      # (B, *ntiles, D) int32
        window = _md_tuple(spread, D)
    else:
        window = md
    nd = 0
    if D < 3:
        inp, grid, orders, bounds, md, nd = _lift3(inp, grid, orders,
                                                   bounds, md, deriv)
        window = (0.0,) * nd + window
    shape3 = tuple(grid.shape[1:4])
    p = _WarpParams()
    p.B, p.C = B, C
    thr = 0.05 if extrapolate == 0 else 0.55
    for d in range(3):
        smin, smax = window_range(orders[d], window[d])
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
    if block is not None and (len(block) != 3 or sum(block) > 8
                              or min(block) < 0):
        raise ValueError(f"{name}: block {block}: three log2 extents of "
                         f"at most 256 threads")
    p.block[:] = tuple(block) if block is not None else warp_block(shape3)
    if bases is not None:
        # (3, B, *ntiles3): the lifted axes are one tile of base 0
        tile3 = (1,) * nd + tuple(tile)
        nt3 = (1,) * nd + tuple(bases.shape[1:-1])
        bases = torch.cat([bases.new_zeros(bases.shape[:-1] + (nd,)),
                           bases], -1).reshape((B,) + nt3 + (3,))
        bases = torch.movedim(bases, -1, 0).contiguous()
        for d in range(3):
            p.base[d] = bases[d].data_ptr()
            p.tile[d] = tile3[d]
            p.ntile[d] = nt3[d]
    return inp, grid, p, nd, bases


def _call(name, t, *args):
    """Launch on ``t``'s device and current stream; raise on a refusal."""
    fn = _entry(name)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"interpol_{name} launch failed: cudaError_t "
                           f"{err}")


def warp_cuda(inp: torch.Tensor, grid: torch.Tensor,
              orders: Sequence[int], bounds: Sequence[int],
              extrapolate: int, max_disp, spread=None, value: bool = True,
              grad: bool = False, block=None
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Dense-warp pull and/or spatial gradient on the card.

    inp (B, C, *ishape) and grid (B, *ishape, D), D in 1..3, both CUDA,
    float32, contiguous.  Returns ``(val, grad)``: ``val`` (B, C, *ishape)
    if ``value`` else None, ``grad`` (B, C, *ishape, D) if ``grad`` else
    None.  Same semantics as ``window._pull_impl_torch`` /
    ``_grad_impl_torch``; ``spread``: the adaptive mode (1d).  ``block``:
    the block tile, log2 per axis (the schedule knob the kernel lab
    sweeps; :func:`warp_block`'s by default, and with a base per block the
    adaptive mode needs a block inside one TPU tile).
    """
    if not (value or grad):
        raise ValueError("nothing to compute")
    setup = _launch_setup("warp_cuda", inp, grid, orders, bounds,
                          extrapolate, max_disp, spread, block=block)
    B, C = inp.shape[:2]
    ishape = tuple(inp.shape[2:])
    D = len(ishape)
    val = inp.new_empty((B, C) + ishape) if value else None
    gout = inp.new_empty((B, C) + ishape + (D,)) if grad else None
    if setup is None:
        return val, gout
    inp3, grid3, p, nd, _bases = setup
    # the lifted gradient has 3 components; the kernel writes it whole
    g3 = gout if nd == 0 or not grad \
        else inp.new_empty(tuple(inp3.shape) + (3,))
    _call("warp", inp3, inp3.data_ptr(), grid3.data_ptr(),
          val.data_ptr() if value else None,
          g3.data_ptr() if grad else None, None, ctypes.byref(p),
          int(value), int(grad), 0)
    _count("value+grad" if value and grad else ("value" if value
                                                else "grad"),
           spread is not None)
    if grad and nd:
        gout.copy_(g3[..., nd:].reshape(gout.shape))
    return val, gout


def hess_cuda(inp: torch.Tensor, grid: torch.Tensor,
              orders: Sequence[int], bounds: Sequence[int],
              extrapolate: int, max_disp, spread=None) -> torch.Tensor:
    """Dense-warp spatial Hessian on the card: inp (B, C, *ishape), grid
    (B, *ishape, D) -> (B, C, *ishape, D, D), symmetric.  Same semantics
    as ``window._hess_impl_torch``; inputs as :func:`warp_cuda`."""
    setup = _launch_setup("hess_cuda", inp, grid, orders, bounds,
                          extrapolate, max_disp, spread)
    ishape = tuple(inp.shape[2:])
    D = len(ishape)
    out = inp.new_empty(tuple(inp.shape) + (D, D))
    if setup is None:
        return out
    inp3, grid3, p, nd, _bases = setup
    h3 = out if nd == 0 else inp.new_empty(tuple(inp3.shape) + (3, 3))
    _call("warp", inp3, inp3.data_ptr(), grid3.data_ptr(), None, None,
          h3.data_ptr(), ctypes.byref(p), 0, 0, 1)
    _count("hess", spread is not None)
    if nd:
        # cut the dummy rows and columns
        out.copy_(h3[..., nd:, nd:].reshape(out.shape))
    return out


# site tile of the push: 8^3 sites, a 19^3 patch (27 KB) at cubic order and
# max_disp=4.  In adaptive mode an 8^3 tile at a multiple of 8 lies inside
# one (8, 8, 128) tile of the TPU push, whose base it shares.
PUSH_TILE = 8


def push_cuda(inp: torch.Tensor, grid: torch.Tensor,
              orders: Sequence[int], bounds: Sequence[int],
              extrapolate: int, max_disp, spread=None, deriv: bool = False
              ) -> torch.Tensor:
    """Dense-warp splat on the card, the adjoint of :func:`warp_cuda`.

    Plain: values inp (B, C, *ishape) at the sites of grid (B, *ishape,
    D) -> volume (B, C, *ishape).  ``deriv`` (pushgrad, the adjoint of
    the gradient): inp (B, C, *ishape, D) -> (B, C, *ishape).  Same
    semantics as ``window._push_impl_torch`` / ``_pushgrad_impl_torch``;
    race-free, so two runs give the same bits.  Takes a scratch buffer of
    the site tiles' patches (C x B x tiles x patch floats).  ``spread``:
    the adaptive mode (2c); the patch then spans the union of the
    residual windows, ``ceil(max_disp)`` wider on each side.
    """
    name = "push_cuda"
    setup = _launch_setup(name, inp, grid, orders, bounds, extrapolate,
                          max_disp, spread, deriv, push=True)
    B, C = inp.shape[:2]
    ishape = tuple(grid.shape[1:-1])
    out = inp.new_empty((B, C) + ishape)
    if setup is None:
        return out.zero_()
    inp3, grid3, p, nd, bases = setup
    shape3 = tuple(p.shape)
    tile = tuple(min(PUSH_TILE, n) for n in shape3)
    # the largest base on each axis widens the patch (0 in plain mode)
    reach = (0,) * 3 if bases is None else (0,) * nd + tuple(
        math.ceil(m) for m in _md_tuple(max_disp, 3 - nd))
    lo = tuple(p.d0min[d] - reach[d] for d in range(3))
    extent = tuple(t + p.d0max[d] + p.order[d] + reach[d] - lo[d]
                   for d, t in enumerate(tile))
    geom, scratch, tables = patch_geom(B, C, shape3, tuple(p.bound), tile,
                                       lo, extent, inp.device)
    _call("push", inp3, inp3.data_ptr(), grid3.data_ptr(),
          scratch.data_ptr(), out.data_ptr(), ctypes.byref(p),
          ctypes.byref(geom), int(deriv))
    _count("pushgrad" if deriv else "push", spread is not None)
    return out


def _check_inputs(name, inp, grid, deriv=False):
    """Raise on anything the kernels do not take."""
    for arg, t in (("inp", inp), ("grid", grid)):
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
                f"ops/window.py functions, or run under torch.no_grad()")
    D = grid.shape[-1]
    if not 1 <= D <= 3:
        raise NotImplementedError(f"{name}: {D}-D warps (1-3 only)")
    ishape = tuple(grid.shape[1:-1])
    want = (grid.shape[0], inp.shape[1] if inp.ndim > 1 else -1) + ishape \
        + ((D,) if deriv else ())
    if grid.ndim != D + 2 or tuple(inp.shape) != want:
        layout = "(B, C, *ishape, D)" if deriv else "(B, C, *ishape)"
        raise ValueError(
            f"{name}: need inp {layout} and grid (B, *ishape, D); got "
            f"{tuple(inp.shape)} and {tuple(grid.shape)}")
    if inp.device != grid.device:
        raise ValueError(f"{name}: inp on {inp.device}, grid on "
                         f"{grid.device}")
