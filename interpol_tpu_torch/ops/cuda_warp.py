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
The push's site tiles then lie inside one TPU tile, and each tile's patch
spans the residual window of the tile's base.  The
JAX package's chunked mode (sub-windows under the TPU's VMEM cap, whose
launches sum) has no counterpart: one launch takes any window.

The push is the fixed-point splat (``csrc/fixed_splat.cuh``, host half
in ``ops/_fixed.py``): its taps are int64 integers, whose sums do not
depend on their order, so two runs, and any two site tiles, give the same
bits.

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
import itertools
import math
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import torch

from ._fixed import SplatGeom, workspace
from .tiles import lifted_tile, tile_bases
from .window import _md_tuple, window_range

__all__ = ["warp_cuda", "hess_cuda", "push_cuda", "warp_block",
           "push_tile", "LAUNCHES", "LAUNCHES_BY_MODE", "reset_launches"]

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
            fn.argtypes = [vp, vp, ctypes.c_longlong, vp, vp, vp,
                           ctypes.POINTER(_WarpParams),
                           ctypes.POINTER(SplatGeom), i, vp]
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


# shared memory a push block's patch may take (int64 cells and the fold
# tables): four blocks of 256 threads per SM of the H100 (228 KB an SM).
# Chosen in turns (PERF.md §6, PR 10): at 256^3 cubic max_disp=4 the tile
# (8, 8, 8) (a 55 KB patch) takes 2.119 ms, (4, 8, 16) (62 KB, three blocks
# an SM) 2.640, (8, 16, 16) (111 KB, two) 2.849, (16, 16, 16) (157 KB,
# one) 4.588
PATCH_BYTES = 56 * 1024
# where no tile's patch fits PATCH_BYTES (a wide window: span 19 at cubic
# max_disp=8 needs 64 KB for one site), the budget of the second try
WIDE_BYTES = 227 * 1024
# sites of a tile at most (16 per thread of a 256-thread block)
_TILE_SITES = 4096


def _patch_bytes(E) -> int:
    """Shared memory of a patch of extents E (``patch_bytes``)."""
    return 8 * math.prod(E) + 5 * sum(E)


@lru_cache(maxsize=256)
def push_tile(shape3: Tuple[int, int, int], span: Tuple[int, int, int],
              budgets: Tuple[int, ...] = (PATCH_BYTES, WIDE_BYTES),
              cap=None):
    """(site tile, patch extents) of the dense push over a (lifted) 3-D
    volume whose taps reach ``span`` cells beyond a tile on each axis (the
    window's shifts): powers of two per axis up to the axis (and up to
    ``cap``, a power of two per axis), at most 4096 sites, the patch (tile
    + span) in the first of ``budgets`` (bytes) that some tile's patch
    fits; the most sites, then the smallest patch, then the longest z.
    Patch None when no tile's patch fits the last budget (or with no
    budget): each tap then goes straight to the accumulator, over the
    tiles of the most sites."""
    def pows(n, c):
        return [1 << i for i in range(13)
                if (1 << i) < 2 * n and (c is None or (1 << i) <= c)]
    cap = (None,) * 3 if cap is None else cap
    tiles = []
    for T in itertools.product(*(pows(n, c) for n, c in zip(shape3, cap))):
        if math.prod(T) <= _TILE_SITES:
            E = tuple(t + s for t, s in zip(T, span))
            sites = math.prod(min(t, n) for t, n in zip(T, shape3))
            tiles.append(((sites, -_patch_bytes(E), T[2], T[1]), T, E))
    for budget in budgets:
        fit = [t for t in tiles if -t[0][1] <= budget]
        if fit:
            _, T, E = max(fit)
            return T, E
    return max(tiles)[1], None


def push_cuda(inp: torch.Tensor, grid: torch.Tensor,
              orders: Sequence[int], bounds: Sequence[int],
              extrapolate: int, max_disp, spread=None, deriv: bool = False,
              tile=None) -> torch.Tensor:
    """Dense-warp splat on the card, the adjoint of :func:`warp_cuda`.

    Plain: values inp (B, C, *ishape) at the sites of grid (B, *ishape,
    D) -> volume (B, C, *ishape).  ``deriv`` (pushgrad, the adjoint of
    the gradient): inp (B, C, *ishape, D) -> (B, C, *ishape).  Same
    semantics as ``window._push_impl_torch`` / ``_pushgrad_impl_torch``
    up to the fixed point's rounding; two runs give the same bits.  The
    scale of a slice (b, c) sums |v| over the sites that the splat keeps
    (the extrapolation mask and the window test), so a masked or dropped
    site adds nothing whatever its value (1e30, inf or NaN); a non-finite
    value of a kept site makes the whole slice NaN.  Takes an int64
    accumulator, twice the output; any B and C.
    ``spread``: the adaptive mode (2c); a site tile then lies inside one
    TPU tile and its patch spans the residual window of that tile's base.
    ``tile``: the site tile of the lifted volume (:func:`push_tile`'s by
    default; ``(0, 0, 0)``: no patch, every tap straight to the
    accumulator); the bits do not depend on it.
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
    # in adaptive mode a site tile lies inside one TPU tile (a power of two
    # that divides it), so its sites share a base and its patch, the window
    # of that base, moves with it
    cap = None if bases is None else tuple(p.tile)
    lo = tuple(p.d0min)
    span = tuple(p.d0max[d] + p.order[d] - lo[d] for d in range(3))
    if tile is None:
        T, E = push_tile(shape3, span, cap=cap)
    elif tuple(tile) == (0, 0, 0):
        T, E = push_tile(shape3, span, (), cap)
    else:
        T = tuple(max(1, min(int(t), n)) for t, n in zip(tile, shape3))
        E = tuple(t + s for t, s in zip(T, span))
        if _patch_bytes(E) > 227 * 1024 or (cap is not None and any(
                c % t for c, t in zip(cap, T))):
            raise ValueError(f"{name}: tile {tuple(tile)}: its patch {E} "
                             f"exceeds shared memory, or it does not "
                             f"divide the adaptive tile {cap}")
    g = SplatGeom()
    for d in range(3):
        g.T[d], g.lo[d] = T[d], lo[d]
        g.E[d] = 0 if E is None else E[d]
        g.NB[d] = -(-shape3[d] // T[d])
    ws = workspace(B * C, math.prod(shape3), B, math.prod(shape3),
                   inp.device)
    _call("push", inp3, inp3.data_ptr(), inp.data_ptr(),
          inp.numel() // (B * C), grid3.data_ptr(), ws.data_ptr(),
          out.data_ptr(), ctypes.byref(p), ctypes.byref(g), int(deriv))
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
