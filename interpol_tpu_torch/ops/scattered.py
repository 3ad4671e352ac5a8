"""The scattered tier: the public functions on a point cloud, the box
helpers, and the host side of the kernels (the 3-D lift and the splat's
box schedule).

The PyTorch counterpart of ``interpol_tpu/ops/scattered.py``, with its
twelve public names and unbatched layouts: ``inp (C, *ishape)`` and
``grid (P, D)``, D in {1, 2, 3}; ``pull_scattered`` gives (C, P),
``grad_scattered`` (C, P, D), ``hess_scattered`` (C, P, D, D),
``push_scattered`` / ``pushgrad_scattered`` (C, *oshape) and
``count_scattered`` (1, *oshape).  Each wraps a Function of
``ops/pushpull.py`` with a batch of one, so a CUDA tensor runs kernel 3
(``csrc/gather.cu``) or kernel 4 (``csrc/splat.cu``), a CPU tensor the
plain cores, and autograd is the generic path's, to any order.

- **Boxes.**  ``DEFAULT_BOX``, ``MIN_POINTS``, ``auto_box``,
  ``auto_box_splat`` and ``box_geometry`` are plain copies of the JAX
  package's (``:113-211``): they size the TPU's box tables.  The Hopper
  kernels take any box and give the same result for every box, as the
  JAX tier does; ``box=`` is checked and otherwise unused.
- **Precomputed tables.**  Kernel 3 gathers its taps straight from the
  volume, so the per-volume build that ``pre=`` saves on the TPU (the
  ``(C, NB8, TAB)`` box windows) is here only the lift to 3-D, the cast
  to the working dtype and ``contiguous()``: ``precompute_tables`` returns
  that, ``(C, *ishape3)``.  JAX's contract holds: ``pre`` needs ``box``
  and its own shape (``ValueError`` otherwise), the values and the grid
  gradient read ``pre``, the input gradient goes to ``inp`` as push(ct)
  whatever ``pre`` holds, and ``pre`` gets no gradient.
- **interpret=** is kept for calls written for the JAX package: ``True``
  on a CPU tensor runs the plain cores, as a CPU tensor does anyway;
  ``True`` on a CUDA tensor raises, the port has no plain path on the
  card.
- **Lift.**  The kernels are 3-D.  A 1-D or 2-D cloud gains trailing
  size-1 axes with order 0, bound dct2 and coordinate exactly 0, as
  ``_lift_2d`` (``:946-962``) does: every point takes the single tap 0
  there, weight 1.
- **Box schedule** (the splat, ``_schedule`` ``:245-285``).  The output
  volume is cut into boxes of ``T^3`` voxels.  A point whose coordinates
  lie in ``[0, n-1]`` on every axis belongs to the box of ``floor(g)``;
  the points are sorted by box key with one ``torch.sort`` (stable: a box
  keeps its points in input order, so the splat's sums run in a fixed
  order), and ``searchsorted`` finds each box's segment.  The points
  outside ``[0, n-1]`` on some axis that the mask keeps are the
  *outliers*, one segment per batch after all boxes; masked points sort
  last and are never read.  The TPU's box ladder, 128-slot rows and
  overflow round work around Mosaic and are not carried over: a box here
  holds any number of points.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import pushpull as pp
from .ndkernels import inbounds_mask

__all__ = ["pull_scattered", "grad_scattered", "push_scattered",
           "count_scattered", "pushgrad_scattered", "hess_scattered",
           "box_geometry", "precompute_tables", "auto_box",
           "auto_box_splat", "DEFAULT_BOX", "MIN_POINTS",
           "lift3", "splat_margins", "splat_box", "box_schedule"]

# --------------------------------------------------------------- boxes
# The JAX package's box ladder (``scattered.py:113-211``): the TPU's box
# tables, sparse clouds on large cores and dense ones on small.
DEFAULT_BOX = (8, 8, 16)
_BOX_LADDER = [(16, 16, 32), (16, 16, 16), (8, 16, 16), (8, 8, 16),
               (8, 8, 8), (4, 8, 8), (4, 4, 8), (4, 4, 4)]
_TARGET_PER_BOX = 80.0
_BOX_LADDER_2D = [(64, 128), (64, 64), (32, 64), (32, 32), (16, 32),
                  (16, 16), (8, 16), (8, 8)]
_BOX_LADDER_1D = [(8192,), (4096,), (2048,), (1024,), (512,), (256,),
                  (128,), (64,)]
# the TPU tier's density threshold (the port runs its kernels for every
# number of points)
MIN_POINTS = 32768


def auto_box(ishape: Tuple[int, ...], P: int) -> Tuple[int, ...]:
    """The largest core of the ladder whose expected points per box stay
    under ``_TARGET_PER_BOX`` at this cloud's density; a size-1 trailing
    axis (the lift) gets core 1."""
    if len(ishape) >= 2 and ishape[-1] == 1:
        return auto_box(ishape[:-1], P) + (1,)
    rho = P / max(1, math.prod(ishape))
    ladder = {1: _BOX_LADDER_1D, 2: _BOX_LADDER_2D}.get(
        len(ishape), _BOX_LADDER)
    for b in ladder:
        if rho * math.prod(b) <= _TARGET_PER_BOX:
            return b
    return ladder[-1]


def auto_box_splat(oshape: Tuple[int, ...], P: int) -> Tuple[int, ...]:
    """The splat's core: :func:`auto_box`'s volume, shaped x-heavy (at
    most 8 along each of the last two axes)."""
    if len(oshape) >= 2 and oshape[-1] == 1:
        return auto_box_splat(oshape[:-1], P) + (1,)
    vol = math.prod(auto_box(oshape, P))
    if len(oshape) == 1:
        return (min(max(1, vol), int(oshape[0])),)
    if len(oshape) == 2:
        by = min(8, vol)
        return (min(max(1, vol // by), int(oshape[0])), by)
    bz = min(8, vol)
    by = min(8, max(1, vol // bz))
    bx = max(1, vol // (by * bz))
    return (min(bx, int(oshape[0])), by, bz)


def box_geometry(orders: Tuple[int, ...], box: Tuple[int, ...],
                 ishape: Optional[Tuple[int, ...]] = None):
    """Per-axis (margin_lo, extent) of the TPU's padded box and its flat
    table length TAB (a multiple of 128): extent ``B + 2*(order//2) + 1``,
    or 1 on a size-1 axis of order 0 and box 1 when ``ishape`` is given."""
    blo = tuple(o // 2 for o in orders)
    ns = ishape or (None,) * len(box)
    ext = tuple(1 if (n == 1 and o == 0 and b == 1)
                else b + 2 * (o // 2) + 1
                for b, o, n in zip(box, orders, ns))
    tab = -(-math.prod(ext) // 128) * 128
    return blo, ext, tab


# ---------------------------------------------------- public functions

def _shape3(ishape) -> Tuple[int, ...]:
    return tuple(ishape) + (1,) * (3 - len(ishape))


def _axes(name, D, **seqs):
    for arg, seq in seqs.items():
        if seq is not None and len(tuple(seq)) != D:
            raise ValueError(f"{name}: {arg} {tuple(seq)} for a {D}-D "
                             f"cloud")


def _prepare(name, t, grid, orders, bounds, extrapolate, box, interpret,
             spatial):
    """Check the arguments; return the generic path's options."""
    if grid.ndim != 2 or not 1 <= grid.shape[-1] <= 3:
        raise ValueError(f"{name}: need grid (P, D), D in 1..3; got "
                         f"{tuple(grid.shape)}")
    D = grid.shape[-1]
    _axes(name, D, orders=orders, bounds=bounds, box=box)
    if box is not None and not all(int(b) >= 1 for b in box):
        raise ValueError(f"{name}: box {tuple(box)} needs cores >= 1")
    if spatial != D:
        raise ValueError(f"{name}: {spatial} spatial axes for a {D}-D "
                         f"cloud")
    if interpret and (t.device.type == "cuda"
                      or grid.device.type == "cuda"):
        raise ValueError(f"{name}: interpret=True emulates the kernel with "
                         f"the plain cores, which run on CPU tensors only; "
                         f"on the card the kernel runs")
    return pp._opts(orders, bounds, extrapolate)


class _ReadPre(torch.autograd.Function):
    """``pre``'s values, with the gradient routed to ``inp``: the gathers
    read ``pre`` and their input cotangent (push(ct), pushgrad(ct), ...)
    reaches ``inp`` as if they had read it; ``pre`` gets none."""

    @staticmethod
    def forward(ctx, inp, pre):
        ctx.shape, ctx.dtype = inp.shape, inp.dtype
        return pre.reshape(inp.shape)

    @staticmethod
    def backward(ctx, ct):
        if not ctx.needs_input_grad[0]:
            return None, None
        return ct.reshape(ctx.shape).to(ctx.dtype), None


def _source(name, inp, grid, pre, box):
    """The volume the gathers read, (1, C, *ishape): ``inp``, or ``pre``
    read in its place (the contract of :func:`precompute_tables`)."""
    if pre is None:
        return inp[None]
    if box is None:
        raise ValueError(f"{name}: pre= (precomputed tables) requires the "
                         f"box they were built with")
    want = (inp.shape[0],) + _shape3(inp.shape[1:])
    if tuple(pre.shape) != want:
        raise ValueError(f"{name}: precomputed tables shape "
                         f"{tuple(pre.shape)} does not match {want}, the "
                         f"volume lifted to 3-D")
    wdtype = torch.promote_types(
        torch.promote_types(inp.dtype, grid.dtype), torch.float32)
    if pre.dtype != wdtype:
        pre = pre.to(wdtype)
    if pre.requires_grad:
        pre = pre.detach()
    if torch.is_grad_enabled() and inp.requires_grad:
        return _ReadPre.apply(inp, pre)[None]
    return pre[None] if pre.ndim == inp.ndim else \
        pre.reshape((1,) + tuple(inp.shape))


def _out_dtype(a, grid):
    return torch.promote_types(a.dtype, grid.dtype)


def precompute_tables(inp, orders, bounds, box):
    """What the gathers read for a volume that is sampled again and again
    (iterative registration, landmark tracking): ``inp`` (C, *ishape)
    lifted to 3-D (``(C, H, W)`` -> ``(C, H, W, 1)``), in the working
    dtype (float32 or above), contiguous.  Pass it as ``pre=`` to
    :func:`pull_scattered`, :func:`grad_scattered` or
    :func:`hess_scattered` with a ``box``.  The build is differentiable,
    but the functions give ``pre`` no gradient: the input gradient goes to
    their ``inp``."""
    D = inp.ndim - 1
    if not 1 <= D <= 3:
        raise ValueError(f"precompute_tables: need inp (C, *ishape) with "
                         f"1..3 spatial axes; got {tuple(inp.shape)}")
    _axes("precompute_tables", D, orders=orders, bounds=bounds, box=box)
    wdtype = torch.promote_types(inp.dtype, torch.float32)
    return inp.reshape((inp.shape[0],) + _shape3(inp.shape[1:])) \
        .to(wdtype).contiguous()


def _gathered(name, fn, inp, grid, orders, bounds, extrapolate, box,
              interpret, pre):
    """One of the generic path's gathers (``fn``) on a batch of one."""
    opts = _prepare(name, inp, grid, orders, bounds, extrapolate, box,
                    interpret, inp.ndim - 1)
    src = _source(name, inp, grid, pre, box)
    return fn(src, grid.contiguous()[None], opts)[0].to(
        _out_dtype(inp, grid))


def _splatted(name, fn, vals, grid, oshape, orders, bounds, extrapolate,
              box, interpret, trailing):
    """One of the generic path's splats (``fn``) of ``vals`` (C, P,
    *trailing) on a batch of one."""
    opts = _prepare(name, vals, grid, orders, bounds, extrapolate, box,
                    interpret, len(oshape))
    want = (grid.shape[0],) + trailing
    if vals.ndim != 1 + len(want) or tuple(vals.shape[1:]) != want:
        raise ValueError(f"{name}: need values (C, {', '.join(map(str, want))}"
                         f"); got {tuple(vals.shape)}")
    out = fn(vals[None], grid.contiguous()[None],
             tuple(int(n) for n in oshape), opts)
    return out[0].to(_out_dtype(vals, grid))


def pull_scattered(inp, grid, orders, bounds, extrapolate, *, box=None,
                   interpret=False, pre=None):
    """(C, *ishape), (P, D) -> (C, P), D in (1, 2, 3): the spline surface
    of ``inp`` sampled at the points.  Semantics of
    ``ndkernels.pull_core``; ``pre``: see :func:`precompute_tables`."""
    return _gathered("pull_scattered", pp._pull, inp, grid, orders, bounds,
                     extrapolate, box, interpret, pre)


def grad_scattered(inp, grid, orders, bounds, extrapolate, *, box=None,
                   interpret=False, pre=None):
    """(C, *ishape), (P, D) -> (C, P, D), D in (1, 2, 3): the spatial
    gradient at the points (``ndkernels.grad_core``)."""
    return _gathered("grad_scattered", pp._grad, inp, grid, orders, bounds,
                     extrapolate, box, interpret, pre)


def hess_scattered(inp, grid, orders, bounds, extrapolate, *, box=None,
                   interpret=False, pre=None):
    """(C, *ishape), (P, D) -> (C, P, D, D), D in (1, 2, 3): the symmetric
    spatial Hessians at the points (``ndkernels.hess_core``)."""
    return _gathered("hess_scattered", pp.Hess.apply, inp, grid, orders,
                     bounds, extrapolate, box, interpret, pre)


def push_scattered(vals, grid, oshape, orders, bounds, extrapolate, *,
                   box=None, interpret=False):
    """(C, P), (P, D) -> (C, *oshape), D in (1, 2, 3): the adjoint of
    :func:`pull_scattered` (``ndkernels.push_core``)."""
    return _splatted("push_scattered", pp.Push.apply, vals, grid, oshape,
                     orders, bounds, extrapolate, box, interpret, ())


def pushgrad_scattered(ct, grid, oshape, orders, bounds, extrapolate, *,
                       box=None, interpret=False):
    """(C, P, D), (P, D) -> (C, *oshape), D in (1, 2, 3): the adjoint of
    :func:`grad_scattered` in the image, the per-point gradient
    cotangents splatted with first-derivative taps
    (``ndkernels.pushgrad_core``)."""
    return _splatted("pushgrad_scattered", pp.Pushgrad.apply, ct, grid,
                     oshape, orders, bounds, extrapolate, box, interpret,
                     tuple(grid.shape[-1:]))


def count_scattered(grid, oshape, orders, bounds, extrapolate, *,
                    box=None, interpret=False):
    """(P, D) -> (1, *oshape): splatted unit weights."""
    opts = _prepare("count_scattered", grid, grid, orders, bounds,
                    extrapolate, box, interpret, len(oshape))
    return pp.Count.apply(grid.contiguous()[None],
                          tuple(int(n) for n in oshape), opts)[0]


# ------------------------------------------------------------ host side


def lift3(grid, oshape, orders, bounds):
    """Lift a (B, P, D) cloud, D < 3, to 3-D: trailing size-1 axes of
    order 0, dct2, coordinate 0.  Returns (grid3, shape3, orders3,
    bounds3); ``grid3`` is a new contiguous tensor."""
    B, P, D = grid.shape
    nd = 3 - D
    grid3 = torch.cat([grid, grid.new_zeros((B, P, nd))], -1).contiguous()
    return (grid3, tuple(oshape) + (1,) * nd, tuple(orders) + (0,) * nd,
            tuple(bounds) + (3,) * nd)


def splat_margins(order: int) -> Tuple[int, int]:
    """Least and largest tap offset from a point's anchor ``floor(g)``.

    Linear taps are ``floor(g) + {0, 1}`` and order 0 takes ``rint(g)``,
    one of them, exactly.  From order 2 the node origin ``floor(g -
    (order-1)/2)`` is ``floor(g) - order//2`` or one above (even orders),
    and the last tap is ``order`` further; one cell more on each side
    absorbs a float32 rounding of ``g - (order-1)/2`` across an integer.
    """
    if order <= 1:
        return 0, 1
    return -(order // 2) - 1, order // 2 + 2


def splat_box(oshape, npoints: int) -> Tuple[int, ...]:
    """Box core per axis: 16 voxels for clouds sparser than a point per 4
    voxels, else 8 (fewer points per warp); never above the axis."""
    side = 16 if 4 * npoints < math.prod(oshape) else 8
    return tuple(min(side, n) for n in oshape)


def box_schedule(grid3, shape3, box, extrapolate):
    """Sort the points of ``grid3`` (B, P, 3) by box.

    Returns ``(keys, perm, seg, nb)``: the sorted keys (int32, B*P), the
    permutation that sorts them, the segment starts ``seg[i]`` = first
    sorted position with key >= i for i in ``0 .. B*tiles + B + 1``
    (boxes ``b*tiles + t``, then the outliers of batch b at ``B*tiles +
    b``, then the masked points), and the boxes per axis.
    """
    B, P, _ = grid3.shape
    nb = tuple(-(-n // t) for n, t in zip(shape3, box))
    ntile = math.prod(nb)
    if B * ntile + B + 2 >= 2**31:
        raise ValueError(f"{B} x {ntile} boxes do not fit int32 keys")
    elig = None
    box_id = None
    for d in range(3):
        g = grid3[..., d]
        inside = (g >= 0) & (g <= shape3[d] - 1)
        elig = inside if elig is None else elig & inside
        cell = torch.floor(g).clamp(0, shape3[d] - 1).to(torch.int64)
        k = torch.div(cell, box[d], rounding_mode="floor")
        box_id = k if box_id is None else box_id * nb[d] + k
    bidx = torch.arange(B, device=grid3.device)[:, None]
    keys = torch.where(elig, bidx * ntile + box_id, B * ntile + bidx)
    mask = inbounds_mask(grid3, shape3, extrapolate, torch.bool)
    if mask is not None:
        keys = torch.where(elig | mask, keys, B * ntile + B)
    # int32 keys: half the radix passes of int64
    keys, perm = torch.sort(keys.reshape(-1).to(torch.int32), stable=True)
    seg = torch.searchsorted(
        keys, torch.arange(B * ntile + B + 2, dtype=torch.int32,
                           device=grid3.device))
    return keys, perm, seg, nb
