"""Generic N-D B-spline sampling as a plain gather / scatter over the
(order+1)^D taps.

PyTorch port of ``interpol_tpu/ops/ndkernels.py`` (``inbounds_mask``
``:79-90``, ``pull_core`` ``:221-249``, ``push_core`` ``:252-280``,
``count_core`` ``:283-291``, ``grad_core`` ``:294-324``,
``pushgrad_core`` ``:327-358``, ``hess_core`` ``:361-401``; the
global-folding mode of ``_TapTables`` ``:93-134`` in ``pull_core``,
``grad_core`` and ``push_core``), plus
``pushhess_core``, the adjoint of ``hess_core`` in the image.  These are
the plain versions of the scattered kernels (``csrc/gather.cu``,
``csrc/splat.cu``), the path of every D > 3 cloud on every device, and
the reference the kernels are held to.  The scatters sum in a fixed order
on every device (:func:`_fixed_order_add`: a stable sort by destination,
then a pairwise sum within each run of equal destinations), so two runs
give the same bits on the card too, as the JAX package's splats do.

Layout (batch written out where the JAX side vmaps):
    input  : (B, C, *ishape)  (pull family) / (B, C, P[, D[, D]]) (push)
    grid   : (B, P, D)       flattened sample positions, voxel units
    output : (B, C, P[, D[, D]]) (pull family) / (B, C, *oshape) (push)
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Tuple

import torch

from .bounds import fold_index, fold_sign
from .splines import bspline_taps, node_origin

__all__ = ["inbounds_mask", "pull_core", "push_core", "count_core",
           "grad_core", "pushgrad_core", "hess_core", "pushhess_core"]


def _compute_dtypes(inp, grid):
    """(output dtype, internal compute dtype >= float32)."""
    out_dtype = torch.promote_types(inp.dtype, grid.dtype)
    return out_dtype, torch.promote_types(out_dtype, torch.float32)


def inbounds_mask(grid: torch.Tensor, ishape: Sequence[int],
                  extrapolate: int, dtype) -> Optional[torch.Tensor]:
    """(..., P) mask of samples inside the volume, or None when
    extrapolating.  Inside means ``-thr < g < n-1+thr`` on every axis, with
    ``thr`` 0.05 (``extrapolate=0``) or 0.55 (``extrapolate=2``)."""
    if extrapolate == 1:
        return None
    thr = 0.05 if extrapolate == 0 else 0.55
    mask = None
    for d, n in enumerate(ishape):
        g = grid[..., d]
        m = torch.logical_and(g > -thr, g < (n - 1) + thr)
        mask = m if mask is None else torch.logical_and(mask, m)
    return mask.to(dtype)


def _tap_tables(grid, ishape, orders, bounds, need_grad, wdtype,
                need_hess=False, fold_shapes=None, shifts=None):
    """Per axis: lists over taps of (folded index, sign or None, weight,
    derivative or None, second derivative or None), each shaped like
    ``grid[..., 0]``.

    The global-folding mode (``fold_shapes`` / ``shifts``, the slab-sharded
    paths of ``parallel/``; ``interpol_tpu/ops/ndkernels.py:93-134``): a tap
    folds against the global axis length ``fold_shapes[d]``, then maps into
    the local (halo-extended) buffer of extent ``ishape[d]`` as ``(folded +
    shifts[d]) % fold_shapes[d]``, which lands circular (dft) edge folds in
    the ring-exchanged halos.  Indices beyond the local buffer (the taps of
    points another slab owns, whose values are masked) are clamped into it,
    as the JAX gather clamps them."""
    D = grid.shape[-1]
    fold = tuple(fold_shapes) if fold_shapes is not None else tuple(ishape)
    shifts = tuple(shifts) if shifts is not None else (None,) * D
    tables = []
    for d, (order, bound) in enumerate(zip(orders, bounds)):
        n = fold[d]
        n0, t = node_origin(grid[..., d].to(wdtype), order)
        w, gr, he = bspline_taps(t, order, grad=need_grad, hess=need_hess)
        axis = []
        for j in range(order + 1):
            node = n0 + j
            idx = fold_index(node, n, bound)
            if shifts[d] is not None:
                idx = torch.remainder(idx + shifts[d], n)
            if fold_shapes is not None:
                idx = torch.clamp(idx, 0, ishape[d] - 1)
            axis.append((idx, fold_sign(node, n, bound, wdtype), w[j],
                         gr[j] if need_grad else None,
                         he[j] if need_hess else None))
        tables.append(axis)
    return tables


def _weight(taps, deriv=(), deriv2=None):
    """Separable product of one node's taps: the first-derivative factor
    on the axes in ``deriv``, the second-derivative one on ``deriv2``."""
    return math.prod(t[4] if d == deriv2 else (t[3] if d in deriv else t[2])
                     for d, t in enumerate(taps))


def _hess_weights(taps, D):
    """{(d, d2): weight} over the upper triangle of the Hessian."""
    return {(d, d2): _weight(taps, deriv2=d) if d == d2
            else _weight(taps, deriv=(d, d2))
            for d in range(D) for d2 in range(d, D)}


def _sign(taps):
    """Product of the taps' fold signs, or None when all are +1."""
    signs = [t[1] for t in taps if t[1] is not None]
    return math.prod(signs) if signs else None


def _gather_taps(inp, grid, orders, bounds, need_grad, need_hess=False,
                 fold_shapes=None, shifts=None):
    """Yield (gathered values (B, C, P), per-axis tap tuples) for every
    node of the tap product."""
    D = grid.shape[-1]
    B, C = inp.shape[:2]
    ishape = tuple(inp.shape[2:])
    _, wdtype = _compute_dtypes(inp, grid)
    flat = inp.reshape(B, C, math.prod(ishape)).to(wdtype)
    strides = [math.prod(ishape[d + 1:]) for d in range(D)]
    tables = _tap_tables(grid, ishape, orders, bounds, need_grad, wdtype,
                         need_hess, fold_shapes, shifts)
    P = grid.shape[1]
    for taps in itertools.product(*tables):
        lin = sum(t[0] * s for t, s in zip(taps, strides))
        val = torch.gather(flat, 2, lin[:, None, :].expand(B, C, P))
        for t in taps:
            if t[1] is not None:
                val = val * t[1][:, None]
        yield val, taps


def _fixed_order_add(acc, idx, vals):
    """``acc[:, idx[k]] += vals[:, k]`` for every k, in an order fixed by
    the input alone: a stable sort by destination, then a pairwise sum
    within each run of equal destinations (the values at rank r + s are
    added to those at rank r, for s = 1, 2, 4, ...), then one add per
    destination.  No two adds of a pass touch one address, so the result
    is the same on every run and device.  ``acc`` (C, V), ``idx`` (N,),
    ``vals`` (C, N)."""
    idx, perm = torch.sort(idx, stable=True)
    vals = vals[:, perm]
    n = idx.numel()
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = idx[1:] != idx[:-1]
    starts = torch.nonzero(first).squeeze(1)
    runs = torch.diff(starts, append=starts.new_tensor([n]))
    run_of = torch.cumsum(first, 0) - 1
    rank = torch.arange(n, device=idx.device) - starts[run_of]
    length = runs[run_of]
    step = 1
    longest = int(runs.max()) if n else 0
    while step < longest:
        src = torch.nonzero((rank % (2 * step) == 0)
                            & (rank + step < length)).squeeze(1)
        vals = vals.index_copy(1, src, vals[:, src] + vals[:, src + step])
        step *= 2
    dst = idx[starts]
    return acc.index_copy(1, dst, acc[:, dst] + vals[:, starts])


def _scatter_taps(term_of, grid, oshape, orders, bounds, need_grad,
                  need_hess, C, wdtype, fold_shapes=None, shifts=None):
    """Adjoint of :func:`_gather_taps`: for every node of the tap
    product, add ``term_of(taps)`` (B, C, P) times the fold sign at the
    node's folded index, in a fixed order (:func:`_fixed_order_add`).
    Returns (B, C, *oshape)."""
    D = grid.shape[-1]
    B, P = grid.shape[:2]
    V = math.prod(oshape)
    strides = [math.prod(oshape[d + 1:]) for d in range(D)]
    tables = _tap_tables(grid, oshape, orders, bounds, need_grad, wdtype,
                         need_hess, fold_shapes, shifts)
    # (C, B * V): one destination index over the batch
    out = torch.zeros((C, B * V), dtype=wdtype, device=grid.device)
    boff = torch.arange(B, device=grid.device)[:, None] * V
    for taps in itertools.product(*tables):
        lin = sum(t[0] * s for t, s in zip(taps, strides))
        term = term_of(taps)
        sign = _sign(taps)
        if sign is not None:
            term = term * sign[:, None]
        out = _fixed_order_add(out, (lin + boff).reshape(-1),
                               term.transpose(0, 1).reshape(C, B * P))
    return out.reshape((C, B) + tuple(oshape)).transpose(0, 1)


def pull_core(inp: torch.Tensor, grid: torch.Tensor,
              orders: Tuple[int, ...], bounds: Tuple[int, ...],
              extrapolate: int, fold_shapes=None,
              shifts=None) -> torch.Tensor:
    """Sample ``inp`` at ``grid``: (B, C, *ishape), (B, P, D) -> (B, C, P).
    ``fold_shapes`` / ``shifts``: the global-folding mode of
    :func:`_tap_tables` (the extrapolation mask then uses the global
    shape)."""
    D = grid.shape[-1]
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    out = None
    for val, taps in _gather_taps(inp, grid, orders, bounds, False,
                                  fold_shapes=fold_shapes, shifts=shifts):
        w = math.prod(t[2] for t in taps)
        term = val * w[:, None]
        out = term if out is None else out + term
    mask = inbounds_mask(grid, fold_shapes or inp.shape[-D:], extrapolate,
                         wdtype)
    if mask is not None:
        out = out * mask[:, None]
    return out.to(out_dtype)


def grad_core(inp: torch.Tensor, grid: torch.Tensor,
              orders: Tuple[int, ...], bounds: Tuple[int, ...],
              extrapolate: int, fold_shapes=None,
              shifts=None) -> torch.Tensor:
    """Spatial gradient of the spline surface sampled at ``grid``:
    (B, C, *ishape), (B, P, D) -> (B, C, P, D).  ``fold_shapes`` /
    ``shifts``: as :func:`pull_core`."""
    D = grid.shape[-1]
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    out = None
    for val, taps in _gather_taps(inp, grid, orders, bounds, True,
                                  fold_shapes=fold_shapes, shifts=shifts):
        terms = [val * _weight(taps, deriv=(da,))[:, None]
                 for da in range(D)]
        term = torch.stack(terms, dim=-1)
        out = term if out is None else out + term
    mask = inbounds_mask(grid, fold_shapes or inp.shape[-D:], extrapolate,
                         wdtype)
    if mask is not None:
        out = out * mask[:, None, :, None]
    return out.to(out_dtype)


def _masked(vals, grid, oshape, extrapolate, wdtype, trailing=0):
    """``vals`` (B, C, P, ...) in the compute dtype, zeroed where the
    sample is masked."""
    vals = vals.to(wdtype)
    mask = inbounds_mask(grid, oshape, extrapolate, wdtype)
    if mask is None:
        return vals
    return vals * mask.reshape(mask.shape[:1] + (1,) + mask.shape[1:]
                               + (1,) * trailing)


def push_core(inp: torch.Tensor, grid: torch.Tensor,
              oshape: Tuple[int, ...], orders: Tuple[int, ...],
              bounds: Tuple[int, ...], extrapolate: int, fold_shapes=None,
              shifts=None) -> torch.Tensor:
    """Splat values ``inp`` at ``grid`` (the adjoint of :func:`pull_core`):
    (B, C, P), (B, P, D) -> (B, C, *oshape).  ``fold_shapes`` / ``shifts``:
    as :func:`pull_core`, ``oshape`` the local buffer."""
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    val0 = _masked(inp, grid, fold_shapes or oshape, extrapolate, wdtype)
    out = _scatter_taps(lambda taps: val0 * _weight(taps)[:, None], grid,
                        oshape, orders, bounds, False, False, inp.shape[1],
                        wdtype, fold_shapes, shifts)
    return out.to(out_dtype)


def count_core(grid: torch.Tensor, oshape: Tuple[int, ...],
               orders: Tuple[int, ...], bounds: Tuple[int, ...],
               extrapolate: int) -> torch.Tensor:
    """Splat unit weights: (B, P, D) -> (B, 1, *oshape)."""
    ones = grid.new_ones((grid.shape[0], 1, grid.shape[1]))
    return push_core(ones, grid, oshape, orders, bounds, extrapolate)


def pushgrad_core(inp: torch.Tensor, grid: torch.Tensor,
                  oshape: Tuple[int, ...], orders: Tuple[int, ...],
                  bounds: Tuple[int, ...], extrapolate: int) -> torch.Tensor:
    """Adjoint of :func:`grad_core` in the image: (B, C, P, D), (B, P, D)
    -> (B, C, *oshape)."""
    D = grid.shape[-1]
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    val0 = _masked(inp, grid, oshape, extrapolate, wdtype, trailing=1)

    def term(taps):
        return sum(val0[..., d] * _weight(taps, deriv=(d,))[:, None]
                   for d in range(D))
    out = _scatter_taps(term, grid, oshape, orders, bounds, True, False,
                        inp.shape[1], wdtype)
    return out.to(out_dtype)


def hess_core(inp: torch.Tensor, grid: torch.Tensor,
              orders: Tuple[int, ...], bounds: Tuple[int, ...],
              extrapolate: int) -> torch.Tensor:
    """Spatial Hessian of the spline surface sampled at ``grid``:
    (B, C, *ishape), (B, P, D) -> (B, C, P, D, D), symmetric."""
    D = grid.shape[-1]
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    out = None
    for val, taps in _gather_taps(inp, grid, orders, bounds, True, True):
        w = _hess_weights(taps, D)
        rows = [torch.stack([val * w[(min(d, d2), max(d, d2))][:, None]
                             for d2 in range(D)], dim=-1)
                for d in range(D)]
        term = torch.stack(rows, dim=-2)
        out = term if out is None else out + term
    mask = inbounds_mask(grid, inp.shape[-D:], extrapolate, wdtype)
    if mask is not None:
        out = out * mask[:, None, :, None, None]
    return out.to(out_dtype)


def pushhess_core(inp: torch.Tensor, grid: torch.Tensor,
                  oshape: Tuple[int, ...], orders: Tuple[int, ...],
                  bounds: Tuple[int, ...], extrapolate: int) -> torch.Tensor:
    """Adjoint of :func:`hess_core` in the image: (B, C, P, D, D),
    (B, P, D) -> (B, C, *oshape).  Both triangles of the cotangent count
    (the symmetric pairs are summed)."""
    D = grid.shape[-1]
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    val0 = _masked(inp, grid, oshape, extrapolate, wdtype, trailing=2)
    sym = {(d, d2): val0[..., d, d2] if d == d2
           else val0[..., d, d2] + val0[..., d2, d]
           for d in range(D) for d2 in range(d, D)}

    def term(taps):
        w = _hess_weights(taps, D)
        return sum(sym[k] * w[k][:, None] for k in sym)
    out = _scatter_taps(term, grid, oshape, orders, bounds, True, True,
                        inp.shape[1], wdtype)
    return out.to(out_dtype)
