"""Generic N-D B-spline sampling as a plain gather over the (order+1)^D taps.

PyTorch port of the pull and gradient cores of
``interpol_tpu/ops/ndkernels.py`` (``inbounds_mask`` ``:79-90``,
``pull_core`` ``:221-249``, ``grad_core`` ``:294-324``).  This is the
general path that ``grid_pull`` / ``grid_grad`` take when no ``max_disp``
is declared (the XLA tier of the JAX package); it runs as plain torch on
every device.

Layout (batch written out where the JAX side vmaps):
    input  : (B, C, *ishape)
    grid   : (B, P, D)       flattened sample positions, voxel units
    output : (B, C, P) / (B, C, P, D)
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Tuple

import torch

from .bounds import fold_index, fold_sign
from .splines import bspline_taps, node_origin

__all__ = ["inbounds_mask", "pull_core", "grad_core"]


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


def _tap_tables(grid, ishape, orders, bounds, need_grad, wdtype):
    """Per axis: lists over taps of (folded index, sign or None, weight,
    derivative or None), each shaped like ``grid[..., 0]``."""
    tables = []
    for d, (order, bound) in enumerate(zip(orders, bounds)):
        n = ishape[d]
        n0, t = node_origin(grid[..., d].to(wdtype), order)
        w, gr, _ = bspline_taps(t, order, grad=need_grad)
        axis = []
        for j in range(order + 1):
            node = n0 + j
            axis.append((fold_index(node, n, bound),
                         fold_sign(node, n, bound, wdtype), w[j],
                         gr[j] if need_grad else None))
        tables.append(axis)
    return tables


def _gather_taps(inp, grid, orders, bounds, need_grad):
    """Yield (gathered values (B, C, P), per-axis tap tuples) for every
    node of the tap product, plus the compute dtype."""
    D = grid.shape[-1]
    B, C = inp.shape[:2]
    ishape = tuple(inp.shape[2:])
    _, wdtype = _compute_dtypes(inp, grid)
    flat = inp.reshape(B, C, math.prod(ishape)).to(wdtype)
    strides = [math.prod(ishape[d + 1:]) for d in range(D)]
    tables = _tap_tables(grid, ishape, orders, bounds, need_grad, wdtype)
    P = grid.shape[1]
    for taps in itertools.product(*tables):
        lin = sum(t[0] * s for t, s in zip(taps, strides))
        val = torch.gather(flat, 2, lin[:, None, :].expand(B, C, P))
        for t in taps:
            if t[1] is not None:
                val = val * t[1][:, None]
        yield val, taps


def pull_core(inp: torch.Tensor, grid: torch.Tensor,
              orders: Tuple[int, ...], bounds: Tuple[int, ...],
              extrapolate: int) -> torch.Tensor:
    """Sample ``inp`` at ``grid``: (B, C, *ishape), (B, P, D) -> (B, C, P)."""
    D = grid.shape[-1]
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    out = None
    for val, taps in _gather_taps(inp, grid, orders, bounds, False):
        w = math.prod(t[2] for t in taps)
        term = val * w[:, None]
        out = term if out is None else out + term
    mask = inbounds_mask(grid, inp.shape[-D:], extrapolate, wdtype)
    if mask is not None:
        out = out * mask[:, None]
    return out.to(out_dtype)


def grad_core(inp: torch.Tensor, grid: torch.Tensor,
              orders: Tuple[int, ...], bounds: Tuple[int, ...],
              extrapolate: int) -> torch.Tensor:
    """Spatial gradient of the spline surface sampled at ``grid``:
    (B, C, *ishape), (B, P, D) -> (B, C, P, D)."""
    D = grid.shape[-1]
    out_dtype, wdtype = _compute_dtypes(inp, grid)
    out = None
    for val, taps in _gather_taps(inp, grid, orders, bounds, True):
        terms = [val * math.prod(t[3] if d == da else t[2]
                                 for d, t in enumerate(taps))[:, None]
                 for da in range(D)]
        term = torch.stack(terms, dim=-1)
        out = term if out is None else out + term
    mask = inbounds_mask(grid, inp.shape[-D:], extrapolate, wdtype)
    if mask is not None:
        out = out * mask[:, None, :, None]
    return out.to(out_dtype)
