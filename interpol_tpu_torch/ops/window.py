"""Dense-grid warp sampling for bounded displacements: pull and spatial
gradient.

PyTorch port of ``interpol_tpu/ops/window.py:52-204, 405-450``.  Dense
warps ``grid = identity + displacement`` with ``|disp| <= max_disp`` per
axis put every tap of every sample inside a fixed window of shifts around
its own voxel.  Two formulations of the same function live here:

- the **plain** version (``_pull_impl_torch`` / ``_grad_impl_torch``), the
  shift-FMA form of the JAX package line for line:

      out[p] = sum_{s in window^D} ( prod_d coef_d[s_d](p) ) * Vpad[p + s]

  with ``Vpad`` the boundary-folded padded volume.  It runs for CPU
  tensors, and the tests and ``chip_smoke.py`` call it by name on the card;
- the **CUDA kernel** (``ops/cuda_warp.py`` → ``csrc/warp.cu``), a direct
  gather of the (order+1)^D taps, for CUDA tensors.

``pull_window`` / ``grad_window`` pick by the tensors' device: a CPU tensor
runs the plain version, a CUDA tensor the kernel (which raises on what it
does not take).  A sample whose node origin falls outside the window on
some axis gets no tap there and reads 0 in both formulations, exactly as
in the JAX package.  ``spread`` is accepted and ignored (full window), as
the JAX package's XLA tier ignores it.

Layout (the JAX side's vmap written out as a batch dimension):
    inp (B, C, *ishape), grid (B, *ishape, D)
    pull -> (B, C, *ishape); grad -> (B, C, *ishape, D)
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .bounds import fold_index, fold_sign
from .ndkernels import inbounds_mask
from .splines import bspline_taps, node_origin

__all__ = ["window_range", "pull_window", "grad_window"]


def window_range(order: int, max_disp: float) -> Tuple[int, int]:
    """Inclusive shift range [smin, smax] that covers every tap of a
    sample within ``max_disp`` of its voxel.

    Order 0 rounds half to even, so its farthest reachable node is
    ``floor(max_disp + 1/2)`` on either side.  Otherwise the node origin
    is ``floor(g - (order-1)/2)``, so for ``g = p + d``, ``|d| <=
    max_disp`` the reachable origins are ``delta0 in [floor(-max_disp -
    a), floor(max_disp - a)]``, ``a = (order-1)/2``, and the taps extend
    ``order`` past the top origin.
    """
    if order == 0:
        r = math.floor(max_disp + 0.5)
        return -r, r
    a = (order - 1) / 2
    d0min = math.floor(-max_disp - a)
    d0max = math.floor(max_disp - a)
    return d0min, d0max + order


def _md_tuple(max_disp, D):
    """Normalize max_disp to a per-axis tuple."""
    if isinstance(max_disp, (tuple, list)):
        if len(max_disp) != D:
            raise ValueError(f"max_disp has {len(max_disp)} entries for a "
                             f"{D}-D grid")
        return tuple(float(m) for m in max_disp)
    return (float(max_disp),) * D


def _window_geom(orders, max_disp, D):
    """Per-axis pad widths (lo, hi) that hold every shift of the window."""
    md = _md_tuple(max_disp, D)
    los, his = [], []
    for d in range(D):
        smin, smax = window_range(orders[d], md[d])
        los.append(max(0, -smin))
        his.append(max(0, smax))
    return los, his


def _pad_folded(inp: torch.Tensor, ishape, bounds, lo: Sequence[int],
                hi: Sequence[int], wdtype) -> torch.Tensor:
    """Pad the last D axes with boundary-folded (index + sign) content."""
    D = len(ishape)
    out = inp
    for d in range(D):
        n = ishape[d]
        idx = np.arange(-lo[d], n + hi[d])
        folded = torch.as_tensor(fold_index(idx, n, bounds[d]),
                                 device=inp.device)
        axis = out.ndim - D + d
        out = torch.index_select(out, axis, folded)
        sign = fold_sign(idx, n, bounds[d], np.float64)
        if sign is not None:
            shape = [1] * out.ndim
            shape[axis] = idx.size
            out = out * torch.as_tensor(sign, dtype=wdtype,
                                        device=inp.device).reshape(shape)
    return out


def _coef_fields(grid, orders, max_disp, wdtype, deriv_axis=None):
    """Per-axis coefficient fields.

    ``grid``: (B, *ishape, D).  Returns (ranges, coefs): ranges[d] =
    (smin, smax); coefs[d] is a list of (smax-smin+1) tensors shaped
    (B, *ishape), where coefs[d][k] is the weight this sample contributes
    at relative shift smin+k along axis d.  ``deriv_axis`` selects the
    first-derivative factors on that axis.
    """
    D = grid.shape[-1]
    md = _md_tuple(max_disp, D)
    ranges, coefs = [], []
    for d in range(D):
        g = grid[..., d].to(wdtype)
        order = orders[d]
        smin, smax = window_range(order, md[d])
        n0, t = node_origin(g, order)
        w, gr, _ = bspline_taps(t, order, grad=(d == deriv_axis))
        taps = gr if d == deriv_axis else w
        # delta0 = n0 - p  (p = own voxel index along axis d)
        shape = [1] * g.ndim
        shape[1 + d] = g.shape[1 + d]
        p = torch.arange(g.shape[1 + d], device=g.device).reshape(shape)
        d0 = n0 - p
        d0min, d0max = smin, smax - order   # attainable delta0 values
        cs = []
        for s in range(smin, smax + 1):
            acc = None
            for j in range(order + 1):
                if d0min <= s - j <= d0max:
                    term = torch.where(d0 == s - j, taps[j], 0)
                    acc = term if acc is None else acc + term
            cs.append(acc if acc is not None else torch.zeros_like(g))
        ranges.append((smin, smax))
        coefs.append(cs)
    return ranges, coefs


def _slice_pad(vpad, offs, lo, ishape):
    """Static window slice of the padded volume: Vpad[p + s]."""
    D = len(ishape)
    idx = [slice(None)] * vpad.ndim
    for d in range(D):
        start = lo[d] + offs[d]
        idx[vpad.ndim - D + d] = slice(start, start + ishape[d])
    return vpad[tuple(idx)]


def _accumulate(vpad, ranges, coefs, lo, ishape):
    """Sum over the shift window of view * (product of coef fields)."""
    D = len(ishape)
    out = None
    spans = [range(r[1] - r[0] + 1) for r in ranges]
    for ks in itertools.product(*spans):
        w = None
        for d, k in enumerate(ks):
            cd = coefs[d][k]
            w = cd if w is None else w * cd
        offs = [ranges[d][0] + ks[d] for d in range(D)]
        term = _slice_pad(vpad, offs, lo, ishape) * w[:, None]
        out = term if out is None else out + term
    return out


def _pull_impl_torch(inp, grid, orders, bounds, extrapolate, max_disp):
    """Plain shift-FMA pull: (B, C, *ishape), (B, *ishape, D) ->
    (B, C, *ishape)."""
    D = grid.shape[-1]
    ishape = tuple(inp.shape[-D:])
    wdtype = torch.promote_types(inp.dtype, grid.dtype)
    lo, hi = _window_geom(orders, max_disp, D)
    vpad = _pad_folded(inp.to(wdtype), ishape, bounds, lo, hi, wdtype)
    ranges, coefs = _coef_fields(grid, orders, max_disp, wdtype)
    out = _accumulate(vpad, ranges, coefs, lo, ishape)
    mask = inbounds_mask(grid, ishape, extrapolate, wdtype)
    if mask is not None:
        out = out * mask[:, None]
    return out


def _grad_impl_torch(inp, grid, orders, bounds, extrapolate, max_disp):
    """Plain shift-FMA spatial gradients: (B, C, *ishape, D)."""
    D = grid.shape[-1]
    ishape = tuple(inp.shape[-D:])
    wdtype = torch.promote_types(inp.dtype, grid.dtype)
    lo, hi = _window_geom(orders, max_disp, D)
    vpad = _pad_folded(inp.to(wdtype), ishape, bounds, lo, hi, wdtype)
    outs = []
    for da in range(D):
        ranges, coefs = _coef_fields(grid, orders, max_disp, wdtype,
                                     deriv_axis=da)
        outs.append(_accumulate(vpad, ranges, coefs, lo, ishape))
    out = torch.stack(outs, dim=-1)
    mask = inbounds_mask(grid, ishape, extrapolate, wdtype)
    if mask is not None:
        out = out * mask[:, None, ..., None]
    return out


def pull_window(inp, grid, orders, bounds, extrapolate, max_disp,
                spread=None):
    """Dense-grid pull: (B, C, *ishape), (B, *ishape, D) -> (B, C, *ishape).

    CPU tensors run the plain shift-FMA version; CUDA tensors the CUDA
    kernel (float32 only).  ``spread`` is ignored (full window)."""
    if inp.device.type == "cpu":
        return _pull_impl_torch(inp, grid, orders, bounds, extrapolate,
                                max_disp)
    from .cuda_warp import warp_cuda
    val, _ = warp_cuda(inp.contiguous(), grid.contiguous(), orders, bounds,
                       extrapolate, max_disp, value=True, grad=False)
    return val


def grad_window(inp, grid, orders, bounds, extrapolate, max_disp,
                spread=None):
    """Dense-grid spatial gradients of the spline surface:
    (B, C, *ishape), (B, *ishape, D) -> (B, C, *ishape, D).

    Dispatch as :func:`pull_window`."""
    if inp.device.type == "cpu":
        return _grad_impl_torch(inp, grid, orders, bounds, extrapolate,
                                max_disp)
    from .cuda_warp import warp_cuda
    _, g = warp_cuda(inp.contiguous(), grid.contiguous(), orders, bounds,
                     extrapolate, max_disp, value=False, grad=True)
    return g
