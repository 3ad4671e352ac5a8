"""Dense-grid warp sampling for bounded displacements: pull, push, their
spatial derivatives, and the hand-wired adjoints that train through them.

PyTorch port of ``interpol_tpu/ops/window.py``.  Dense warps ``grid =
identity + displacement`` with ``|disp| <= max_disp`` per axis put every
tap of every sample inside a fixed window of shifts around its own voxel.
Two formulations of each operation live here:

- the **plain** version (``_pull_impl_torch``, ``_grad_impl_torch``,
  ``_hess_impl_torch``, ``_push_impl_torch``, ``_pushgrad_impl_torch``),
  the shift-FMA form of the JAX package line for line:

      out[p] = sum_{s in window^D} ( prod_d coef_d[s_d](p) ) * Vpad[p + s]

  with ``Vpad`` the boundary-folded padded volume (push and pushgrad are
  its transpose: splat into the padded volume, then fold the margins
  back).  It runs for CPU tensors, and the tests and ``chip_smoke.py``
  call it by name on the card;
- the **CUDA kernels** (``ops/cuda_warp.py`` -> ``csrc/warp.cu`` for
  pull / grad / hess, ``csrc/push.cu`` for push / pushgrad), a direct
  gather or splat of the (order+1)^D taps, for CUDA tensors.

The public ``*_window`` functions are ``torch.autograd.Function``s whose
backward rules mirror the JAX package's custom VJPs (pull and push are
mutual adjoints, grad and pushgrad too; the grid cotangents come from the
next derivative up).  The same Functions run on both devices: the plain
versions for CPU tensors, the kernels for CUDA tensors.  A sample whose
node origin falls outside the window on some axis gets no tap there, in
every formulation, exactly as in the JAX package.

``spread`` (``tile_spread`` of the API) selects the adaptive mode of the
JAX package's Pallas kernels (``pallas_warp.py:110-158, 172-235,
669-685``): each tile of the TPU kernel's grid gets an integer base
displacement (``ops/tiles.py``), and a sample keeps its taps on an axis iff
``d0 - base`` lies in ``[smin_r, smax_r - order]``, the residual window of
``spread``.  The port follows the kernel on every device, in the plain
versions too: they sum over the union of the residual windows, ``[-B +
smin_r, B + smax_r]`` with ``B = ceil(max_disp)``, and mask the samples
that fail the test.  On grids that honour the declared spread this is the
full window's result; the JAX package's XLA tier ignores ``spread``, so the
two differ only on grids that break it (``check_spread=True`` of the API
raises there).

Layout (the JAX side's vmap written out as a batch dimension):
    inp (B, C, *ishape), grid (B, *ishape, D)
    pull, push, pushgrad -> (B, C, *ishape); grad -> (B, C, *ishape, D);
    hess -> (B, C, *ishape, D, D); pushgrad takes (B, C, *ishape, D)
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
from .tiles import base_field, lifted_tile, tile_bases

__all__ = ["window_range", "pull_window", "push_window", "grad_window",
           "pushgrad_window", "hess_window"]


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


def _shift_ranges(orders, max_disp, spread, D):
    """Per-axis shift ranges [smin, smax] of the window: that of
    ``max_disp``, or in adaptive mode the residual window of ``spread``
    widened by the largest base, ``ceil(max_disp)``, on either side."""
    md = _md_tuple(max_disp, D)
    if spread is None:
        return [window_range(orders[d], md[d]) for d in range(D)]
    sp = _md_tuple(spread, D)
    out = []
    for d in range(D):
        smin, smax = window_range(orders[d], sp[d])
        B = math.ceil(md[d])
        out.append((smin - B, smax + B))
    return out


def _window_geom(ranges):
    """Per-axis pad widths (lo, hi) that hold every shift of the window."""
    return ([max(0, -smin) for smin, _ in ranges],
            [max(0, smax) for _, smax in ranges])


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


def _coef_fields(grid, orders, ranges, wdtype, deriv_axes=(),
                 deriv2_axis=None):
    """Per-axis coefficient fields.

    ``grid``: (B, *ishape, D); ``ranges[d]`` = (smin, smax), the shifts of
    axis d (:func:`_shift_ranges`).  Returns coefs: coefs[d] is a list of
    (smax-smin+1) tensors shaped (B, *ishape), where coefs[d][k] is the
    weight this sample contributes at relative shift smin+k along axis d.
    ``deriv_axes`` selects the first-derivative factors on those axes (a
    mixed second derivative is the product of two first derivatives),
    ``deriv2_axis`` the second-derivative factors on that axis.
    """
    D = grid.shape[-1]
    coefs = []
    for d in range(D):
        g = grid[..., d].to(wdtype)
        order = orders[d]
        smin, smax = ranges[d]
        n0, t = node_origin(g, order)
        need_grad, need_hess = d in deriv_axes, deriv2_axis == d
        w, gr, he = bspline_taps(t, order, grad=need_grad, hess=need_hess)
        taps = he if need_hess else (gr if need_grad else w)
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
        coefs.append(cs)
    return coefs


def _adaptive_keep(grid, orders, max_disp, spread, push, wdtype):
    """(B, *ishape) mask of the samples that keep their taps in adaptive
    mode: ``d0 - base`` in ``[smin_r, smax_r - order]`` on every axis,
    with the bases of the pull family's tiles or, with ``push``, of the
    push's (``ops/tiles.py``).  A constant for every derivative."""
    D = grid.shape[-1]
    ishape = tuple(grid.shape[1:-1])
    sp = _md_tuple(spread, D)
    tile = lifted_tile(ishape, push)
    with torch.no_grad():
        base = base_field(tile_bases(grid, _md_tuple(max_disp, D), tile,
                                     wdtype), tile, ishape)
        keep = None
        for d in range(D):
            n0, _ = node_origin(grid[..., d].detach().to(wdtype), orders[d])
            shape = [1] * (D + 1)
            shape[1 + d] = ishape[d]
            p = torch.arange(ishape[d], device=grid.device).reshape(shape)
            r = n0 - p - base[..., d]
            smin, smax = window_range(orders[d], sp[d])
            k = (r >= smin) & (r <= smax - orders[d])
            keep = k if keep is None else keep & k
    return keep.to(wdtype)


def _mask(grid, ishape, extrapolate, wdtype, orders, max_disp, spread,
          push=False):
    """The extrapolation mask times, in adaptive mode, the samples that
    keep their taps; None when every sample counts."""
    mask = inbounds_mask(grid, ishape, extrapolate, wdtype)
    if spread is None:
        return mask
    keep = _adaptive_keep(grid, orders, max_disp, spread, push, wdtype)
    return keep if mask is None else mask * keep


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


def _pull_impl_torch(inp, grid, orders, bounds, extrapolate, max_disp,
                     spread=None):
    """Plain shift-FMA pull: (B, C, *ishape), (B, *ishape, D) ->
    (B, C, *ishape)."""
    D = grid.shape[-1]
    ishape = tuple(inp.shape[-D:])
    wdtype = torch.promote_types(inp.dtype, grid.dtype)
    ranges = _shift_ranges(orders, max_disp, spread, D)
    lo, hi = _window_geom(ranges)
    vpad = _pad_folded(inp.to(wdtype), ishape, bounds, lo, hi, wdtype)
    coefs = _coef_fields(grid, orders, ranges, wdtype)
    out = _accumulate(vpad, ranges, coefs, lo, ishape)
    mask = _mask(grid, ishape, extrapolate, wdtype, orders, max_disp, spread)
    if mask is not None:
        out = out * mask[:, None]
    return out


def _grad_impl_torch(inp, grid, orders, bounds, extrapolate, max_disp,
                     spread=None):
    """Plain shift-FMA spatial gradients: (B, C, *ishape, D)."""
    D = grid.shape[-1]
    ishape = tuple(inp.shape[-D:])
    wdtype = torch.promote_types(inp.dtype, grid.dtype)
    ranges = _shift_ranges(orders, max_disp, spread, D)
    lo, hi = _window_geom(ranges)
    vpad = _pad_folded(inp.to(wdtype), ishape, bounds, lo, hi, wdtype)
    outs = []
    for da in range(D):
        coefs = _coef_fields(grid, orders, ranges, wdtype,
                             deriv_axes=(da,))
        outs.append(_accumulate(vpad, ranges, coefs, lo, ishape))
    out = torch.stack(outs, dim=-1)
    mask = _mask(grid, ishape, extrapolate, wdtype, orders, max_disp, spread)
    if mask is not None:
        out = out * mask[:, None, ..., None]
    return out


def _fold_pad_margins(acc, ishape, bounds, lo, hi, wdtype):
    """Adjoint of :func:`_pad_folded`: fold the pad margins back into the
    volume through the boundary (signs, then an index add per axis).
    ``acc``: (..., *padded_shape) -> (..., *ishape)."""
    D = len(ishape)
    out = acc
    for d in range(D):
        n = ishape[d]
        axis = out.ndim - D + d
        idx = np.arange(-lo[d], n + hi[d])
        folded = torch.as_tensor(fold_index(idx, n, bounds[d]),
                                 device=out.device)
        sign = fold_sign(idx, n, bounds[d], np.float64)
        if sign is not None:
            shape = [1] * out.ndim
            shape[axis] = idx.size
            out = out * torch.as_tensor(sign, dtype=wdtype,
                                        device=out.device).reshape(shape)
        seg = out.new_zeros(out.shape[:axis] + (n,) + out.shape[axis + 1:])
        out = seg.index_add_(axis, folded, out)
    return out


def _splat(acc, vals, ranges, coefs, lo, ishape):
    """Adjoint of :func:`_accumulate`, in place: for every shift s of the
    window, ``acc[p + s] += vals[p] * prod_d coef_d[s_d](p)``.
    ``acc``: (B, C, *padded_shape); ``vals``: (B, C, *ishape)."""
    D = len(ishape)
    spans = [range(r[1] - r[0] + 1) for r in ranges]
    for ks in itertools.product(*spans):
        w = None
        for d, k in enumerate(ks):
            cd = coefs[d][k]
            w = cd if w is None else w * cd
        idx = [slice(None)] * (acc.ndim - D)
        for d in range(D):
            start = lo[d] + ranges[d][0] + ks[d]
            idx.append(slice(start, start + ishape[d]))
        acc[tuple(idx)] += vals * w[:, None]


def _push_impl_torch(inp, grid, orders, bounds, extrapolate, max_disp,
                     spread=None):
    """Plain splat, the exact adjoint of :func:`_pull_impl_torch`:
    (B, C, *ishape) values at the grid sites -> (B, C, *ishape) volume.
    Masked values are zeroed before the splat; a site whose node origin
    leaves the window on some axis has a zero coefficient there and adds
    nothing (in adaptive mode: is masked)."""
    D = grid.shape[-1]
    ishape = tuple(grid.shape[1:-1])
    wdtype = torch.promote_types(inp.dtype, grid.dtype)
    ranges = _shift_ranges(orders, max_disp, spread, D)
    lo, hi = _window_geom(ranges)
    coefs = _coef_fields(grid, orders, ranges, wdtype)
    vals = inp.to(wdtype)
    mask = _mask(grid, ishape, extrapolate, wdtype, orders, max_disp, spread,
                 push=True)
    if mask is not None:
        vals = vals * mask[:, None]
    pshape = tuple(n + l + h for n, l, h in zip(ishape, lo, hi))
    acc = vals.new_zeros(tuple(vals.shape[:2]) + pshape)
    _splat(acc, vals, ranges, coefs, lo, ishape)
    return _fold_pad_margins(acc, ishape, bounds, lo, hi, wdtype)


# --------------------------------------- second-order windowed primitives
# The backward of grad_window.  At large volumes the plain versions stream
# x-slabs, as the JAX package's XLA tier does, so that the coefficient
# fields (~3 axes x S shifts x slab voxels) stay bounded.

_SLAB_VOX = 1 << 21


def _x_slabs(ishape):
    """Leading-axis slab spans [(x0, x1), ...] of the streamed plain
    versions (one span when the volume is small enough for one shot)."""
    numel = math.prod(ishape)
    one = [(0, ishape[0])]
    if len(ishape) < 2 or numel <= 2 * _SLAB_VOX:
        return one
    rest = numel // ishape[0]
    bx = max(1, _SLAB_VOX // max(1, rest))
    if bx >= ishape[0]:
        return one
    return [(x, min(x + bx, ishape[0])) for x in range(0, ishape[0], bx)]


def _shift_grid_x(grid_b, x0):
    """Move the leading-axis coordinate into the slab's frame (an integer
    shift: the taps are translation-invariant, and the voxel index of
    :func:`_coef_fields` is slab-local)."""
    if x0 == 0:
        return grid_b
    return torch.cat([grid_b[..., :1] - x0, grid_b[..., 1:]], -1)


def _pushgrad_impl_torch(inp, grid, orders, bounds, extrapolate, max_disp,
                         spread=None):
    """Plain pushgrad, the exact adjoint of :func:`_grad_impl_torch`:
    (B, C, *ishape, D) cotangents of the spatial gradient -> (B, C,
    *ishape), each component splatted through the derivative coefficient
    fields of its axis."""
    D = grid.shape[-1]
    ishape = tuple(grid.shape[1:-1])
    wdtype = torch.promote_types(inp.dtype, grid.dtype)
    ranges = _shift_ranges(orders, max_disp, spread, D)
    lo, hi = _window_geom(ranges)
    vals = inp.to(wdtype)
    mask = _mask(grid, ishape, extrapolate, wdtype, orders, max_disp, spread,
                 push=True)
    if mask is not None:
        vals = vals * mask[:, None, ..., None]
    pshape = tuple(n + l + h for n, l, h in zip(ishape, lo, hi))
    acc = vals.new_zeros(tuple(vals.shape[:2]) + pshape)
    for x0, x1 in _x_slabs(ishape):
        grid_b = _shift_grid_x(grid[:, x0:x1], x0)
        bshape = (x1 - x0,) + ishape[1:]
        # the slab's padded box starts at x0 of the whole padded volume
        acc_b = acc[:, :, x0:x1 + lo[0] + hi[0]]
        for da in range(D):
            coefs = _coef_fields(grid_b, orders, ranges, wdtype,
                                 deriv_axes=(da,))
            _splat(acc_b, vals[:, :, x0:x1, ..., da], ranges, coefs, lo,
                   bshape)
    return _fold_pad_margins(acc, ishape, bounds, lo, hi, wdtype)


def _hess_impl_torch(inp, grid, orders, bounds, extrapolate, max_disp,
                     spread=None):
    """Plain spatial Hessian of the spline surface: (B, C, *ishape) ->
    (B, C, *ishape, D, D), symmetric in the last two axes."""
    D = grid.shape[-1]
    ishape = tuple(inp.shape[-D:])
    wdtype = torch.promote_types(inp.dtype, grid.dtype)
    ranges = _shift_ranges(orders, max_disp, spread, D)
    lo, hi = _window_geom(ranges)
    vpad = _pad_folded(inp.to(wdtype), ishape, bounds, lo, hi, wdtype)
    ax = vpad.ndim - D
    parts = []
    for x0, x1 in _x_slabs(ishape):
        grid_b = _shift_grid_x(grid[:, x0:x1], x0)
        bshape = (x1 - x0,) + ishape[1:]
        vpad_b = vpad.narrow(ax, x0, x1 - x0 + lo[0] + hi[0])
        uniq = {}
        for d in range(D):
            for d2 in range(d, D):
                kw = dict(deriv2_axis=d) if d == d2 \
                    else dict(deriv_axes=(d, d2))
                coefs = _coef_fields(grid_b, orders, ranges, wdtype,
                                     **kw)
                uniq[(d, d2)] = _accumulate(vpad_b, ranges, coefs, lo,
                                            bshape)
        rows = [torch.stack([uniq[(min(d, d2), max(d, d2))]
                             for d2 in range(D)], dim=-1)
                for d in range(D)]
        parts.append(torch.stack(rows, dim=-2))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)
    mask = _mask(grid, ishape, extrapolate, wdtype, orders, max_disp, spread)
    if mask is not None:
        out = out * mask[:, None, ..., None, None]
    return out


# ------------------------------------------------------------ dispatch
# A CPU tensor runs the plain version, a CUDA tensor the kernel (which
# raises on what it does not take).  ``opts`` = (orders, bounds,
# extrapolate, max_disp, spread); ``grid`` is contiguous.

def _pull(inp, grid, opts):
    if inp.device.type == "cpu":
        return _pull_impl_torch(inp, grid, *opts)
    from .cuda_warp import warp_cuda
    return warp_cuda(inp.contiguous(), grid, *opts, value=True,
                     grad=False)[0]


def _grad(inp, grid, opts):
    if inp.device.type == "cpu":
        return _grad_impl_torch(inp, grid, *opts)
    from .cuda_warp import warp_cuda
    return warp_cuda(inp.contiguous(), grid, *opts, value=False,
                     grad=True)[1]


def _hess(inp, grid, opts):
    if inp.device.type == "cpu":
        return _hess_impl_torch(inp, grid, *opts)
    from .cuda_warp import hess_cuda
    return hess_cuda(inp.contiguous(), grid, *opts)


def _push(inp, grid, opts):
    if inp.device.type == "cpu":
        return _push_impl_torch(inp, grid, *opts)
    from .cuda_warp import push_cuda
    return push_cuda(inp.contiguous(), grid, *opts)


def _pushgrad(inp, grid, opts):
    if inp.device.type == "cpu":
        return _pushgrad_impl_torch(inp, grid, *opts)
    from .cuda_warp import push_cuda
    return push_cuda(inp.contiguous(), grid, *opts, deriv=True)


# ------------------------------------------------------------ adjoints
# Hand-wired backward rules, mirroring the JAX package's custom VJPs
# (interpol_tpu/ops/window.py:674-846).  The JAX rules sum over axis 0,
# the channel axis under vmap; in this batch-first layout that is dim 1.
# Each backward is composed from the Functions themselves, as the JAX rules
# call the wrapped ops, so a second backward (create_graph=True) re-enters
# the Functions and the kernels.  Every rule passes ``spread`` on (the
# "spread-aware adjoints"); each Function recomputes the tile bases from
# the same grid, so the adjoints drop the taps the forward dropped.  The
# grid is made contiguous once, before the Function (``dense_flow``
# returns a non-contiguous one), and saved as it is; only the cotangents
# asked for are computed.

_NONE = (None,) * 5


def _prepare(ctx, inp, grid, opts):
    ctx.opts = opts
    ctx.save_for_backward(inp, grid)
    return inp.detach(), grid.detach()


class PullWindow(torch.autograd.Function):
    """pull; backward: d_inp = push(ct), d_grid = sum_c grad(inp) ct."""

    @staticmethod
    def forward(ctx, inp, grid, orders, bounds, extrapolate, max_disp,
                spread):
        opts = (orders, bounds, extrapolate, max_disp, spread)
        return _pull(*_prepare(ctx, inp, grid, opts), opts)

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        ct = ct.contiguous()
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            d_inp = PushWindow.apply(ct, grid, *ctx.opts).to(inp.dtype)
        if ctx.needs_input_grad[1]:
            g = GradWindow.apply(inp, grid, *ctx.opts)
            d_grid = (g * ct[..., None]).sum(1).to(grid.dtype)
        return (d_inp, d_grid) + _NONE


class PushWindow(torch.autograd.Function):
    """push; backward: d_inp = pull(ct), d_grid = sum_c grad(ct) inp."""

    @staticmethod
    def forward(ctx, inp, grid, orders, bounds, extrapolate, max_disp,
                spread):
        opts = (orders, bounds, extrapolate, max_disp, spread)
        return _push(*_prepare(ctx, inp, grid, opts), opts)

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        ct = ct.contiguous()
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            d_inp = PullWindow.apply(ct, grid, *ctx.opts).to(inp.dtype)
        if ctx.needs_input_grad[1]:
            g = GradWindow.apply(ct, grid, *ctx.opts)
            d_grid = (g * inp[..., None]).sum(1).to(grid.dtype)
        return (d_inp, d_grid) + _NONE


class GradWindow(torch.autograd.Function):
    """grad; backward: d_inp = pushgrad(ct), d_grid = sum_{c,i}
    hess(inp)_ij ct_i."""

    @staticmethod
    def forward(ctx, inp, grid, orders, bounds, extrapolate, max_disp,
                spread):
        opts = (orders, bounds, extrapolate, max_disp, spread)
        return _grad(*_prepare(ctx, inp, grid, opts), opts)

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        ct = ct.contiguous()
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            d_inp = PushgradWindow.apply(ct, grid, *ctx.opts).to(inp.dtype)
        if ctx.needs_input_grad[1]:
            h = HessWindow.apply(inp, grid, *ctx.opts)
            d_grid = (h * ct[..., None]).sum((1, -2)).to(grid.dtype)
        return (d_inp, d_grid) + _NONE


class PushgradWindow(torch.autograd.Function):
    """pushgrad; backward: d_inp = grad(ct), d_grid = sum_{c,i}
    hess(ct)_ij inp_i."""

    @staticmethod
    def forward(ctx, inp, grid, orders, bounds, extrapolate, max_disp,
                spread):
        opts = (orders, bounds, extrapolate, max_disp, spread)
        return _pushgrad(*_prepare(ctx, inp, grid, opts), opts)

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        ct = ct.contiguous()
        d_inp = d_grid = None
        if ctx.needs_input_grad[0]:
            d_inp = GradWindow.apply(ct, grid, *ctx.opts).to(inp.dtype)
        if ctx.needs_input_grad[1]:
            h = HessWindow.apply(ct, grid, *ctx.opts)
            d_grid = (h * inp[..., None]).sum((1, -2)).to(grid.dtype)
        return (d_inp, d_grid) + _NONE


class HessWindow(torch.autograd.Function):
    """hess; backward: the VJP of the plain ``_hess_impl_torch`` through
    PyTorch's autograd, on every device (the JAX rule, window.py:734-744).
    This is third-order territory: the JAX package runs its XLA
    formulation there too, not a kernel.  In adaptive mode the VJP is that
    of the adaptive plain Hessian (the function the forward computes); the
    JAX rule takes its full-window XLA Hessian, the same function on grids
    that honour the spread."""

    @staticmethod
    def forward(ctx, inp, grid, orders, bounds, extrapolate, max_disp,
                spread):
        opts = (orders, bounds, extrapolate, max_disp, spread)
        return _hess(*_prepare(ctx, inp, grid, opts), opts)

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        wanted = [t for t, need in zip((inp, grid), ctx.needs_input_grad)
                  if need]
        if not wanted:
            return (None, None) + _NONE
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            # differentiable leaves: the saved tensors themselves when a
            # higher derivative is being built, detached copies otherwise
            leaves = [t if create else t.detach().requires_grad_()
                      for t in (inp, grid)]
            h = _hess_impl_torch(*leaves, *ctx.opts)
            picked = [l for l, need in zip(leaves, ctx.needs_input_grad)
                      if need]
            grads = list(torch.autograd.grad(h, picked, ct.to(h.dtype),
                                             create_graph=create))
        d_inp = grads.pop(0).to(inp.dtype) if ctx.needs_input_grad[0] \
            else None
        d_grid = grads.pop(0).to(grid.dtype) if ctx.needs_input_grad[1] \
            else None
        return (d_inp, d_grid) + _NONE


def _apply(fn, inp, grid, orders, bounds, extrapolate, max_disp, spread):
    """Run a window Function on the contiguous grid (one copy when the
    caller's grid is not contiguous, differentiable)."""
    D = grid.shape[-1]
    if spread is not None:
        spread = _md_tuple(spread, D)
    return fn.apply(inp, grid.contiguous(), tuple(orders), tuple(bounds),
                    extrapolate, max_disp, spread)


def pull_window(inp, grid, orders, bounds, extrapolate, max_disp,
                spread=None):
    """Dense-grid pull: (B, C, *ishape), (B, *ishape, D) -> (B, C, *ishape).

    CPU tensors run the plain shift-FMA version; CUDA tensors the CUDA
    kernel (float32 only).  Differentiable in ``inp`` and ``grid``, to any
    order.  ``spread``: the adaptive per-tile windows (module notes),
    forward and every adjoint."""
    return _apply(PullWindow, inp, grid, orders, bounds, extrapolate,
                  max_disp, spread)


def push_window(inp, grid, orders, bounds, extrapolate, max_disp,
                spread=None):
    """Dense-grid splat, the exact adjoint of :func:`pull_window`:
    (B, C, *ishape), (B, *ishape, D) -> (B, C, *ishape).  ``spread``: the
    adaptive windows over the push's tiles."""
    return _apply(PushWindow, inp, grid, orders, bounds, extrapolate,
                  max_disp, spread)


def grad_window(inp, grid, orders, bounds, extrapolate, max_disp,
                spread=None):
    """Dense-grid spatial gradients of the spline surface:
    (B, C, *ishape), (B, *ishape, D) -> (B, C, *ishape, D)."""
    return _apply(GradWindow, inp, grid, orders, bounds, extrapolate,
                  max_disp, spread)


def pushgrad_window(inp, grid, orders, bounds, extrapolate, max_disp,
                    spread=None):
    """Adjoint of :func:`grad_window`: (B, C, *ishape, D) cotangents ->
    (B, C, *ishape)."""
    return _apply(PushgradWindow, inp, grid, orders, bounds, extrapolate,
                  max_disp, spread)


def hess_window(inp, grid, orders, bounds, extrapolate, max_disp,
                spread=None):
    """Spatial Hessian of the spline surface: (B, C, *ishape) ->
    (B, C, *ishape, D, D), symmetric.  Differentiable (third order, through
    the plain version)."""
    return _apply(HessWindow, inp, grid, orders, bounds, extrapolate,
                  max_disp, spread)
