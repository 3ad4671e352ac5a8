"""Plain spline sampling for the reference: direct-gather pull, its
spatial gradient and its adjoint (push), the spline gradient at the
identity grid, the separable ``resize``, scaling and squaring, and the
label rule.

Every volume is unbatched and channel first, ``(C, X, Y, Z)``; a grid is
``(X, Y, Z, 3)`` in voxel coordinates; the bound is dct2 and samples
outside the volume extrapolate through it (the configurations' options).
The gather reads the ``(order + 1)^3`` taps of each sample straight from
the folded volume, as ``interpol_tpu_torch/ops/ndkernels.py::pull_core``
does; no window, so it holds only where every displacement lies within
the configuration's ``max_disp`` (the inputs are made so).  The pull is
a ``torch.autograd.Function`` whose backward is the push (image
cotangent) and the contracted spatial gradient (grid cotangent), written
out as ``interpol_tpu_torch/ops/window.py``'s adjoints are, so that no
tap's tensors are kept for the backward.
"""
from __future__ import annotations

import itertools
import math

import torch

from .splines import bspline_taps, fold_dct2, node_origin


def _taps(grid, order, shape, grad=False):
    """Yield ``(flat index, weight, spatial derivatives or None)`` for
    each of the ``(order + 1)^3`` taps of every sample of ``grid``."""
    axes = []
    for d in range(3):
        n0, t = node_origin(grid[..., d], order)
        w, dw = bspline_taps(t, order, grad)
        idx = [fold_dct2(n0 + j, shape[d]) for j in range(order + 1)]
        axes.append((idx, w, dw))
    (ix, wx, dx), (iy, wy, dy), (iz, wz, dz) = axes
    sx, sy = shape[1] * shape[2], shape[2]
    T = range(order + 1)
    for a, b, c in itertools.product(T, T, T):
        i = ix[a] * sx + iy[b] * sy + iz[c]
        w = wx[a] * wy[b] * wz[c]
        d = None
        if grad:
            d = (dx[a] * wy[b] * wz[c], wx[a] * dy[b] * wz[c],
                 wx[a] * wy[b] * dz[c])
        yield i.reshape(-1), w, d


def pull_value(inp, grid, order):
    """``out[c, p] = sum_taps w * inp[c, tap]``: (C, *sp), (*sp, 3) ->
    (C, *sp)."""
    C, shape = inp.shape[0], tuple(inp.shape[1:])
    flat = inp.reshape(C, -1)
    out = None
    for i, w, _ in _taps(grid, order, shape):
        term = flat[:, i].reshape((C,) + tuple(grid.shape[:-1])) * w
        out = term if out is None else out + term
    return out


def spatial_grad(inp, grid, order):
    """Spatial gradient of the spline at the samples: (C, *sp, 3)."""
    C, shape = inp.shape[0], tuple(inp.shape[1:])
    flat = inp.reshape(C, -1)
    out = [None, None, None]
    for i, _, dws in _taps(grid, order, shape, grad=True):
        v = flat[:, i].reshape((C,) + tuple(grid.shape[:-1]))
        for d in range(3):
            term = v * dws[d]
            out[d] = term if out[d] is None else out[d] + term
    return torch.stack(out, -1)


def push(vals, grid, order, shape):
    """Adjoint of :func:`pull_value`: splat ``vals`` (C, *gsp) at the
    samples of ``grid`` onto a (C, *shape) volume."""
    C = vals.shape[0]
    acc = vals.new_zeros((C, math.prod(shape)))
    for i, w, _ in _taps(grid, order, tuple(shape)):
        acc.index_add_(1, i, (vals * w).reshape(C, -1))
    return acc.reshape((C,) + tuple(shape))


class _Pull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inp, grid, order):
        ctx.save_for_backward(inp, grid)
        ctx.order = order
        return pull_value(inp, grid, order)

    @staticmethod
    def backward(ctx, ct):
        inp, grid = ctx.saved_tensors
        g_inp = g_grid = None
        if ctx.needs_input_grad[0]:
            g_inp = push(ct, grid, ctx.order, tuple(inp.shape[1:]))
        if ctx.needs_input_grad[1]:
            g_grid = (spatial_grad(inp, grid, ctx.order)
                      * ct[..., None]).sum(0)
        return g_inp, g_grid, None


def pull(inp, grid, order):
    """Differentiable pull (C, *sp) at (*gsp, 3) -> (C, *gsp)."""
    return _Pull.apply(inp, grid, order)


def identity(shape, dtype, device):
    """Identity grid (*shape, 3) in voxel coordinates."""
    return torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=dtype, device=device) for n in shape],
        indexing="ij"), -1)


def _filter(v, axis, taps, offset):
    """``sum_j taps[j] * v[fold(x + offset + j)]`` along ``axis``."""
    n = v.shape[axis]
    base = torch.arange(n, device=v.device) + offset
    out = None
    for j, w in enumerate(taps):
        if w == 0.0:
            continue
        term = torch.index_select(v, axis, fold_dct2(base + j, n)) * w
        out = term if out is None else out + term
    return out


def spline_grad_identity(u, order):
    """Spatial gradient of the (unprefiltered) spline of ``u`` (C, *sp) at
    the voxels: (C, *sp, 3), separable (every sample of the identity grid
    has the same taps)."""
    offset = math.floor(-(order - 1) / 2)
    t = torch.tensor(float(-offset), dtype=torch.float64)
    w, dw = bspline_taps(t, order, grad=True)
    w, dw = [float(x) for x in w], [float(x) for x in dw]
    outs = []
    for d in range(3):
        g = u
        for a in range(3):
            g = _filter(g, 1 + a, dw if a == d else w, offset)
        outs.append(g)
    return torch.stack(outs, -1)


def jacobian_det(u, order=3):
    """det(I + grad u) of a displacement ``u`` (3, *sp): (*sp)."""
    g = spline_grad_identity(u, order)     # (i, *sp, j)
    J = [[g[i, ..., j] + (1.0 if i == j else 0.0) for j in range(3)]
         for i in range(3)]
    c0 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
    c1 = J[1][0] * J[2][2] - J[1][2] * J[2][0]
    c2 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
    return J[0][0] * c0 - J[0][1] * c1 + J[0][2] * c2


def sampling_matrix(n_out, n_in, order, dtype, device):
    """Dense (n_out, n_in) matrix of the 1-D spline resample of the edges
    anchor (``interpol_tpu_torch/ops/resize.py``'s ``"e"`` line, then
    ``separable.py::sampling_matrix``), dct2, extrapolating."""
    scale = n_in / n_out
    line = (torch.arange(n_out, dtype=torch.float64) * scale
            + 0.5 * (scale - 1)).to(dtype)
    n0, t = node_origin(line, order)
    w, _ = bspline_taps(t, order)
    S = torch.zeros((n_out, n_in), dtype=dtype)
    rows = torch.arange(n_out)
    for j in range(order + 1):
        S.index_put_((rows, fold_dct2(n0 + j, n_in)), w[j], accumulate=True)
    return S.to(device)


def resize(v, shape, order):
    """Separable resample of ``v`` (C, *sp) to ``shape``: one matrix a
    spatial axis, applied by ``tensordot`` (a matmul, so TF32 reaches it
    where it is switched on)."""
    out = v
    for d, n_out in enumerate(shape):
        S = sampling_matrix(n_out, out.shape[1 + d], order, v.dtype,
                            v.device)
        out = torch.movedim(torch.tensordot(S, out, dims=([1], [1 + d])),
                            0, 1 + d)
    return out


def exp_disp(vel, steps):
    """Scaling and squaring of a velocity (3, *sp): ``u = vel / 2^steps``,
    then ``steps`` times ``u <- u(x + u(x)) + u(x)`` (linear pulls)."""
    ident = identity(tuple(vel.shape[1:]), vel.dtype, vel.device)
    u = vel * (2.0 ** -steps)
    for _ in range(steps):
        u = pull(u, ident + torch.movedim(u, 0, -1), 1) + u
    return u


def label_pull(labels, grid, classes, order, chunk=12):
    """The label rule of ``interpol_tpu_torch/ops/api.py::_label_pull``:
    pull each class's soft map; in the order of ``classes`` a class takes
    the voxels where its value is strictly above the running maximum,
    which starts at 0 with label 0.  ``labels`` (*sp) integer; returns
    (*gsp) of its dtype.  Pulls ``chunk`` classes at a time."""
    dtype = grid.dtype
    out = torch.zeros(grid.shape[:-1], dtype=labels.dtype,
                      device=labels.device)
    pmax = torch.zeros(grid.shape[:-1], dtype=dtype, device=labels.device)
    for k in range(0, len(classes), chunk):
        part = classes[k:k + chunk]
        soft = torch.stack([(labels == c).to(dtype) for c in part])
        soft = pull_value(soft, grid, order)
        for c, s in zip(part, soft):
            out.masked_fill_(s > pmax, c)
            torch.maximum(pmax, s, out=pmax)
    return out
