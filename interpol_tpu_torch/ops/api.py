"""User-facing API: shape engine, option normalization, grid constructors.

PyTorch port of ``interpol_tpu/ops/api.py:43-177, 338-424, 452-503``, with
the same signatures, defaults and layouts: images ``(..., [C], *sp)``,
grids ``(..., *sp, D)`` in voxel coordinates (not torch's normalized
[-1, 1]), ``grid_grad`` output ``(..., [C], *sp, D)``.  Batch dimensions of
image and grid broadcast against each other.

``max_disp`` selects the dense-warp path (``ops/window.py``) for a grid
with one sample per voxel; every other call takes the generic path
(``ops/pushpull.py``), any grid and any output ``shape``.  Both run the
CUDA kernels for CUDA tensors and the plain versions for CPU tensors, and
both are differentiable in image and grid, to second order, through
hand-wired adjoints.
``tile_spread`` selects the adaptive per-tile windows of the dense-warp
path (the JAX package's Pallas kernels' mode, which the port runs on every
device); ``check_spread=True`` measures the grid and raises
``RuntimeError`` where it breaks ``max_disp`` or ``tile_spread``, with the
JAX package's messages (``api.py:180-272``), after one host sync.
``required_tile_spread`` gives the spread a grid needs.

``prefilter=True`` runs the interpolating prefilter (``ops/coeff.py``,
public as ``spline_coeff`` / ``spline_coeff_nd``) before the pull and the
gradient and after the splat; it is the identity along an axis of order 0
or 1.  Label maps (``classes=`` or an integer input to ``grid_pull``) are
pulled one class at a time as soft maps, each optionally prefiltered, on
the dense-warp path when ``max_disp`` applies and on the generic path
otherwise, and rebuilt by a strict argmax in the order of the classes
(the JAX package's ``_label_pull``, ``api.py:307-336``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..options import normalize_options, to_bound, to_order
from ..utils.shapes import expanded_shape
from . import coeff as _coeff
from . import pushpull as _pp
from . import window as _window
from .tiles import base_field, default_tile, tile_bases

__all__ = ["grid_pull", "grid_push", "grid_count", "grid_grad",
           "spline_coeff", "spline_coeff_nd", "required_tile_spread",
           "identity_grid", "add_identity_grid", "add_identity_grid_",
           "affine_grid", "pull", "push", "count"]


# ------------------------------------------------- shape engine

def _preproc(grid, inp=None, mode=None):
    """Broadcast/reshape user layouts ``(..., [C], *sp)`` / ``(..., *sp, D)``
    to kernel layouts ``(B, C, *sp)`` / ``(B, *sp, D)``.  Without ``inp``
    (``grid_count``) only the grid is reshaped; ``mode="push"`` broadcasts
    the spatial shapes of image and grid against each other."""
    D = grid.shape[-1]
    if inp is None:
        spatial = tuple(grid.shape[-D - 1:-1])
        batch = tuple(grid.shape[:-D - 1])
        grid = grid.reshape((-1,) + spatial + (D,))
        info = dict(batch=batch, channel=(1,) if batch else (), dim=D)
        return grid, info

    grid_spatial = tuple(grid.shape[-D - 1:-1])
    grid_batch = tuple(grid.shape[:-D - 1])
    inp_spatial = tuple(inp.shape[-D:])
    channel = 0 if inp.ndim == D else inp.shape[-D - 1]
    inp_batch = tuple(inp.shape[:-D - 1])

    if mode == "push":
        grid_spatial = inp_spatial = expanded_shape(grid_spatial,
                                                    inp_spatial)

    batch = expanded_shape(grid_batch, inp_batch)
    grid = torch.broadcast_to(grid, batch + grid_spatial + (D,))
    grid = grid.reshape((-1,) + grid_spatial + (D,))
    inp = torch.broadcast_to(inp, batch + (channel or 1,) + inp_spatial)
    inp = inp.reshape((-1, channel or 1) + inp_spatial)

    out_channel = (channel,) if channel else ((1,) if batch else ())
    info = dict(batch=batch, channel=out_channel, dim=D)
    return grid, inp, info


def _postproc(out, info, mode):
    """Kernel layout back to user layout."""
    D = info["dim"]
    if mode != "grad":
        spatial = tuple(out.shape[-D:])
        feat = ()
    else:
        spatial = tuple(out.shape[-D - 1:-1])
        feat = (out.shape[-1],)
    return out.reshape(info["batch"] + info["channel"] + spatial + feat)


def _use_window(max_disp, grid, inp):
    """Dense-grid + bounded-displacement path applies when the grid has
    one sample per input voxel and the caller declared a bound."""
    return (max_disp is not None
            and tuple(grid.shape[1:-1]) == tuple(inp.shape[2:]))


def _md_norm(max_disp):
    """Scalar-or-per-axis displacement bound as floats."""
    if isinstance(max_disp, (tuple, list)):
        return tuple(float(m) for m in max_disp)
    return float(max_disp)


def _sp_norm(tile_spread, max_disp):
    if tile_spread is not None and max_disp is None:
        raise ValueError("tile_spread requires max_disp (the adaptive "
                         "window refines the dense-warp fast path)")
    return None if tile_spread is None else _md_norm(tile_spread)


# ------------------------------------------------- contract checks

def _per_axis(v, D):
    v = _md_norm(v)
    return v if isinstance(v, tuple) else (v,) * D


def _iota(ishape, dtype, device):
    return torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=dtype, device=device) for n in ishape],
        indexing="ij"), -1)


def _disp_violation(grid_b, ishape, max_disp):
    """Per-axis excess of the raw |displacement| of a dense (B, *sp, D)
    grid over the declared ``max_disp``: (excess (D,), measured (D,))."""
    D = grid_b.shape[-1]
    md = torch.tensor(_per_axis(max_disp, D), dtype=grid_b.dtype,
                      device=grid_b.device)
    disp = grid_b - _iota(ishape, grid_b.dtype, grid_b.device)
    measured = disp.abs().reshape(-1, D).amax(0)
    return measured - md, measured


def _spread_violation(grid_b, ishape, tile, tile_spread, max_disp):
    """Per-axis excess of the residual |d - base| over the kernel tiles
    (the bases the kernels use, ``ops/tiles.py``) over the declared
    ``tile_spread``: (excess (D,), measured (D,))."""
    D = grid_b.shape[-1]
    sp = torch.tensor(_per_axis(tile_spread, D), dtype=grid_b.dtype,
                      device=grid_b.device)
    bases = tile_bases(grid_b, _per_axis(max_disp, D), tile)
    disp = grid_b - _iota(ishape, grid_b.dtype, grid_b.device)
    res = disp - base_field(bases, tile, ishape)
    measured = res.abs().reshape(-1, D).amax(0)
    return measured - sp, measured


def _raise_spread_violation(excess, measured, spread=None):
    if bool(np.any(np.asarray(excess) > 0)):
        raise RuntimeError(
            f"adaptive-window contract VIOLATED: measured per-axis "
            f"tile residual spread {tuple(np.round(np.asarray(measured), 4))} "
            f"exceeds the declared tile_spread {spread}; the adaptive "
            f"kernel silently drops out-of-window taps for such fields. "
            f"Raise tile_spread (see required_tile_spread) or drop it.")


def _raise_disp_violation(excess, measured, max_disp=None):
    if bool(np.any(np.asarray(excess) > 0)):
        raise RuntimeError(
            f"windowed-contract VIOLATED: measured per-axis "
            f"|displacement| {tuple(np.round(np.asarray(measured), 4))} "
            f"exceeds the declared max_disp {max_disp}; the windowed "
            f"kernel silently drops out-of-window taps for such "
            f"samples.  Raise max_disp or drop it (gather fallback).")


def _check_spread(grid_b, ishape, tile_spread, max_disp):
    """``check_spread=True`` of grid_pull / grid_grad / grid_push: check
    the raw ``max_disp`` bound always, and the per-tile residual spread
    when ``tile_spread`` is declared; raise ``RuntimeError`` on the host
    (one sync) where either is broken."""
    with torch.no_grad():
        grid_b = grid_b.detach()
        excess, measured = _disp_violation(grid_b, ishape, max_disp)
        _raise_disp_violation(excess.cpu().numpy(), measured.cpu().numpy(),
                              max_disp=_md_norm(max_disp))
        if tile_spread is None:
            return
        tile = default_tile(tuple(ishape)) or (8, 128)
        excess, measured = _spread_violation(grid_b, ishape, tile,
                                             tile_spread, max_disp)
        _raise_spread_violation(excess.cpu().numpy(),
                                measured.cpu().numpy(),
                                spread=_md_norm(tile_spread))


def required_tile_spread(grid, tile=(8, 8, 128)):
    """Per-axis residual displacement bound of a dense sampling grid over
    the kernel's tiles, the value to pass as ``tile_spread``.

    grid: (..., *spatial, D) dense sampling grid (voxel coordinates).
    Returns a per-axis tuple of floats: max over tiles of |d_a(p) -
    round(mean_tile(d_a))|, with the grid edge-replicated up to tile
    multiples (what the kernels do).  One host sync."""
    g = torch.as_tensor(grid).detach().cpu().numpy()
    D = g.shape[-1]
    sp = g.shape[-D - 1:-1]
    g = g.reshape((-1,) + tuple(sp) + (D,))
    tile = tuple(tile)[-D:]
    out = []
    for d in range(D):
        iota = np.arange(sp[d]).reshape(
            [1] * (1 + d) + [sp[d]] + [1] * (D - 1 - d))
        disp = g[..., d] - iota
        pads = [(0, 0)] + [(0, (-n) % t) for n, t in zip(sp, tile)]
        disp = np.pad(disp, pads, mode="edge")
        shp = [disp.shape[0]]
        for n, t in zip(disp.shape[1:], tile):
            shp += [n // t, t]
        disp = disp.reshape(shp)
        axes = tuple(range(2, 2 + 2 * D, 2))
        m = np.round(disp.mean(axis=axes, keepdims=True))
        out.append(float(np.abs(disp - m).max()))
    return tuple(out)


# ------------------------------------------------- main ops

def grid_pull(input, grid, interpolation="linear", bound="zero",
              extrapolate=False, prefilter=False, *, classes=None,
              max_disp=None, tile_spread=None, check_spread=False):
    """Sample an image at the positions of a deformation field.

    input : (..., [channel], *inshape) tensor
    grid : (..., *outshape, dim) tensor of voxel coordinates
    interpolation : int/str or per-dim sequence, default='linear'
    bound : int/str or per-dim sequence, default='zero'
    extrapolate : bool or int {0,1,2='hist'}, default=False
    prefilter : bool — run the interpolating prefilter on the input first
        (the spline then passes through the input's values)
    classes : optional sequence of labels — pull a label map: one soft map
        per class, rebuilt by argmax; an integer input is a label map with
        ``classes`` its sorted unique values (one host sync).  The output
        has the input's dtype.
    max_disp : optional float or per-axis tuple — declares that every
        sample lies within ``max_disp`` voxels of its own site (dense warp
        grids).  Samples breaking the bound lose the taps outside the
        window, exactly as in the JAX package.
    tile_spread : optional float or per-axis tuple — the adaptive per-tile
        windows: bounds the residual displacement |d - round(mean)| over
        each (8, 8, 128) tile of the kernel per axis.  Samples breaking it
        lose their taps.  Requires ``max_disp``.
    check_spread : bool — measure this grid's |displacement| (and, with
        ``tile_spread``, its per-tile residual spread) and raise
        ``RuntimeError`` where it breaks the declared bound.

    Returns (..., [channel], *outshape).
    """
    input = torch.as_tensor(input)
    grid = torch.as_tensor(grid)
    D = grid.shape[-1]
    orders, bounds, ex = normalize_options(interpolation, bound,
                                           extrapolate, D)
    sp = _sp_norm(tile_spread, max_disp)
    if classes is not None or not torch.is_floating_point(input):
        return _label_pull(input, grid, orders, bounds, ex, prefilter,
                           classes, max_disp, sp)
    grid, inp, info = _preproc(grid, input)
    if prefilter:
        inp = _coeff.spline_coeff_nd(inp, orders, bounds, D)
    if _use_window(max_disp, grid, inp):
        if check_spread:
            _check_spread(grid, inp.shape[2:], tile_spread, max_disp)
        out = _window.pull_window(inp, grid, orders, bounds, ex,
                                  _md_norm(max_disp), sp)
    else:
        out = _pp.pull(inp, grid, orders, bounds, ex)
    return _postproc(out, info, "pull")


def _label_pull(input, grid, orders, bounds, ex, prefilter, classes,
                max_disp, spread):
    """Pull each class's soft map ``input == label`` (prefiltered when
    asked); in the order of ``classes``, a class takes the voxels where
    its pulled value is strictly above the running maximum, which starts
    at 0 with label 0 (the JAX package's ``_label_pull``, its tie rule
    included; no ``check_spread`` there either).  ``classes=None`` takes
    the sorted unique values (one host sync).  The output has the input's
    dtype and no gradient: the pulls run on the detached grid, so no
    Function saves tensors for a backward, and each class is freed before
    the next."""
    if classes is None:
        classes = torch.unique(input).tolist()
    grid, inp, info = _preproc(grid.detach(), input)
    D = grid.shape[-1]
    fdtype = grid.dtype if torch.is_floating_point(grid) else torch.float32
    oshape = inp.shape[:2] + grid.shape[1:-1]
    out = torch.zeros(oshape, dtype=input.dtype, device=inp.device)
    pmax = torch.zeros(oshape, dtype=fdtype, device=inp.device)
    windowed = _use_window(max_disp, grid, inp)
    with torch.no_grad():
        for label in classes:
            soft = (inp == label).to(fdtype)
            if prefilter:
                soft = _coeff.spline_coeff_nd(soft, orders, bounds, D)
            if windowed:
                soft = _window.pull_window(soft, grid, orders, bounds, ex,
                                           _md_norm(max_disp), spread)
            else:
                soft = _pp.pull(soft, grid, orders, bounds, ex)
            out.masked_fill_(soft > pmax, label)
            torch.maximum(pmax, soft, out=pmax)
            del soft
    return _postproc(out, info, "pull")


def grid_push(input, grid, shape=None, interpolation="linear",
              bound="zero", extrapolate=False, prefilter=False, *,
              max_disp=None, tile_spread=None, check_spread=False):
    """Splat an image at the positions of a deformation field (the adjoint
    of :func:`grid_pull`).

    input : (..., [channel], *inshape) values at the grid's sites
    grid : (..., *inshape, dim) tensor of voxel coordinates
    shape : output spatial shape, default ``inshape``
    max_disp : the dense-warp path when ``shape`` is the grid's own;
        ``tile_spread`` its adaptive windows over the push's tiles; other
        options as :func:`grid_pull`.

    Returns (..., [channel], *shape).
    """
    input = torch.as_tensor(input)
    grid = torch.as_tensor(grid)
    D = grid.shape[-1]
    orders, bounds, ex = normalize_options(interpolation, bound,
                                           extrapolate, D)
    sp = _sp_norm(tile_spread, max_disp)
    if not torch.is_floating_point(input):
        input = input.to(grid.dtype)     # an integer map splats as floats
    grid, inp, info = _preproc(grid, input, mode="push")
    shape = tuple(inp.shape[2:]) if shape is None \
        else tuple(int(s) for s in shape)
    if (max_disp is not None and shape == tuple(inp.shape[2:])
            and tuple(grid.shape[1:-1]) == shape):
        if check_spread:
            _check_spread(grid, shape, tile_spread, max_disp)
        out = _window.push_window(inp, grid, orders, bounds, ex,
                                  _md_norm(max_disp), sp)
    else:
        out = _pp.push(inp, grid, shape, orders, bounds, ex)
    if prefilter:
        out = _coeff.spline_coeff_nd(out, orders, bounds, D)
    return _postproc(out, info, "push")


def grid_count(grid, shape=None, interpolation="linear", bound="zero",
               extrapolate=False, *, max_disp=None, tile_spread=None):
    """Splat unit weights: the density of the deformation field,
    (..., *shape).  ``max_disp`` selects the dense-warp path when
    ``shape`` is the grid's own, ``tile_spread`` its adaptive windows."""
    grid = torch.as_tensor(grid)
    D = grid.shape[-1]
    orders, bounds, ex = normalize_options(interpolation, bound,
                                           extrapolate, D)
    sp = _sp_norm(tile_spread, max_disp)
    grid, info = _preproc(grid)
    shape = tuple(grid.shape[1:-1]) if shape is None \
        else tuple(int(s) for s in shape)
    if max_disp is not None and shape == tuple(grid.shape[1:-1]):
        ones = grid.new_ones((grid.shape[0], 1) + shape)
        out = _window.push_window(ones, grid, orders, bounds, ex,
                                  _md_norm(max_disp), sp)
    else:
        out = _pp.count(grid, shape, orders, bounds, ex)
    return _postproc(out, info, "count")


def grid_grad(input, grid, interpolation="linear", bound="zero",
              extrapolate=False, prefilter=False, *, max_disp=None,
              tile_spread=None, check_spread=False):
    """Sample spatial gradients of an image at the positions of a
    deformation field: (..., [C], *sp), (..., *sp, D) ->
    (..., [C], *sp, D).  Options as :func:`grid_pull`."""
    input = torch.as_tensor(input)
    grid = torch.as_tensor(grid)
    D = grid.shape[-1]
    orders, bounds, ex = normalize_options(interpolation, bound,
                                           extrapolate, D)
    sp = _sp_norm(tile_spread, max_disp)
    if not torch.is_floating_point(input):
        input = input.to(grid.dtype)
    grid, inp, info = _preproc(grid, input)
    if prefilter:
        inp = _coeff.spline_coeff_nd(inp, orders, bounds, D)
    if _use_window(max_disp, grid, inp):
        if check_spread:
            _check_spread(grid, inp.shape[2:], tile_spread, max_disp)
        out = _window.grad_window(inp, grid, orders, bounds, ex,
                                  _md_norm(max_disp), sp)
    else:
        out = _pp.grad(inp, grid, orders, bounds, ex)
    return _postproc(out, info, "grad")


# ------------------------------------------------- prefilter API

def spline_coeff(input, interpolation="linear", bound="dct2", dim=-1):
    """Interpolating spline coefficients along axis ``dim`` of ``input``
    (any layout): the prefilter that makes the spline built on them pass
    through the input's values.  Bounds dct1/dct2/dft and their
    zero/replicate aliases; the identity at orders 0 and 1."""
    input = torch.as_tensor(input)
    (order,) = to_order(interpolation, 1)
    (bnd,) = to_bound(bound, 1)
    return _coeff.spline_coeff(input, order, bnd, axis=dim)


def spline_coeff_nd(input, interpolation="linear", bound="dct2", dim=None):
    """Interpolating spline coefficients along the last ``dim`` axes of
    ``input`` (``None``: every axis), one separable sweep per axis."""
    input = torch.as_tensor(input)
    if dim is None:
        dim = input.ndim
    orders = to_order(interpolation, dim)
    bounds = to_bound(bound, dim)
    return _coeff.spline_coeff_nd(input, orders, bounds, dim)


# ------------------------------------------------- grid constructors

def identity_grid(shape: Sequence[int], dtype=None,
                  device=None) -> torch.Tensor:
    """Identity deformation field in voxel coordinates, ``(*shape, dim)``."""
    dtype = dtype or torch.float32
    mesh = torch.meshgrid(*[torch.arange(s, dtype=dtype, device=device)
                            for s in shape], indexing="ij")
    return torch.stack(mesh, dim=-1)


def add_identity_grid(disp: torch.Tensor) -> torch.Tensor:
    """Displacement field -> sampling field: add the identity grid."""
    disp = torch.as_tensor(disp)
    D = disp.shape[-1]
    spatial = disp.shape[-D - 1:-1]
    return disp + identity_grid(spatial, dtype=disp.dtype,
                                device=disp.device)


def affine_grid(mat: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Dense sampling grid from affine matrices ``(..., D[+1], D+1)`` over
    a ``shape``-sized volume."""
    mat = torch.as_tensor(mat)
    shape = tuple(int(s) for s in shape)
    D = mat.shape[-1] - 1
    if D != len(shape):
        raise ValueError(
            f"Affine matrix dimension ({D}) does not match shape "
            f"length ({len(shape)}).")
    if mat.shape[-2] not in (D, D + 1):
        raise ValueError(
            f"Affine matrices must have shape (..., {D}, {D + 1}) or "
            f"(..., {D + 1}, {D + 1}); got {tuple(mat.shape)}.")
    batch = tuple(mat.shape[:-2])
    grid = identity_grid(shape, dtype=mat.dtype, device=mat.device)
    lin = mat[..., :D, :D].reshape(batch + (1,) * D + (D, D))
    off = mat[..., :D, -1].reshape(batch + (1,) * D + (D,))
    return (lin @ grid[..., None])[..., 0] + off


# the in-place spelling of the reference API, out of place as in the JAX
# package, so that code written against it runs unchanged
add_identity_grid_ = add_identity_grid
pull = grid_pull
push = grid_push
count = grid_count
