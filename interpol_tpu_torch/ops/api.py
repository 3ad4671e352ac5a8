"""User-facing API: shape engine, option normalization, grid constructors.

PyTorch port of ``interpol_tpu/ops/api.py:43-177, 396-424, 452-497``, with
the same signatures, defaults and layouts: images ``(..., [C], *sp)``,
grids ``(..., *sp, D)`` in voxel coordinates (not torch's normalized
[-1, 1]), ``grid_grad`` output ``(..., [C], *sp, D)``.  Batch dimensions of
image and grid broadcast against each other.

``max_disp`` selects the dense-warp path (``ops/window.py``: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors); without it
``grid_pull`` / ``grid_grad`` run the plain gather of ``ops/ndkernels.py``.
``tile_spread`` is accepted and ignored (full window), as the JAX
package's XLA tier ignores it.  Not ported yet, and raising
``NotImplementedError``: label maps (``classes=`` or integer input),
``prefilter=True`` and ``check_spread=True``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..options import normalize_options
from ..utils.shapes import expanded_shape
from . import ndkernels as _nd
from . import window as _window

__all__ = ["grid_pull", "grid_grad", "identity_grid", "add_identity_grid",
           "affine_grid"]


# ------------------------------------------------- shape engine

def _preproc(grid, inp):
    """Broadcast/reshape user layouts ``(..., [C], *sp)`` / ``(..., *sp, D)``
    to kernel layouts ``(B, C, *sp)`` / ``(B, *sp, D)``."""
    D = grid.shape[-1]
    grid_spatial = tuple(grid.shape[-D - 1:-1])
    grid_batch = tuple(grid.shape[:-D - 1])
    inp_spatial = tuple(inp.shape[-D:])
    channel = 0 if inp.ndim == D else inp.shape[-D - 1]
    inp_batch = tuple(inp.shape[:-D - 1])

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


def _not_ported(input, classes, prefilter, check_spread, tile_spread,
                max_disp):
    if tile_spread is not None and max_disp is None:
        raise ValueError("tile_spread requires max_disp (the adaptive "
                         "window refines the dense-warp fast path)")
    if classes is not None or not torch.is_floating_point(input):
        raise NotImplementedError(
            "label maps (classes= or integer input) are not ported yet "
            "(ROADMAP queue 1, Label maps)")
    if prefilter:
        raise NotImplementedError(
            "prefilter=True needs ops/coeff.py, which is not ported yet "
            "(ROADMAP queue 1, Prefilter)")
    if check_spread:
        raise NotImplementedError(
            "check_spread=True is not ported yet (ROADMAP queue 1, "
            "Adaptive windows)")


def _flat(grid):
    return grid.reshape(grid.shape[0], -1, grid.shape[-1])


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
    max_disp : optional float or per-axis tuple — declares that every
        sample lies within ``max_disp`` voxels of its own site (dense warp
        grids).  Samples breaking the bound lose the taps outside the
        window, exactly as in the JAX package.

    Returns (..., [channel], *outshape).
    """
    input = torch.as_tensor(input)
    grid = torch.as_tensor(grid)
    D = grid.shape[-1]
    orders, bounds, ex = normalize_options(interpolation, bound,
                                           extrapolate, D)
    _not_ported(input, classes, prefilter, check_spread, tile_spread,
                max_disp)
    grid, inp, info = _preproc(grid, input)
    if _use_window(max_disp, grid, inp):
        out = _window.pull_window(inp, grid, orders, bounds, ex,
                                  _md_norm(max_disp))
    else:
        out = _nd.pull_core(inp, _flat(grid), orders, bounds, ex)
        out = out.reshape(out.shape[:2] + grid.shape[1:-1])
    return _postproc(out, info, "pull")


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
    _not_ported(input, None, prefilter, check_spread, tile_spread,
                max_disp)
    grid, inp, info = _preproc(grid, input)
    if _use_window(max_disp, grid, inp):
        out = _window.grad_window(inp, grid, orders, bounds, ex,
                                  _md_norm(max_disp))
    else:
        out = _nd.grad_core(inp, _flat(grid), orders, bounds, ex)
        out = out.reshape(out.shape[:2] + grid.shape[1:-1] + (D,))
    return _postproc(out, info, "grad")


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
