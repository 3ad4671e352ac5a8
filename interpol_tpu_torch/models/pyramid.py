"""Coarse-to-fine multiresolution registration driver.

PyTorch port of ``interpol_tpu/models/pyramid.py``, the way the library is
used in production: restrict both volumes into a pyramid, register at the
coarsest level, where the basin of attraction is widest, then carry the
estimate down and refine at each finer level.

  * ``restrict`` builds the image pyramids (successive ~2x restrictions on
    the separable route);
  * each level is a :class:`~interpol_tpu_torch.models.warp.WarpModel`
    over that level's volume shape, so every level runs the dense-warp
    kernels (in adaptive mode with ``tile_spread``) and their hand-wired
    adjoints;
  * :func:`run_level` runs a level's SGD steps, a Python loop where the
    JAX package has one ``lax.scan``, with the same arithmetic.

**Why parameters transfer between levels unchanged.**  The control grid
(``coarse_shape``) is fixed across levels while the volume shape halves.
``WarpModel.dense_flow`` upsamples the control values and multiplies by
the per-axis scale ``vol/coarse``, so a parameter value displaces by the
same fraction of the volume at every level.  Prolongation is the
identity; only the displacement clamp (``max_disp``, in that level's
voxels) is rescaled per level.

Typical use::

    model = PyramidModel(vol_shape=(128, 128, 128), coarse_shape=(8, 8, 8),
                         levels=3, steps_per_level=30, interpolation=3)
    params, losses = register(model, moving, fixed, lr=1.0)
    warped = model.finest().warp(moving, params)

The models live on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops.resize import restrict
from .warp import WarpModel, mse_loss

__all__ = ["PyramidModel", "register", "run_level", "image_pyramid"]


class PyramidModel:
    """Static configuration of the coarse-to-fine registration driver.

    Fields as the JAX model: ``vol_shape`` (the finest shape),
    ``coarse_shape`` (the control grid, fixed across levels), ``levels``,
    ``interpolation``, ``bound``, ``max_disp`` (in finest-level voxels;
    level l, 0 the coarsest, gets ``max_disp / 2**(levels-1-l)``),
    ``steps_per_level``, ``tile_spread`` (forwarded to every level's
    ``WarpModel``, ``"auto"`` included) and ``coarse_clamp``; and the
    ``device`` and ``dtype`` of the level models."""

    def __init__(self, vol_shape: Tuple[int, ...],
                 coarse_shape: Tuple[int, ...], levels: int = 3,
                 interpolation: int = 3, bound: str = "dct2",
                 max_disp: float = 4.0, steps_per_level: int = 20,
                 tile_spread=None, coarse_clamp: bool = False, *,
                 device="cuda", dtype=torch.float32):
        self.vol_shape = tuple(int(s) for s in vol_shape)
        self.coarse_shape = tuple(int(s) for s in coarse_shape)
        self.levels = levels
        self.interpolation = interpolation
        self.bound = bound
        self.max_disp = max_disp
        self.steps_per_level = steps_per_level
        self.tile_spread = tile_spread
        self.coarse_clamp = coarse_clamp
        self.device = device
        self.dtype = dtype

    def level_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """Spatial shapes coarse -> fine: ceil-halved per level, floored
        at the spline support so the coarsest level stays resolvable."""
        floor = self.interpolation + 1
        shapes = [self.vol_shape]
        for _ in range(self.levels - 1):
            shapes.append(tuple(max(floor, math.ceil(n / 2))
                                for n in shapes[-1]))
        return tuple(reversed(shapes))

    def level_model(self, level: int) -> WarpModel:
        """The WarpModel of pyramid level ``level`` (0 = coarsest)."""
        scale = 2.0 ** (self.levels - 1 - level)
        return WarpModel(vol_shape=self.level_shapes()[level],
                         coarse_shape=self.coarse_shape,
                         interpolation=self.interpolation, bound=self.bound,
                         max_disp=self.max_disp / scale,
                         tile_spread=self.tile_spread,
                         coarse_clamp=self.coarse_clamp,
                         device=self.device, dtype=self.dtype)

    def finest(self) -> WarpModel:
        return self.level_model(self.levels - 1)

    def init_params(self, batch: int, dtype=None) -> torch.Tensor:
        """Zero displacement control points: (B, *coarse_shape, D)."""
        D = len(self.vol_shape)
        return torch.zeros((batch,) + self.coarse_shape + (D,),
                           dtype=dtype or self.dtype, device=self.device)


def image_pyramid(model: PyramidModel, image: torch.Tensor):
    """Restrict ``image`` (B, C, *vol_shape) into the model's pyramid,
    returned coarse -> fine, each level built from the previous one.

    Levels are mean-preserving (the raw splat sum scaled by the voxel
    ratio), not ``restrict``'s fullscale normalization: every level keeps
    the intensity scale, so one learning rate serves them all."""
    shapes = model.level_shapes()
    ndim = len(model.vol_shape)
    levels = [torch.as_tensor(image)]
    for shape in reversed(shapes[:-1]):
        prev = levels[-1]
        ratio = math.prod(shape) / math.prod(prev.shape[-ndim:])
        lvl = restrict(prev, shape=list(shape), anchor=["e"] * ndim,
                       interpolation=model.interpolation,
                       bound=model.bound, reduce_sum=True)
        levels.append(lvl * ratio)
    return list(reversed(levels))


def run_level(model: WarpModel, params: torch.Tensor, moving: torch.Tensor,
              fixed: torch.Tensor, steps: int, lr: float = 1.0):
    """``steps`` SGD steps on one pyramid level: ``p <- p - lr * g`` with
    ``g`` the gradient of :func:`mse_loss` in the control points.  Returns
    the updated params and the (steps,) loss trace.  The caller's
    ``params`` is read, never updated."""
    p = params.detach()
    losses = []
    for _ in range(steps):
        p = p.requires_grad_()
        loss = mse_loss(model, moving, fixed, params=p)
        (g,) = torch.autograd.grad(loss, [p])
        p = (p - lr * g).detach()
        losses.append(loss.detach())
    return p, torch.stack(losses)


def register(model: PyramidModel, moving: torch.Tensor,
             fixed: torch.Tensor, lr: float = 1.0,
             params: Optional[torch.Tensor] = None):
    """Coarse-to-fine registration of ``moving`` onto ``fixed`` (both (B,
    C, *vol_shape)).  Returns ``(params, losses)``, ``losses`` the
    (levels, steps_per_level) loss trace, coarse level first.  ``params``
    warm-starts the estimate (its values are level-invariant) and is left
    as it is."""
    moving = torch.as_tensor(moving)
    fixed = torch.as_tensor(fixed)
    mov_pyr = image_pyramid(model, moving)
    fix_pyr = image_pyramid(model, fixed)
    if params is None:
        params = model.init_params(moving.shape[0], dtype=mov_pyr[0].dtype)
    traces = []
    for level in range(model.levels):
        params, trace = run_level(model.level_model(level), params,
                                  mov_pyr[level], fix_pyr[level],
                                  model.steps_per_level, lr)
        traces.append(trace)
    return params, torch.stack(traces)
