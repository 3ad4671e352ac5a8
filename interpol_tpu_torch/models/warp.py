"""Flagship model: dense-displacement image registration.

PyTorch port of ``interpol_tpu/models/warp.py``.  Coarse
displacement control points are upsampled to a dense flow by a separable
spline ``resize``, clamped with a tanh to the displacement budget, turned
into a sampling grid, and the moving volume is warped by ``grid_pull(...,
max_disp=, tile_spread=)`` — on a CUDA tensor, the dense-warp CUDA kernel
(in adaptive mode with ``tile_spread``).

The JAX model is a ``NamedTuple`` config plus a ``(B, *coarse, D)``
parameter array; here the config fields are constructor arguments and the
parameters an ``nn.Parameter``.  ``WarpModel(**jax_model._asdict(),
device=...)`` followed by ``load_jax_params(params)`` computes what the JAX
model computes.  :func:`train_step` is one SGD step on :func:`mse_loss`;
its backward runs the hand-wired adjoints of ``ops/window.py`` (on CUDA,
the gradient kernel for the grid cotangent; no push, since the moving
image needs no gradient).  The model lives on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.api import add_identity_grid, grid_pull
from ..ops.resize import resize

__all__ = ["WarpModel", "mse_loss", "train_step", "params_from_jax"]


def params_from_jax(params: np.ndarray, *, device="cuda",
                    dtype=torch.float32) -> torch.Tensor:
    """JAX ``(B, *coarse, D)`` control points -> torch tensor (same
    layout)."""
    return torch.as_tensor(np.asarray(params), dtype=dtype, device=device)


class WarpModel(nn.Module):
    """Registration warp with ``(B, *coarse_shape, D)`` control points.

    Config fields as the JAX model: ``vol_shape``, ``coarse_shape``,
    ``interpolation`` (spline order of the warp and the upsampling),
    ``bound``, ``max_disp`` (displacement clamp, and the dense-warp path's
    window bound), ``tile_spread`` (the adaptive per-tile windows of the
    warp, forwarded to ``grid_pull``: a per-axis bound on the residual
    displacement over each (8, 8, 128) kernel tile, or ``"auto"``, which
    moves the clamp to the coarse nodes and derives a bound that such
    flows honour, :meth:`auto_tile_spread`) and ``coarse_clamp``.
    """

    def __init__(self, vol_shape: Tuple[int, ...],
                 coarse_shape: Tuple[int, ...], interpolation: int = 3,
                 bound: str = "dct2", max_disp: float = 4.0,
                 tile_spread=None, coarse_clamp: bool = False, *,
                 batch: int = 1, device="cuda", dtype=torch.float32):
        super().__init__()
        if isinstance(tile_spread, str) and tile_spread != "auto":
            raise ValueError(f"tile_spread={tile_spread!r}")
        self.vol_shape = tuple(int(s) for s in vol_shape)
        self.coarse_shape = tuple(int(s) for s in coarse_shape)
        self.interpolation = interpolation
        self.bound = bound
        self.max_disp = max_disp
        self.tile_spread = tile_spread
        self.coarse_clamp = coarse_clamp
        D = len(self.vol_shape)
        # zero displacement control points, as the JAX init_params
        self.params = nn.Parameter(torch.zeros(
            (batch,) + self.coarse_shape + (D,), dtype=dtype,
            device=device))

    def load_jax_params(self, params: np.ndarray) -> None:
        """Replace the control points with a JAX ``(B, *coarse, D)``
        array."""
        self.params = nn.Parameter(params_from_jax(
            params, device=self.params.device, dtype=self.params.dtype))

    def auto_tile_spread(self, tile=(8, 8, 128)):
        """Geometry-derived per-axis residual-spread bound of auto-mode
        flows: min(max_disp, max_disp * G * (tile_d/2) / scale_d + 0.5)
        with the B-spline derivative-sum bound G <= 2."""
        D = len(self.vol_shape)
        scale = [v / c for v, c in zip(self.vol_shape, self.coarse_shape)]
        tile = tuple(tile)[-D:]
        M, G = float(self.max_disp), 2.0
        return tuple(min(M, M * G * (t / 2) / s + 0.5)
                     for t, s in zip(tile, scale))

    def _spread(self):
        if isinstance(self.tile_spread, str):
            return self.auto_tile_spread()
        return self.tile_spread

    def dense_flow(self, params: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Upsample coarse displacement control points to a dense sampling
        grid: (B, *coarse, D) -> (B, *vol_shape, D)."""
        params = self.params if params is None else params
        D = len(self.vol_shape)
        disp = torch.movedim(params, -1, 1)   # (B, D, *coarse)
        scale = [v / c for v, c in zip(self.vol_shape, self.coarse_shape)]
        sc = torch.as_tensor(scale, dtype=disp.dtype,
                             device=disp.device).reshape((1, D) + (1,) * D)
        up = dict(shape=list(self.vol_shape), anchor=["e"] * D,
                  interpolation=self.interpolation, bound=self.bound,
                  prefilter=False)
        if self.tile_spread == "auto" or self.coarse_clamp:
            # clamp at the coarse nodes
            disp = self.max_disp * torch.tanh(disp * sc / self.max_disp)
            disp = resize(disp, **up)
        else:
            # displacements are in coarse-voxel units; rescale per axis
            # and clamp smoothly to the displacement budget
            disp = resize(disp, **up) * sc
            disp = self.max_disp * torch.tanh(disp / self.max_disp)
        return add_identity_grid(torch.movedim(disp, 1, -1))

    def warp(self, moving: torch.Tensor,
             params: Optional[torch.Tensor] = None,
             check_spread: bool = False) -> torch.Tensor:
        """Warp ``moving`` (B, C, *vol_shape) by the model's deformation."""
        flow = self.dense_flow(params)
        return grid_pull(moving, flow, interpolation=self.interpolation,
                         bound=self.bound, extrapolate=True,
                         max_disp=self.max_disp,
                         tile_spread=self._spread(),
                         check_spread=check_spread)

    def forward(self, moving: torch.Tensor) -> torch.Tensor:
        return self.warp(moving)


def mse_loss(model: WarpModel, moving: torch.Tensor, fixed: torch.Tensor,
             params: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error between the warped moving image and ``fixed``."""
    warped = model.warp(moving, params)
    return torch.mean((warped - fixed) ** 2)


def train_step(model: WarpModel, moving: torch.Tensor, fixed: torch.Tensor,
               lr: float = 0.1) -> torch.Tensor:
    """One SGD step on :func:`mse_loss`; returns the loss before the step.

    The counterpart of the JAX ``train_step``, which returns ``(params -
    lr * g, loss)``: here the parameters are updated in place, under
    ``torch.no_grad()``."""
    loss = mse_loss(model, moving, fixed)
    (g,) = torch.autograd.grad(loss, [model.params])
    with torch.no_grad():
        model.params -= lr * g
    return loss.detach()
