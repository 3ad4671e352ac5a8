"""Diffeomorphic registration: the stationary-velocity-field (SVF) model.

PyTorch port of ``interpol_tpu/models/svf.py``.  The model learns a coarse
velocity field, upsamples it (tanh clamp at the coarse nodes, separable
spline ``resize``) and warps by its group exponential
(scaling-and-squaring, ``ops/flow.py::exp_disp``).  Every pull, the
``steps`` squarings and the final image warp, declares ``max_disp`` and so
runs the dense-warp path: on a CUDA tensor, the CUDA kernels.  Training
differentiates through the squarings, whose backward needs the image
cotangent of each pull (the push kernel), and, with ``jac_weight > 0``,
through ``jacobian_det`` (the pushgrad kernel).

As for ``WarpModel``, the JAX config fields are constructor arguments and
the parameters an ``nn.Parameter``: ``SVFModel(**jax_model._asdict(),
device=...)`` followed by ``load_jax_params(params)`` computes what the
JAX model computes.  The model lives on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.api import add_identity_grid, grid_pull
from ..ops.flow import exp_disp, jacobian_det
from ..ops.resize import resize
from .warp import params_from_jax

__all__ = ["SVFModel", "svf_mse_loss", "svf_train_step"]


class SVFModel(nn.Module):
    """Diffeomorphic registration with ``(B, *coarse_shape, D)`` velocity
    control points.

    Config fields as the JAX model: ``vol_shape``, ``coarse_shape``,
    ``interpolation`` (spline order of the upsampling and the final warp;
    the exponential is linear), ``bound``, ``max_disp`` (per-axis velocity
    budget, which bounds every stage's displacement too) and ``steps``
    (scaling-and-squaring doublings).
    """

    def __init__(self, vol_shape: Tuple[int, ...],
                 coarse_shape: Tuple[int, ...], interpolation: int = 3,
                 bound: str = "dct2", max_disp: float = 4.0,
                 steps: int = 6, *, batch: int = 1, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.vol_shape = tuple(int(s) for s in vol_shape)
        self.coarse_shape = tuple(int(s) for s in coarse_shape)
        self.interpolation = interpolation
        self.bound = bound
        self.max_disp = max_disp
        self.steps = steps
        D = len(self.vol_shape)
        # zero velocity control points, as the JAX init_params
        self.params = nn.Parameter(torch.zeros(
            (batch,) + self.coarse_shape + (D,), dtype=dtype,
            device=device))

    def load_jax_params(self, params: np.ndarray) -> None:
        """Replace the control points with a JAX ``(B, *coarse, D)``
        array."""
        self.params = nn.Parameter(params_from_jax(
            params, device=self.params.device, dtype=self.params.dtype))

    def velocity(self, params: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Dense velocity (B, *vol_shape, D): clamped per-axis to
        ``max_disp`` at the coarse nodes, then upsampled."""
        params = self.params if params is None else params
        D = len(self.vol_shape)
        vel = torch.movedim(params, -1, 1)      # (B, D, *coarse)
        scale = [v / c for v, c in zip(self.vol_shape, self.coarse_shape)]
        sc = torch.as_tensor(scale, dtype=vel.dtype,
                             device=vel.device).reshape((1, D) + (1,) * D)
        vel = self.max_disp * torch.tanh(vel * sc / self.max_disp)
        vel = resize(vel, shape=list(self.vol_shape), anchor=["e"] * D,
                     interpolation=self.interpolation, bound=self.bound,
                     prefilter=False)
        return torch.movedim(vel, 1, -1)

    def flow(self, params: Optional[torch.Tensor] = None,
             inverse: bool = False) -> torch.Tensor:
        """Time-1 displacement exp(v), or exp(-v), its inverse:
        (B, *vol_shape, D)."""
        vel = self.velocity(params)
        return exp_disp(-vel if inverse else vel, steps=self.steps,
                        interpolation=1, bound=self.bound,
                        max_disp=self.max_disp)

    def warp(self, moving: torch.Tensor,
             params: Optional[torch.Tensor] = None,
             inverse: bool = False) -> torch.Tensor:
        """Warp ``moving`` (B, C, *vol_shape) by the diffeomorphism."""
        grid = add_identity_grid(self.flow(params, inverse=inverse))
        return grid_pull(moving, grid, interpolation=self.interpolation,
                         bound=self.bound, extrapolate=True,
                         max_disp=self.max_disp)

    def log_jacobian(self, params: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """log |J| of the forward warp, (B, *vol_shape)."""
        return torch.log(jacobian_det(self.flow(params)))

    def forward(self, moving: torch.Tensor) -> torch.Tensor:
        return self.warp(moving)


def svf_mse_loss(model: SVFModel, moving: torch.Tensor,
                 fixed: torch.Tensor, jac_weight: float = 0.0,
                 params: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE image term, plus ``jac_weight`` x mean log|J|^2 when it is not
    0.  Evaluates the flow twice (once in ``warp``, once in
    ``log_jacobian``), as the JAX loss does."""
    loss = torch.mean((model.warp(moving, params) - fixed) ** 2)
    if jac_weight:
        loss = loss + jac_weight * torch.mean(
            model.log_jacobian(params) ** 2)
    return loss


def svf_train_step(model: SVFModel, moving: torch.Tensor,
                   fixed: torch.Tensor, lr: float = 0.1,
                   jac_weight: float = 0.0) -> torch.Tensor:
    """One SGD step on :func:`svf_mse_loss`; returns the loss before the
    step.  The counterpart of the JAX ``svf_train_step``, which returns
    ``(params - lr * g, loss)``: here the parameters are updated in place,
    under ``torch.no_grad()``."""
    loss = svf_mse_loss(model, moving, fixed, jac_weight)
    (g,) = torch.autograd.grad(loss, [model.params])
    with torch.no_grad():
        model.params -= lr * g
    return loss.detach()
