"""Dense deformation-field algebra: compose, exponentiate, invert,
differentiate.

PyTorch port of ``interpol_tpu/ops/flow.py``.  Every function is built
from ``grid_pull`` / ``grid_grad``, so it is differentiable through the
hand-wired adjoints of ``ops/window.py`` whenever a displacement bound
``max_disp`` is declared (the dense-warp path: the CUDA kernels for CUDA
tensors).

A *displacement field* ``u`` has shape ``(..., *spatial, D)`` in voxel
units (a sampling grid minus the identity): the warp it encodes is
``phi(x) = x + u(x)``.  The JAX package's ``lax.fori_loop``s are Python
loops here.
"""
from __future__ import annotations

from typing import Optional

import torch

from .api import add_identity_grid, grid_grad, grid_pull, identity_grid

__all__ = ["compose_disp", "exp_disp", "disp_jacobian", "jacobian_det",
           "invert_disp"]


def _as_image(u):
    """(..., *sp, D) displacement -> (..., D, *sp) channel-first image."""
    D = u.shape[-1]
    return torch.movedim(u, -1, -(D + 1))


def _as_field(img, D):
    """(..., D, *sp) image -> (..., *sp, D) displacement."""
    return torch.movedim(img, -(D + 1), -1)


def compose_disp(u, v, interpolation="linear", bound="dct2",
                 extrapolate=True, max_disp: Optional[float] = None):
    """Compose two displacement fields: ``w(x) = u(x + v(x)) + v(x)``.

    ``u``, ``v``: (..., *spatial, D).  ``max_disp``: optional per-axis
    bound on **v** (the sampling displacement), which selects the
    dense-warp path for the pull of ``u``'s channels.
    """
    D = u.shape[-1]
    pulled = grid_pull(_as_image(u), add_identity_grid(v),
                       interpolation=interpolation, bound=bound,
                       extrapolate=extrapolate, max_disp=max_disp)
    return _as_field(pulled, D) + v


def exp_disp(vel, steps: int = 6, interpolation="linear", bound="dct2",
             extrapolate=True, max_disp: Optional[float] = None):
    """Exponentiate a stationary velocity field into a diffeomorphic
    displacement by scaling and squaring: ``u_0 = vel / 2**steps``,
    ``u_{k+1} = u_k o u_k``; returns ``u_steps``.  ``max_disp``: per-axis
    bound on ``|vel|``, which every stage's displacement obeys too."""
    u = vel * (2.0 ** -steps)
    for _ in range(steps):
        u = compose_disp(u, u, interpolation=interpolation, bound=bound,
                         extrapolate=extrapolate, max_disp=max_disp)
    return u


def disp_jacobian(u, interpolation="cubic", bound="dct2"):
    """Spatial Jacobian of the warp ``phi = id + u``: (..., *sp, D, D) with
    ``J[..., i, j] = delta_ij + d u_i / d x_j``, by spline differentiation
    (``grid_grad`` of the displacement channels at the identity grid,
    ``max_disp=0``)."""
    D = u.shape[-1]
    sp = tuple(u.shape[-(D + 1):-1])
    ident = identity_grid(sp, dtype=u.dtype, device=u.device).expand(
        tuple(u.shape[:-(D + 1)]) + sp + (D,))
    g = grid_grad(_as_image(u), ident, interpolation=interpolation,
                  bound=bound, extrapolate=True, max_disp=0.0)
    # (..., D, *sp, D): component i leading, derivative j last
    J = torch.movedim(g, -(D + 2), -2)
    return J + torch.eye(D, dtype=u.dtype, device=u.device)


def jacobian_det(u, interpolation="cubic", bound="dct2"):
    """Determinant of :func:`disp_jacobian`, the local volume change of
    the warp: (..., *spatial).  Closed form for D in (1, 2, 3)."""
    J = disp_jacobian(u, interpolation=interpolation, bound=bound)
    D = u.shape[-1]
    if D == 1:
        return J[..., 0, 0]
    if D == 2:
        return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    if D == 3:
        c0 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
        c1 = J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0]
        c2 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
        return J[..., 0, 0] * c0 - J[..., 0, 1] * c1 + J[..., 0, 2] * c2
    return torch.linalg.det(J)


def invert_disp(u, iters: int = 20, interpolation="linear", bound="dct2",
                extrapolate=True, max_disp: Optional[float] = None):
    """Inverse displacement by fixed-point iteration, ``w(x) = -u(x +
    w(x))`` from ``w = -u``.  Converges when ``sup |grad u| < 1``.
    ``max_disp``: per-axis bound on ``|u|`` (the inverse obeys it too)."""
    D = u.shape[-1]
    ui = _as_image(u)
    w = -u
    for _ in range(iters):
        pulled = grid_pull(ui, add_identity_grid(w),
                           interpolation=interpolation, bound=bound,
                           extrapolate=extrapolate, max_disp=max_disp)
        w = -_as_field(pulled, D)
    return w
