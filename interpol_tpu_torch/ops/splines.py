"""Uniform B-spline tap weights and derivatives, orders 0-7.

PyTorch port of ``interpol_tpu/ops/splines.py:49-161``: the Cox-de Boor
recursion evaluated for all ``order+1`` support taps at once,

    level 0:  A_0 = 1
    level k:  A_j^(k) = [ a_jk * A_{j-1}^(k-1) + b_jk * A_j^(k-1) ] / k
              a_jk = t - j + (2k + 1 - p)/2,   b_jk = (p + 1)/2 + j - t

with first and second derivatives read off levels p-1 and p-2.  The CUDA
kernel (``csrc/warp.cu``) runs the same recursion per voxel in registers.
``bspline_weight`` / ``bspline_grad`` / ``bspline_hess`` evaluate the basis
function itself at any positions (``splines.py:164-200``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["node_origin", "bspline_taps", "bspline_weight", "bspline_grad",
           "bspline_hess"]


def node_origin(g: torch.Tensor, order: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """First support node and fractional offset for sample positions ``g``.

    Returns ``(n0, t)`` with ``n0 = floor(g - (order-1)/2)`` (int64) and
    ``t = g - n0``.  Order 0 rounds half to even (``torch.round``), as the
    JAX package does.
    """
    if order == 0:
        n0f = torch.round(g)
    else:
        n0f = torch.floor(g - (order - 1) / 2)
    t = g - n0f
    return n0f.to(torch.int64), t


def _tap_levels(t: torch.Tensor, order: int,
                upto: int) -> Dict[int, List[torch.Tensor]]:
    """Run the tap recursion up from level 0, returning levels
    ``upto..order`` (level ``k`` holds ``k+1`` tensors)."""
    p = order
    level = [torch.ones_like(t)]
    kept = {0: level}
    for k in range(1, p + 1):
        prev = level
        level = []
        for j in range(k + 1):
            left = prev[j - 1] if j >= 1 else None
            right = prev[j] if j <= k - 1 else None
            a = t - j + (2 * k + 1 - p) / 2
            b = (p + 1) / 2 + j - t
            if left is None:
                term = b * right
            elif right is None:
                term = a * left
            else:
                term = a * left + b * right
            level.append(term / k)
        if k >= upto:
            kept[k] = level
    return kept


def bspline_taps(t: torch.Tensor, order: int,
                 grad: bool = False, hess: bool = False):
    """Weights (and optionally 1st/2nd derivatives) of all ``order+1`` taps.

    Returns ``(weights, grads, hesss)``: lists of ``order+1`` tensors shaped
    like ``t`` (``grads`` / ``hesss`` are None when not requested).  Tap
    ``j`` multiplies the sample at node ``n0 + j``.
    """
    p = order
    if p == 0:
        w = [torch.ones_like(t)]
        g = [torch.zeros_like(t)] if grad else None
        h = [torch.zeros_like(t)] if hess else None
        return w, g, h

    lowest = p
    if grad:
        lowest = p - 1
    if hess:
        lowest = min(lowest, max(p - 2, 0))
    levels = _tap_levels(t, p, lowest)
    weights = levels[p]
    zero = torch.zeros_like(t)

    grads = None
    if grad:
        lv = levels[p - 1]

        def at(j):
            return lv[j] if 0 <= j < len(lv) else zero

        # beta_p'(t - j) = A_{j-1}^(p-1) - A_j^(p-1)
        grads = [at(j - 1) - at(j) for j in range(p + 1)]

    hesss = None
    if hess:
        if p == 1:
            hesss = [zero, zero]
        else:
            lv2 = levels[p - 2]

            def at2(j):
                return lv2[j] if 0 <= j < len(lv2) else zero

            # beta_p''(t - j) = A_{j-2} - 2 A_{j-1} + A_j   (level p-2)
            hesss = [at2(j - 2) - 2 * at2(j - 1) + at2(j)
                     for j in range(p + 1)]

    return weights, grads, hesss


def _pointwise(x: torch.Tensor, order: int, which: str) -> torch.Tensor:
    """beta_p (or a derivative) at positions ``x``: with ``n0 = floor(x -
    (p-1)/2)`` the tap at node 0 (``j = -n0``) is the value; a position
    outside the support selects no tap and gives 0."""
    n0, t = node_origin(x, order)
    w, g, h = bspline_taps(t, order, grad=(which == "grad"),
                           hess=(which == "hess"))
    taps = {"weight": w, "grad": g, "hess": h}[which]
    out = torch.zeros_like(t)
    for j, tap in enumerate(taps):
        out = out + torch.where(n0 == -j, tap, 0)
    return out


def bspline_weight(x, order: int) -> torch.Tensor:
    """``beta_order(x)``, the centred uniform B-spline basis function."""
    return _pointwise(torch.as_tensor(x), order, "weight")


def bspline_grad(x, order: int) -> torch.Tensor:
    """First derivative ``beta_order'(x)`` (0 at order 0)."""
    if order == 0:
        return torch.zeros_like(torch.as_tensor(x))
    return _pointwise(torch.as_tensor(x), order, "grad")


def bspline_hess(x, order: int) -> torch.Tensor:
    """Second derivative ``beta_order''(x)`` (0 at orders 0 and 1)."""
    if order in (0, 1):
        return torch.zeros_like(torch.as_tensor(x))
    return _pointwise(torch.as_tensor(x), order, "hess")
