"""B-spline taps and the dct2 fold, frozen for the reference.

Copied from ``interpol_tpu_torch/ops/splines.py`` (``node_origin``,
``_tap_levels``, ``bspline_taps``) and ``interpol_tpu_torch/ops/bounds.py``
(``fold_index``, its dct2 branch), so that the reference imports nothing
of the program.
"""
from __future__ import annotations

import torch


def node_origin(g: torch.Tensor, order: int):
    """``(n0, t)``: the first support node ``floor(g - (order-1)/2)``
    (int64) and the offset ``t = g - n0``.  Order 0 rounds half to even."""
    if order == 0:
        n0f = torch.round(g)
    else:
        n0f = torch.floor(g - (order - 1) / 2)
    return n0f.to(torch.int64), g - n0f


def bspline_taps(t: torch.Tensor, order: int, grad: bool = False):
    """``(weights, grads)``: lists of the ``order + 1`` taps' weights and,
    with ``grad``, first derivatives (Cox-de Boor recursion); tap ``j``
    multiplies the sample at node ``n0 + j``."""
    p = order
    if p == 0:
        return [torch.ones_like(t)], ([torch.zeros_like(t)] if grad
                                      else None)
    level = [torch.ones_like(t)]
    below = level          # level p - 1, for the derivatives
    for k in range(1, p + 1):
        prev = level
        level = []
        for j in range(k + 1):
            a = t - j + (2 * k + 1 - p) / 2
            b = (p + 1) / 2 + j - t
            if j == 0:
                term = b * prev[0]
            elif j == k:
                term = a * prev[j - 1]
            else:
                term = a * prev[j - 1] + b * prev[j]
            level.append(term / k)
        if k == p - 1:
            below = level
    if not grad:
        return level, None
    zero = torch.zeros_like(t)

    def at(j):
        return below[j] if 0 <= j < len(below) else zero

    # beta_p'(t - j) = A_{j-1}^(p-1) - A_j^(p-1)
    return level, [at(j - 1) - at(j) for j in range(p + 1)]


def fold_dct2(i: torch.Tensor, n: int) -> torch.Tensor:
    """Fold integer indices into ``[0, n)``: period 2n, reflection about
    the voxel edges (dct2)."""
    n2 = 2 * n
    i = torch.where(i < 0, (n2 - 1) - torch.remainder(-i - 1, n2),
                    torch.remainder(i, n2))
    return torch.where(i >= n, (n2 - 1) - i, i)
