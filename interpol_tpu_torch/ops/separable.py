"""Separable spline sampling along outer-product grids as per-axis dense
matrix contractions.

PyTorch port of ``interpol_tpu/ops/separable.py:38-92``.  ``resize`` grids
are an outer product of D 1-D affine sample lines, so each axis is
resampled with one (out_n x in_n) sampling matrix applied by
``torch.tensordot`` (a plain matmul, as the JAX package leaves it to XLA).
``separable_push`` (the adjoint, for ``restrict``) is not ported yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .bounds import fold_index, fold_sign
from .splines import bspline_taps, node_origin

__all__ = ["sampling_matrix", "separable_pull"]


def sampling_matrix(line: torch.Tensor, n_in: int, order: int, bound: int,
                    extrapolate: int = 1, deriv: int = 0) -> torch.Tensor:
    """Dense 1-D spline sampling matrix S (len(line) x n_in).

    ``(S @ v)[o] == pull(v, line[o])`` for a 1-D signal v with the given
    order/bound/extrapolate semantics; ``deriv`` in {0, 1, 2} selects the
    weight / first- / second-derivative factors.
    """
    line = torch.as_tensor(line)
    dtype = line.dtype
    n0, t = node_origin(line, order)
    w, g, h = bspline_taps(t, order, grad=(deriv == 1), hess=(deriv == 2))
    taps = {0: w, 1: g, 2: h}[deriv]

    cols = torch.arange(n_in, device=line.device)
    S = torch.zeros((line.shape[0], n_in), dtype=dtype, device=line.device)
    for j in range(order + 1):
        node = n0 + j
        idx = fold_index(node, n_in, bound)
        weight = taps[j]
        sign = fold_sign(node, n_in, bound, dtype)
        if sign is not None:
            weight = weight * sign
        # scatter-add the tap into its folded column (dense, tiny)
        S = S + torch.where(cols[None, :] == idx[:, None],
                            weight[:, None], 0)
    if extrapolate != 1:
        thr = 0.05 if extrapolate == 0 else 0.55
        inb = torch.logical_and(line > -thr, line < (n_in - 1) + thr)
        S = S * inb[:, None].to(dtype)
    return S


def separable_pull(inp: torch.Tensor, lines: Sequence[torch.Tensor],
                   orders: Tuple[int, ...], bounds: Tuple[int, ...],
                   extrapolate: int = 1) -> torch.Tensor:
    """Sample ``inp (..., *ishape)`` on the outer-product grid of
    ``lines`` via per-axis matmuls.  Equivalent to grid_pull on
    ``stack(meshgrid(*lines), -1)``."""
    D = len(lines)
    ishape = inp.shape[-D:]
    out = inp
    for d, (line, n, o, b) in enumerate(zip(lines, ishape, orders, bounds)):
        S = sampling_matrix(line, n, o, b, extrapolate)
        axis = out.ndim - D + d
        out = torch.movedim(
            torch.tensordot(S.to(out.dtype), out, dims=([1], [axis])),
            0, axis)
    return out
