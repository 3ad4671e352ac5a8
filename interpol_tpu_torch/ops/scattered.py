"""Host side of the scattered tier: the 3-D lift and the splat's box
schedule.

The PyTorch counterpart of the host half of ``interpol_tpu/ops/scattered.py``
(``_lift_2d`` ``:946-962``, ``_schedule`` ``:245-285``).  The kernels
(``csrc/gather.cu``, ``csrc/splat.cu``) are wrapped in
``ops/cuda_scattered.py``; everything here is plain tensor code, so the
CPU tests reach it.

- **Lift.**  The kernels are 3-D.  A 1-D or 2-D cloud gains trailing
  size-1 axes with order 0, bound dct2 and coordinate exactly 0, as
  ``_lift_2d`` does: every point takes the single tap 0 there, weight 1.
- **Box schedule** (the splat).  The output volume is cut into boxes of
  ``T^3`` voxels.  A point whose coordinates lie in ``[0, n-1]`` on every
  axis belongs to the box of ``floor(g)``; the points are sorted by box
  key with one ``torch.sort`` (stable: a box keeps its points in input
  order, so the splat's sums run in a fixed order), and ``searchsorted``
  finds each box's segment.  The points outside ``[0, n-1]`` on some axis
  that the mask keeps are the *outliers*, one segment per batch after all
  boxes; masked points sort last and are never read.  The TPU's box
  ladder, 128-slot rows and overflow round work around Mosaic and are not
  carried over: a box here holds any number of points.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .ndkernels import inbounds_mask

__all__ = ["lift3", "splat_margins", "splat_box", "box_schedule"]


def lift3(grid, oshape, orders, bounds):
    """Lift a (B, P, D) cloud, D < 3, to 3-D: trailing size-1 axes of
    order 0, dct2, coordinate 0.  Returns (grid3, shape3, orders3,
    bounds3); ``grid3`` is a new contiguous tensor."""
    B, P, D = grid.shape
    nd = 3 - D
    grid3 = torch.cat([grid, grid.new_zeros((B, P, nd))], -1).contiguous()
    return (grid3, tuple(oshape) + (1,) * nd, tuple(orders) + (0,) * nd,
            tuple(bounds) + (3,) * nd)


def splat_margins(order: int) -> Tuple[int, int]:
    """Least and largest tap offset from a point's anchor ``floor(g)``.

    Linear taps are ``floor(g) + {0, 1}`` and order 0 takes ``rint(g)``,
    one of them, exactly.  From order 2 the node origin ``floor(g -
    (order-1)/2)`` is ``floor(g) - order//2`` or one above (even orders),
    and the last tap is ``order`` further; one cell more on each side
    absorbs a float32 rounding of ``g - (order-1)/2`` across an integer.
    """
    if order <= 1:
        return 0, 1
    return -(order // 2) - 1, order // 2 + 2


def splat_box(oshape, npoints: int) -> Tuple[int, ...]:
    """Box core per axis: 16 voxels for clouds sparser than a point per 4
    voxels, else 8 (fewer points per warp); never above the axis."""
    side = 16 if 4 * npoints < math.prod(oshape) else 8
    return tuple(min(side, n) for n in oshape)


def box_schedule(grid3, shape3, box, extrapolate):
    """Sort the points of ``grid3`` (B, P, 3) by box.

    Returns ``(keys, perm, seg, nb)``: the sorted keys (int32, B*P), the
    permutation that sorts them, the segment starts ``seg[i]`` = first
    sorted position with key >= i for i in ``0 .. B*tiles + B + 1``
    (boxes ``b*tiles + t``, then the outliers of batch b at ``B*tiles +
    b``, then the masked points), and the boxes per axis.
    """
    B, P, _ = grid3.shape
    nb = tuple(-(-n // t) for n, t in zip(shape3, box))
    ntile = math.prod(nb)
    if B * ntile + B + 2 >= 2**31:
        raise ValueError(f"{B} x {ntile} boxes do not fit int32 keys")
    elig = None
    box_id = None
    for d in range(3):
        g = grid3[..., d]
        inside = (g >= 0) & (g <= shape3[d] - 1)
        elig = inside if elig is None else elig & inside
        cell = torch.floor(g).clamp(0, shape3[d] - 1).to(torch.int64)
        k = torch.div(cell, box[d], rounding_mode="floor")
        box_id = k if box_id is None else box_id * nb[d] + k
    bidx = torch.arange(B, device=grid3.device)[:, None]
    keys = torch.where(elig, bidx * ntile + box_id, B * ntile + bidx)
    mask = inbounds_mask(grid3, shape3, extrapolate, torch.bool)
    if mask is not None:
        keys = torch.where(elig | mask, keys, B * ntile + B)
    # int32 keys: half the radix passes of int64
    keys, perm = torch.sort(keys.reshape(-1).to(torch.int32), stable=True)
    seg = torch.searchsorted(
        keys, torch.arange(B * ntile + B + 2, dtype=torch.int32,
                           device=grid3.device))
    return keys, perm, seg, nb
