"""Work of single operations: ``(bytes, flops)``, float32.

Generalised from ``chip_smoke.py::dense_work`` (kernel 1 and kernel 2 at
cubic order, one channel) to any spline order, channel count and batch.
Bytes count one read of each input and one write of each output, 4 bytes
a value; operations count a fused multiply-add as 2, with the separable
sums of ``chip_smoke.py`` per channel: the value takes ``T^3 + T^2 + T``
FMAs a channel, the gradient ``2 T^3 + 3 T^2 + 3 T``; the push ``2 T^3 +
T^2`` operations a channel, pushgrad ``4 T^3 + 4 T^2``, with ``T^k`` the
product of the first k axes' taps (order + 1).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

F = 4   # bytes of a float32


def _t(orders: Sequence[int]) -> Tuple[int, int, int]:
    taps = [o + 1 for o in orders]
    return (taps[0], taps[0] * taps[1], taps[0] * taps[1] * taps[2])


def warp(mode: str, orders, batch: int, channels: int,
         shape) -> Tuple[float, float]:
    """Kernel 1 (``csrc/warp.cu``) ``value``, ``grad`` or ``value+grad``,
    and kernel 2 (``csrc/push.cu``) ``push`` or ``pushgrad``, on a dense
    grid of ``shape`` (one sample a voxel), ``batch`` x ``channels``
    slices."""
    n = batch * math.prod(shape)
    C = channels
    t1, t2, t3 = _t(orders)
    value = 2 * n * C * (t3 + t2 + t1)
    grad = 2 * n * C * (2 * t3 + 3 * t2 + 3 * t1)
    table = {
        "value": (F * (C * n + 3 * n + C * n), value),
        "grad": (F * (C * n + 3 * n + 3 * C * n), grad),
        "value+grad": (F * (C * n + 3 * n + C * n + 3 * C * n),
                       value + grad),
        "push": (F * (C * n + 3 * n + C * n), n * C * (2 * t3 + t2)),
        "pushgrad": (F * (3 * C * n + 3 * n + C * n),
                     n * C * (4 * t3 + 4 * t2)),
    }
    return table[mode]


def resize(order: int, channels: int, inshape, outshape
           ) -> Tuple[float, float]:
    """The separable resample (``ops/resize.py`` -> ``ops/separable.py``)
    of ``channels`` volumes from ``inshape`` to ``outshape``, or its
    adjoint (the same count): the ``order + 1`` nonzero taps of each
    row of each axis's sampling matrix, axis by axis; the dense matmul's
    zeros are no required work."""
    flops = 0
    cur = list(inshape)
    for d, n_out in enumerate(outshape):
        cur[d] = n_out
        flops += 2 * (order + 1) * channels * math.prod(cur)
    nbytes = F * channels * (math.prod(inshape) + math.prod(outshape))
    return nbytes, flops


def spline_grad_identity(order: int, channels: int, shape
                         ) -> Tuple[float, float]:
    """The spatial gradient of a spline at the voxels (``disp_jacobian``'s
    ``grid_grad`` at the identity grid), or its adjoint: 3 derivatives,
    each 3 separable passes over the taps that are not zero there (3 at
    cubic order, 2 at linear)."""
    n = math.prod(shape)
    nz = {0: 1, 1: 2, 2: 3, 3: 3}.get(order, order)
    flops = 2 * 3 * 3 * nz * channels * n
    return F * (channels * n + 3 * channels * n), flops


def label_pull(order: int, shape) -> Tuple[float, float]:
    """A uint8 label map's warp (``grid_pull(..., classes=)``), as
    required: read the label map and the grid once, write the labels
    once; one channel's taps of weights (the classes share them)."""
    n = math.prod(shape)
    t1, t2, t3 = _t((order,) * 3)
    return n + F * 3 * n + n, 2 * n * (t3 + t2 + t1)


def total(ops) -> Tuple[float, float]:
    """Sum of ``[(name, bytes, flops, source), ...]``."""
    return (sum(o[1] for o in ops), sum(o[2] for o in ops))
