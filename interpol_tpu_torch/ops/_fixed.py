"""Host half of the order-independent fixed-point splat
(``csrc/fixed_splat.cuh``), shared by the dense-warp push
(``cuda_warp.push_cuda``) and the scattered splat
(``cuda_scattered.splat_cuda``): the ``SplatGeom`` kernel parameter and
the zeroed workspace.  ``tests/test_torch_fixed_splat.py`` holds a plain
emulation of the kernels' arithmetic.

A splat rounds every tap to an int64 at the scale ``2^k`` of its slice
(b, c), with ``k = 62 - ceil(log2 S)`` and ``S = mass * sum |vals|`` over
the items of the slice that the splat keeps (a scattered point inside the
extrapolation mask, a dense site that also passes the window test), so
that every partial sum stays below ``2^63``; the integer sums are exact
and do not depend on their order.  ``mass`` bounds one item's tap mass: 1
for push, 2 for pushgrad, 4 for pushhess (the header derives them).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["SplatGeom", "CHUNKS", "workspace"]

# scale partial sums per slice (kChunks in csrc/fixed_splat.cuh)
CHUNKS = 128


class SplatGeom(ctypes.Structure):
    """Mirror of ``struct SplatGeom`` in ``csrc/fixed_splat.cuh``."""
    _fields_ = [
        ("T", ctypes.c_int * 3),
        ("lo", ctypes.c_int * 3),
        ("E", ctypes.c_int * 3),
        ("NB", ctypes.c_int * 3),
    ]


def workspace(S: int, V: int, B: int, items: int, device) -> torch.Tensor:
    """The zeroed int64 workspace of a splat of S slices of V voxels whose
    B batches hold ``items`` items each: the accumulator (S * V), the
    scale's partial sums (S * CHUNKS float64), three uint32 per slice
    (chunk count, non-finite flag, k) and, where they do not fit the
    output (S * V float32, which holds them until it is written), the
    items' keep bits (a uint32 per 32 items of a batch)."""
    words = B * -(-items // 32)
    tail = words if words > S * V else 0
    return torch.zeros(S * V + S * CHUNKS + (3 * S + tail + 1) // 2,
                       dtype=torch.int64, device=device)
