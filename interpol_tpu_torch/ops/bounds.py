"""Boundary folding: map out-of-range integer indices into ``[0, n)`` plus an
optional sign flip, for the seven boundary conditions.

PyTorch port of ``interpol_tpu/ops/bounds.py`` (same semantics, including
the ``n == 1`` degenerate cases and the dst1 quirk: sign 0 at the in-bounds
index 0).  Every helper accepts a torch integer tensor or a numpy integer
array and answers in the same library, so static index tables (the folded
pad of ``ops/window.py``) can be built with numpy and live tensors folded
with torch.  Floor-mod (``remainder``) is used throughout: C's ``%`` and
``torch.fmod`` truncate toward zero and would mis-fold negative indices.
The CUDA kernel (``csrc/warp.cu``) carries a device copy of the same
arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..options import BoundType

__all__ = ["fold_index", "fold_sign", "has_sign"]


def _xp(i):
    return torch if isinstance(i, torch.Tensor) else np


def _cast(x, dtype):
    return x.to(dtype) if isinstance(x, torch.Tensor) else x.astype(dtype)


def fold_index(i, n: int, bound: int):
    """Fold integer indices ``i`` into ``[0, n)`` for boundary ``bound``."""
    xp = _xp(i)
    bound = int(bound)
    if bound in (BoundType.zero, BoundType.replicate):
        # Clamp; for 'zero' the sign kills out-of-range contributions.
        return xp.clip(i, 0, n - 1)

    if bound in (BoundType.dct2, BoundType.dst2):
        # Period 2n, reflection about voxel edges.
        n2 = 2 * n
        i = xp.where(i < 0, (n2 - 1) - xp.remainder(-i - 1, n2),
                     xp.remainder(i, n2))
        return xp.where(i >= n, (n2 - 1) - i, i)

    if bound == BoundType.dct1:
        # Period 2(n-1), reflection about voxel centers.
        if n == 1:
            return xp.zeros_like(i)
        n2 = 2 * (n - 1)
        i = xp.remainder(xp.abs(i), n2)
        return xp.where(i >= n, n2 - i, i)

    if bound == BoundType.dst1:
        # Period 2(n+1), antisymmetric about the virtual zero samples at
        # -1 and n, which fold onto 0 / n-1 and are zeroed by the sign.
        n2 = 2 * (n + 1)
        i = xp.where(i < 0, -i - 2, i)
        i = xp.remainder(i, n2)
        i = xp.where(i > n, (n2 - 2) - i, i)
        i = xp.where(i == -1, xp.zeros_like(i), i)
        return xp.where(i == n, xp.full_like(i, n - 1), i)

    if bound == BoundType.dft:
        return xp.remainder(i, n)

    raise ValueError(f"Unknown bound: {bound}")


def has_sign(bound: int, n: int) -> bool:
    """Whether this boundary produces a non-trivial sign for axis size n."""
    bound = int(bound)
    if bound == BoundType.dst1:
        return n > 1
    return bound in (BoundType.zero, BoundType.dst2)


def fold_sign(i, n: int, bound: int, dtype=None):
    """Sign (+1 / -1 / 0) carried by index ``i`` under boundary ``bound``,
    or ``None`` for boundaries whose sign is identically +1.  ``dtype``
    defaults to float32 of the input's library."""
    xp = _xp(i)
    if dtype is None:
        dtype = xp.float32
    bound = int(bound)
    if not has_sign(bound, n):
        return None

    if bound == BoundType.zero:
        return _cast(xp.logical_and(i >= 0, i < n), dtype)

    if bound == BoundType.dst2:
        i = xp.where(i < 0, (n - 1) - i, i)
        odd = xp.remainder(i // n, 2) > 0
        return _cast(xp.where(odd, -1, 1), dtype)

    # dst1, n > 1
    n2 = 2 * (n + 1)
    i = xp.where(i < 0, -i + (n - 1), i)
    i = xp.remainder(i, n2)
    x = xp.where(i == 0, 0, 1)
    x = xp.where(xp.remainder(i, n + 1) == n, 0, x)
    odd = xp.remainder(i // (n + 1), 2) > 0
    return _cast(xp.where(odd, -x, x), dtype)
