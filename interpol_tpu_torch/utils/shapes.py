"""Shape utilities: list coercion and broadcast-shape computation.

PyTorch port of ``interpol_tpu/utils/shapes.py`` (pure Python).
"""
from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["make_list", "expanded_shape"]


def make_list(x, n: int = None, default=None):
    """Coerce to list; optionally right-pad to length ``n`` with the last
    element (or ``default``)  (interpol/utils.py:11-33)."""
    if x is None:
        x = []
    if not isinstance(x, (list, tuple)):
        x = [x]
    x = list(x)
    if n and len(x) < n:
        fill = default if default is not None else (x[-1] if x else None)
        x = x + [fill] * (n - len(x))
    return x


def expanded_shape(*shapes: Sequence[int]) -> Tuple[int, ...]:
    """Broadcast shapes (numpy rules, left-padded with 1s)
    (interpol/utils.py:36-78)."""
    ndim = max((len(s) for s in shapes), default=0)
    out = [1] * ndim
    for shape in shapes:
        shape = (1,) * (ndim - len(shape)) + tuple(shape)
        for i, (a, b) in enumerate(zip(out, shape)):
            if a == 1:
                out[i] = b
            elif b != 1 and a != b:
                raise ValueError(
                    f"Incompatible shapes for broadcasting: {shapes}")
    return tuple(out)
