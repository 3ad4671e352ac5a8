"""Option vocabulary: boundary conditions, spline orders, extrapolation modes.

PyTorch port of ``interpol_tpu/options.py`` (pure Python, identical
vocabulary and numbering).  Options are normalized to plain Python ints /
tuples of ints before they reach any kernel, so the CUDA kernels take
them as launch arguments and the plain torch path as loop bounds.
"""
from __future__ import annotations

from enum import IntEnum
from typing import Sequence, Tuple, Union

__all__ = [
    "BoundType",
    "InterpolationType",
    "ExtrapolateType",
    "to_bound",
    "to_order",
    "to_extrapolate",
    "normalize_options",
]


class BoundType(IntEnum):
    """Boundary conditions, numbered identically to the reference so that
    integer-valued options are interchangeable (interpol/bounds.py:8-15)."""

    zero = 0        # 0  0  0 | a b c d | 0  0  0
    replicate = 1   # a  a  a | a b c d | d  d  d
    dct1 = 2        # d  c  b | a b c d | c  b  a   (mirror)
    dct2 = 3        # c  b  a | a b c d | d  c  b   (reflect)
    dst1 = 4        # -b -a 0 | a b c d | 0 -d -c   (antimirror)
    dst2 = 5        # -c -b -a| a b c d | -d -c -b  (antireflect)
    dft = 6         # b  c  d | a b c d | a  b  c   (wrap)


class InterpolationType(IntEnum):
    """Spline orders (interpol/splines.py:7-15)."""

    nearest = 0
    linear = 1
    quadratic = 2
    cubic = 3
    fourth = 4
    fifth = 5
    sixth = 6
    seventh = 7


class ExtrapolateType(IntEnum):
    """Extrapolation modes (interpol/bounds.py:18-21).

    - ``no``: mask out samples falling outside ``(-0.05, n-1+0.05)``
    - ``yes``: keep all samples (boundary condition handles folding)
    - ``hist``: mask outside ``(-0.55, n-1+0.55)`` (histogram edges)
    """

    no = 0
    yes = 1
    hist = 2


# Alias tables mirror the sets accepted by the reference's normalizers
# (interpol/autograd.py:56-154).
_BOUND_ALIASES = {
    "zero": BoundType.zero,
    "zeros": BoundType.zero,
    "constant": BoundType.zero,
    "replicate": BoundType.replicate,
    "repeat": BoundType.replicate,
    "border": BoundType.replicate,
    "nearest": BoundType.replicate,
    "dct1": BoundType.dct1,
    "mirror": BoundType.dct1,
    "dct2": BoundType.dct2,
    "reflect": BoundType.dct2,
    "reflection": BoundType.dct2,
    "neumann": BoundType.dct2,
    "dst1": BoundType.dst1,
    "antimirror": BoundType.dst1,
    "dst2": BoundType.dst2,
    "antireflect": BoundType.dst2,
    "dirichlet": BoundType.dst2,
    "dft": BoundType.dft,
    "wrap": BoundType.dft,
    "circular": BoundType.dft,
}

_ORDER_ALIASES = {
    "nearest": 0,
    "zeroth": 0,
    "linear": 1,
    "first": 1,
    "quadratic": 2,
    "second": 2,
    "cubic": 3,
    "third": 3,
    "fourth": 4,
    "fifth": 5,
    "sixth": 6,
    "seventh": 7,
}

BoundLike = Union[str, int, BoundType]
OrderLike = Union[str, int, InterpolationType]


def _to_bound_one(b: BoundLike) -> int:
    if isinstance(b, BoundType):
        return int(b)
    if isinstance(b, str):
        key = b.lower()
        if key not in _BOUND_ALIASES:
            raise ValueError(f"Unknown boundary condition: {b!r}")
        return int(_BOUND_ALIASES[key])
    b = int(b)
    if not 0 <= b <= 6:
        raise ValueError(f"Boundary condition out of range [0, 6]: {b}")
    return b


def _to_order_one(o: OrderLike) -> int:
    if isinstance(o, InterpolationType):
        return int(o)
    if isinstance(o, str):
        key = o.lower()
        if key not in _ORDER_ALIASES:
            raise ValueError(f"Unknown interpolation order: {o!r}")
        return _ORDER_ALIASES[key]
    o = int(o)
    if not 0 <= o <= 7:
        raise ValueError(f"Interpolation order out of range [0, 7]: {o}")
    return o


def _pad(values: Tuple[int, ...], ndim: int) -> Tuple[int, ...]:
    """Pad a per-dimension option tuple to length ``ndim`` by repeating the
    last value (semantics of interpol/jit_utils.py:10-15 ``pad_list_int``)."""
    if len(values) >= ndim:
        return values[:ndim]
    return values + (values[-1],) * (ndim - len(values))


def to_bound(bound: Union[BoundLike, Sequence[BoundLike]],
             ndim: int = None) -> Tuple[int, ...]:
    """Normalize bound option(s) to a static tuple of ints."""
    if isinstance(bound, (list, tuple)):
        values = tuple(_to_bound_one(b) for b in bound)
    else:
        values = (_to_bound_one(bound),)
    if not values:
        raise ValueError("Empty bound list")
    if ndim is not None:
        values = _pad(values, ndim)
    return values


def to_order(order: Union[OrderLike, Sequence[OrderLike]],
             ndim: int = None) -> Tuple[int, ...]:
    """Normalize interpolation-order option(s) to a static tuple of ints."""
    if isinstance(order, (list, tuple)):
        values = tuple(_to_order_one(o) for o in order)
    else:
        values = (_to_order_one(order),)
    if not values:
        raise ValueError("Empty interpolation list")
    if ndim is not None:
        values = _pad(values, ndim)
    return values


def to_extrapolate(extrapolate: Union[bool, int, str, ExtrapolateType]) -> int:
    """Normalize the extrapolation flag to a static int in {0, 1, 2}."""
    if isinstance(extrapolate, ExtrapolateType):
        return int(extrapolate)
    if isinstance(extrapolate, str):
        key = extrapolate.lower()
        try:
            return int(ExtrapolateType[key])
        except KeyError:
            raise ValueError(f"Unknown extrapolation mode: {extrapolate!r}")
    if isinstance(extrapolate, bool):
        return int(extrapolate)
    e = int(extrapolate)
    if e not in (0, 1, 2):
        raise ValueError(f"Extrapolation mode out of range {{0,1,2}}: {e}")
    return e


def normalize_options(interpolation, bound, extrapolate, ndim):
    """Normalize the full (interpolation, bound, extrapolate) option triplet
    into static, hashable values for kernel dispatch."""
    return (to_order(interpolation, ndim),
            to_bound(bound, ndim),
            to_extrapolate(extrapolate))
