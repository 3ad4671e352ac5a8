"""Interpolating B-spline coefficients (the IIR prefilter).

PyTorch port of ``interpol_tpu/ops/coeff.py``: the exact interpolating
coefficients c such that sampling the spline built on c at the integer
nodes gives back the input, by the Unser/Thevenaz cascade of causal and
anticausal first-order recursions per pole, with the closed-form initial
conditions of the dct1 ("mirror"), dct2 ("reflect") and dft ("wrap")
bounds; zero aliases to dct1 and replicate to dct2, and every other bound
raises ``NotImplementedError``, as in the JAX package.

Two ways to run the per-axis cascade, as there:

1. **Matrix path** (axis length n <= ``_MATRIX_MAX``): the cascade is one
   linear operator on a line.  Its (n, n) float64 matrix is built once per
   (n, order, bound) on the host by running the scalar recursion on the
   identity (bounded LRU cache), uploaded once per dtype and device
   (bounded LRU cache), and applied as one matrix product per axis that
   keeps the layout.
2. **Blocked-scan path** (n > ``_MATRIX_MAX``): h[i] = x[i] + p h[i-1] in
   chunks of 128 with a lower-triangular Toeplitz matrix of pole powers
   (exact, since |p|^128 underflows), a carry between chunks and the seed
   element replaced; a Python loop of n / 128 steps.

**Precision.**  The resize-identity contract needs full float32 products
at least (the JAX package pins ``Precision.HIGHEST``).  PyTorch's TF32
switch is process-global, and its two APIs (``allow_tf32`` /
``set_float32_matmul_precision`` and ``fp32_precision``) raise when a
caller mixes them, so toggling it around the call is not safe.  Every
product here runs in float64, which no TF32 switch reaches, and the
result is cast back to the input's dtype.  (On an H100 the float64
tensor-core rate equals the float32 rate, 67 TFLOP/s.)

**Differentiation.**  The filter is linear, so its VJP is its exact
transpose: the transposed matrix on the matrix path; the filter itself
for dct2/dft on the scan path (self-adjoint); for dct1 on the scan path,
autograd through the scan's torch ops at a zero primal (dct1 is not
self-adjoint).  ``_Coeff`` applies the filter or its transpose, and its
backward applies the other through ``_Coeff`` again, so derivatives of
every order are exact.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..options import BoundType

__all__ = ["get_poles", "get_gain", "spline_coeff", "spline_coeff_nd"]

# Chunk of the blocked recurrence: |pole| <= 0.54 at every order, so
# pole^128 ~ 1e-35 and the truncated Toeplitz block is exact.
_CHUNK = 128
# Axis lengths up to this use the precomputed filter matrix (32 MB of
# float64 at n = 2048).
_MATRIX_MAX = 2048
_WORK = torch.float64


def get_poles(order: int) -> Tuple[float, ...]:
    """Poles of the direct B-spline filter for each order (Unser 1993 II,
    Table 1)."""
    if order in (0, 1):
        return ()
    if order == 2:
        return (math.sqrt(8.) - 3.,)
    if order == 3:
        return (math.sqrt(3.) - 2.,)
    if order == 4:
        return (
            math.sqrt(664. - math.sqrt(438976.)) + math.sqrt(304.) - 19.,
            math.sqrt(664. + math.sqrt(438976.)) - math.sqrt(304.) - 19.,
        )
    if order == 5:
        return (
            math.sqrt(67.5 - math.sqrt(4436.25)) + math.sqrt(26.25) - 6.5,
            math.sqrt(67.5 + math.sqrt(4436.25)) - math.sqrt(26.25) - 6.5,
        )
    if order == 6:
        return (
            -0.488294589303044755130118038883789062112279161239377608394,
            -0.081679271076237512597937765737059080653379610398148178525368,
            -0.00141415180832581775108724397655859252786416905534669851652709,
        )
    if order == 7:
        return (
            -0.5352804307964381655424037816816460718339231523426924148812,
            -0.122554615192326690515272264359357343605486549427295558490763,
            -0.0091486948096082769285930216516478534156925639545994482648003,
        )
    raise NotImplementedError(f"Unsupported spline order: {order}")


def get_gain(poles: Sequence[float]) -> float:
    """Overall gain of the filter cascade."""
    lam = 1.
    for p in poles:
        lam *= (1. - p) * (1. - 1. / p)
    return lam


def _horizon(pole: float) -> int:
    """Truncation horizon: number of terms for |pole|^m < 1e-13."""
    return int(math.ceil(-30. / math.log(abs(pole))))


def _coeff_bound(bound: int) -> str:
    """The filter bound of an interpolation bound: zero -> dct1,
    replicate -> dct2; dst1 / dst2 raise."""
    bound = int(bound)
    if bound in (BoundType.zero, BoundType.dct1):
        return "dct1"
    if bound in (BoundType.replicate, BoundType.dct2):
        return "dct2"
    if bound == BoundType.dft:
        return "dft"
    raise NotImplementedError(
        "spline_coeff only implements dct1/dct2/dft boundary conditions "
        f"(and their zero/replicate aliases); got bound={bound}")


# ------------------------------------------------- matrix path (host)

def _np_initial(x, pole: float, btype: str):
    """Causal initial value of numpy lines (axis 0)."""
    n = x.shape[0]
    m = _horizon(pole)
    if btype == "dct1":
        if m < n:
            return (pole ** np.arange(m)) @ x[:m]
        polen = pole ** (n - 1)
        out = x[0] + polen * x[-1]
        if n > 2:
            pk = pole ** np.arange(1, n - 1)
            out = out + (pk + (polen * polen) / pk) @ x[1:-1]
        return out / (1. - pole ** (2 * (n - 1)))
    if btype == "dct2":
        polen = pole ** n
        w = pole ** np.arange(n)
        w = w + polen * w[::-1]
        return (w @ x) * (pole / (1. - polen * polen)) + x[0]
    m = min(m, n)                                   # dft
    w = (pole ** np.arange(1, m))[::-1]
    out = w @ x[n - m + 1:] if m > 1 else 0.
    return (out + x[0]) / (1. - pole ** m)


def _np_final(x, pole: float, btype: str):
    """Anticausal initial value of numpy lines (axis 0)."""
    n = x.shape[0]
    if btype == "dct1":
        return (pole * x[-2] + x[-1]) * (pole / (pole * pole - 1.))
    if btype == "dct2":
        return x[-1] * (pole / (pole - 1.))
    m = min(_horizon(pole), n)
    w = pole ** np.arange(2, m + 1)
    out = w[:m - 1] @ x[:m - 1] + pole * x[-1]
    return out / (pole ** m - 1.)


def _filter_matrix_np(n: int, order: int, btype: str) -> np.ndarray:
    """(n, n) float64 matrix of the whole per-axis cascade (gain, every
    pole's two passes, the boundary initial values), built by running the
    scalar recursion on the identity."""
    poles = get_poles(order)
    x = np.eye(n) * get_gain(poles)
    for pole in poles:
        c = np.empty_like(x)
        c[0] = _np_initial(x, pole, btype)
        for i in range(1, n):
            c[i] = x[i] + pole * c[i - 1]
        d = np.empty_like(x)
        d[n - 1] = _np_final(c, pole, btype)
        for i in range(n - 2, -1, -1):
            d[i] = pole * (d[i + 1] - c[i])
        x = d
    return x


# host cache: up to 32 MB per entry at n = 2048; pyramids sweep lengths
@functools.lru_cache(maxsize=32)
def _filter_matrix(n: int, order: int, btype: str) -> np.ndarray:
    return _filter_matrix_np(n, order, btype)


# device cache: a pyramid level's steps reuse one upload
@functools.lru_cache(maxsize=16)
def _device_matrix(n: int, order: int, btype: str, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_filter_matrix(n, order, btype), dtype=dtype,
                           device=device)


def _apply_T(T: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """Contract T's second index against axis 1 of ``x3`` (A, n, C),
    leaving the result index in place: one matrix product (batched over A
    when the axis has both leading and trailing extent)."""
    if x3.shape[2] == 1:
        return (x3[..., 0] @ T.T)[..., None]
    return torch.matmul(T, x3)


# ------------------------------------------------- blocked-scan path
# On (A, n, C) views, the filtered axis in the middle; the boundary
# conditions return one value per line, (A, C).

def _powers(pole: float, start: int, stop: int, like) -> torch.Tensor:
    return torch.tensor(pole, dtype=like.dtype, device=like.device) ** \
        torch.arange(start, stop, dtype=like.dtype, device=like.device)


def _dotw(x, w):
    """Contract ``w`` against axis 1 of x (A, n, C) -> (A, C)."""
    return torch.einsum("anc,n->ac", x, w)


def _dct1_initial(x, pole):
    n = x.shape[1]
    m = _horizon(pole)
    if m < n:
        return _dotw(x[:, :m], _powers(pole, 0, m, x))
    polen = pole ** (n - 1)
    out = x[:, 0] + polen * x[:, -1]
    if n > 2:
        pk = _powers(pole, 1, n - 1, x)
        out = out + _dotw(x[:, 1:-1], pk + (polen * polen) / pk)
    return out / (1. - pole ** (2 * (n - 1)))


def _dct2_initial(x, pole):
    n = x.shape[1]
    polen = pole ** n
    w = _powers(pole, 0, n, x)
    w = w + polen * w.flip(0)
    return _dotw(x, w) * (pole / (1. - polen * polen)) + x[:, 0]


def _dft_initial(x, pole):
    n = x.shape[1]
    m = min(_horizon(pole), n)
    w = _powers(pole, 1, m, x).flip(0)
    out = _dotw(x[:, n - m + 1:], w) + x[:, 0]
    return out / (1. - pole ** m)


def _dct1_final(x, pole):
    return (pole * x[:, -2] + x[:, -1]) * (pole / (pole * pole - 1.))


def _dct2_final(x, pole):
    return x[:, -1] * (pole / (pole - 1.))


def _dft_final(x, pole):
    n = x.shape[1]
    m = min(_horizon(pole), n)
    w = _powers(pole, 2, m + 1, x)
    out = _dotw(x[:, :m - 1], w[:m - 1]) + pole * x[:, -1]
    return out / (pole ** m - 1.)


_INITIAL = {"dct1": _dct1_initial, "dct2": _dct2_initial,
            "dft": _dft_initial}
_FINAL = {"dct1": _dct1_final, "dct2": _dct2_final, "dft": _dft_final}


def _toeplitz(pole: float, k: int, like, anticausal: bool):
    """T[i, j] = pole^(i-j) on the lower (causal) or pole^(j-i) on the
    upper (anticausal) triangle; 0 elsewhere."""
    i = torch.arange(k, device=like.device)
    expo = i[:, None] - i[None, :]
    if anticausal:
        expo = -expo
    p = torch.tensor(pole, dtype=like.dtype, device=like.device)
    return torch.where(expo >= 0, p ** expo.clamp(min=0).to(like.dtype),
                       torch.zeros((), dtype=like.dtype,
                                   device=like.device))


def _chain(x, pole: float, first, anticausal: bool = False):
    """First-order recurrence along axis 1 of x (A, n, C):

    causal:      h[0] = first;   h[i] = x[i] + pole*h[i-1]
    anticausal:  h[n-1] = first; h[i] = x[i] + pole*h[i+1]

    Chunks of K are solved with a (K, K) Toeplitz product plus the carry
    term, in recursion order."""
    n = x.shape[1]
    if n == 1:
        return first[:, None]
    # replace the seed element so the chunk product reproduces it exactly
    if anticausal:
        x = torch.cat([x[:, :-1], first[:, None]], 1)
    else:
        x = torch.cat([first[:, None], x[:, 1:]], 1)
    k = min(_CHUNK, n)
    nchunks = -(-n // k)
    pad = nchunks * k - n
    if pad:
        # zero lanes on the far side of the recursion start
        x = torch.nn.functional.pad(x, (0, 0, pad, 0) if anticausal
                                    else (0, 0, 0, pad))
    T = _toeplitz(pole, k, x, anticausal)
    # the carry enters chunk element i as pole^(i+1) (causal) or
    # pole^(k-i) (anticausal)
    cp = _powers(pole, 1, k + 1, x)
    if anticausal:
        cp = cp.flip(0)
    cp = cp[None, :, None]
    carry = torch.zeros_like(x[:, 0])
    outs = [None] * nchunks
    for j in (range(nchunks - 1, -1, -1) if anticausal else range(nchunks)):
        h = _apply_T(T, x[:, j * k:(j + 1) * k]) + carry[:, None] * cp
        carry = h[:, 0] if anticausal else h[:, k - 1]
        outs[j] = h
    out = torch.cat(outs, 1)
    if pad:
        out = out[:, pad:] if anticausal else out[:, :n]
    return out


def _scan(x3, order: int, btype: str):
    """The cascade along axis 1 of x3 (A, n, C) on the blocked scan."""
    poles = get_poles(order)
    x = x3 * get_gain(poles)
    for pole in poles:
        c = _chain(x, pole, _INITIAL[btype](x, pole))
        x = _chain((-pole) * c, pole, _FINAL[btype](c, pole),
                   anticausal=True)
    return x


def _scan_transpose(x3, order: int, btype: str):
    """The exact transpose of :func:`_scan`: the filter itself where it is
    self-adjoint (dct2, dft), else autograd's VJP of the linear scan at a
    zero primal (dct1)."""
    if btype != "dct1":
        return _scan(x3, order, btype)
    with torch.enable_grad():
        z = torch.zeros_like(x3, requires_grad=True)
        return torch.autograd.grad(_scan(z, order, btype), z, x3)[0]


def _filter(x, order: int, btype: str, axis: int, transpose: bool):
    """The cascade (or its transpose) along ``axis`` of x, in float64."""
    n = x.shape[axis]
    if n == 1:
        return x
    shape = x.shape
    x3 = x.to(_WORK).reshape(math.prod(shape[:axis]), n, -1)
    if n <= _MATRIX_MAX:
        A = _device_matrix(n, order, btype, _WORK, x.device)
        out = _apply_T(A.T if transpose else A, x3)
    elif transpose:
        out = _scan_transpose(x3, order, btype)
    else:
        out = _scan(x3, order, btype)
    return out.reshape(shape).to(x.dtype)


class _Coeff(torch.autograd.Function):
    """The prefilter along one axis (``transpose``: its adjoint); the
    backward applies the other one through this Function."""

    @staticmethod
    def forward(ctx, x, order, btype, axis, transpose):
        ctx.args = (order, btype, axis, transpose)
        return _filter(x, order, btype, axis, transpose)

    @staticmethod
    def backward(ctx, ct):
        order, btype, axis, transpose = ctx.args
        return (_Coeff.apply(ct, order, btype, axis, not transpose),
                None, None, None, None)


# ------------------------------------------------- public ops

def spline_coeff(inp: torch.Tensor, order: int, bound: int,
                 axis: int = -1) -> torch.Tensor:
    """Interpolating spline coefficients along one axis.  Orders 0 and 1
    are the identity; ``bound`` is dct1/dct2/dft or a zero/replicate
    alias."""
    if order in (0, 1):
        return inp
    return _Coeff.apply(inp, int(order), _coeff_bound(bound),
                        axis % inp.ndim, False)


def spline_coeff_nd(inp: torch.Tensor, orders: Sequence[int],
                    bounds: Sequence[int], ndim: int) -> torch.Tensor:
    """Interpolating spline coefficients along the last ``ndim`` axes,
    one separable sweep per axis."""
    out = inp
    for d in range(ndim):
        out = spline_coeff(out, orders[d], bounds[d],
                           axis=out.ndim - ndim + d)
    return out
