"""Separable resampling of the PyTorch port against the JAX package:
``sampling_matrix``, ``separable_pull`` and ``resize`` (float64 on both
sides, ``atol=1e-10``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interpol_tpu.ops import resize as jr
from interpol_tpu.ops import separable as js
from interpol_tpu_torch.ops import resize as tr
from interpol_tpu_torch.ops import separable as ts

ATOL = 1e-10


@pytest.mark.parametrize("order,bound,ex,deriv", [
    (0, 1, 1, 0), (1, 0, 0, 0), (2, 6, 2, 1), (3, 3, 1, 0), (3, 4, 0, 2),
    (5, 2, 1, 1), (7, 5, 2, 0)])
def test_sampling_matrix(order, bound, ex, deriv):
    rng = np.random.default_rng(order)
    line = rng.uniform(-2.5, 11.5, 23)
    ref = js.sampling_matrix(jnp.asarray(line), 9, order, bound, ex, deriv)
    out = ts.sampling_matrix(torch.as_tensor(line), 9, order, bound, ex,
                             deriv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_separable_pull():
    rng = np.random.default_rng(0)
    inp = rng.standard_normal((2, 3, 5, 6, 7))
    lines = [rng.uniform(-1, n, m) for n, m in ((5, 8), (6, 4), (7, 9))]
    args = ((3, 1, 2), (3, 0, 6), 1)
    ref = js.separable_pull(jnp.asarray(inp), [jnp.asarray(x) for x in lines],
                            *args)
    out = ts.separable_pull(torch.as_tensor(inp),
                            [torch.as_tensor(x) for x in lines], *args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(shape=[12, 10, 16], anchor=["e"] * 3, interpolation=3,
         bound="dct2"),
    dict(factor=[2, 1.5, 3], anchor="e", interpolation=1),
    dict(shape=[7, 9, 11], anchor="c", interpolation=2, bound="zero",
         extrapolate=False),
    dict(factor=[2, 2, 2], anchor=["f", "l", "e"], interpolation=5),
    dict(factor=2, anchor="e", interpolation=3),   # last dim only
])
def test_resize(kw):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 3, 4, 5, 6))
    ref = jr.resize(jnp.asarray(img), prefilter=False, **kw)
    out = tr.resize(torch.as_tensor(img), prefilter=False, **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_resize_not_ported_yet():
    # the default call (order 1, prefilter=True), and the calls that raised
    # before the prefilter and the label path were ported: cubic and mixed
    # orders with the prefilter, and an integer label map
    img = np.random.default_rng(3).standard_normal((1, 2, 4, 5))
    for kw in [dict(factor=2), dict(factor=[2, 2], interpolation=0),
               dict(factor=2, interpolation=3),
               dict(factor=[2, 2], interpolation=[1, 2])]:
        ref = jr.resize(jnp.asarray(img), **kw)
        out = tr.resize(torch.as_tensor(img), **kw)
        assert tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    lab = np.floor(2 * img).astype(np.int64)
    ref = np.asarray(jr.resize(jnp.asarray(lab), factor=2, prefilter=False))
    out = tr.resize(torch.as_tensor(lab), factor=2, prefilter=False)
    assert out.dtype == torch.int64 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
