"""PyTorch port primitives against the JAX package: options, boundary
folding, B-spline taps.  Same inputs (numpy, from a seed) through both;
float64 on both sides."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interpol_tpu import options as jopt
from interpol_tpu.ops import bounds as jb
from interpol_tpu.ops import splines as js
from interpol_tpu_torch import options as topt
from interpol_tpu_torch.ops import bounds as tb
from interpol_tpu_torch.ops import splines as ts

ATOL = 1e-10   # the two frameworks only sum in a different order


@pytest.mark.parametrize("args", [
    ("cubic", "dct2", True, 3),
    (["linear", 5, "nearest"], ["zero", "wrap", "antimirror"], "hist", 3),
    (7, ["mirror", "reflect"], 0, 4),
    (("second",), ("dirichlet", "border", "circular"), "no", 2),
    (topt.InterpolationType.fifth, topt.BoundType.dst1, 2, 1),
])
def test_normalize_options(args):
    interp, bound, ex, ndim = args
    assert topt.normalize_options(interp, bound, ex, ndim) == \
        jopt.normalize_options(interp, bound, ex, ndim)


@pytest.mark.parametrize("fn,bad", [
    (topt.to_bound, "bogus"), (topt.to_bound, 7), (topt.to_order, 8),
    (topt.to_order, "ninth"), (topt.to_extrapolate, 3),
    (topt.to_extrapolate, "maybe")])
def test_options_reject(fn, bad):
    with pytest.raises(ValueError):
        fn(bad)


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("bound", range(7))
def test_fold_index_and_sign(bound, n):
    idx = np.arange(-20, 21)
    ref_i = np.asarray(jb.fold_index(jnp.asarray(idx), n, bound))
    ref_s = jb.fold_sign(jnp.asarray(idx), n, bound, jnp.float64)
    for x in (torch.as_tensor(idx), idx):
        out_i = tb.fold_index(x, n, bound)
        np.testing.assert_array_equal(np.asarray(out_i), ref_i)
        out_s = tb.fold_sign(x, n, bound, torch.float64
                             if isinstance(x, torch.Tensor) else np.float64)
        assert (out_s is None) == (ref_s is None)
        if ref_s is not None:
            np.testing.assert_array_equal(np.asarray(out_s),
                                          np.asarray(ref_s))
    assert tb.has_sign(bound, n) == jb.has_sign(bound, n)


def test_fold_quirks():
    # dst1 gives sign 0 at the in-bounds index 0; dct1 at n == 1 folds
    # everything onto 0
    i = torch.arange(-3, 4)
    assert tb.fold_sign(i, 5, 4)[3].item() == 0
    assert torch.equal(tb.fold_index(i, 1, 2), torch.zeros_like(i))


@pytest.mark.parametrize("order", range(8))
def test_bspline_taps(order):
    rng = np.random.default_rng(order)
    g = rng.uniform(-3, 9, 64)
    g[:8] = np.arange(8) - 2.5      # half-integers: order-0 ties
    n0j, tj = js.node_origin(jnp.asarray(g), order)
    n0t, tt = ts.node_origin(torch.as_tensor(g), order)
    np.testing.assert_array_equal(n0t.numpy(), np.asarray(n0j))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=ATOL)
    ref = js.bspline_taps(tj, order, grad=True, hess=True)
    out = ts.bspline_taps(tt, order, grad=True, hess=True)
    for r, o in zip(ref, out):
        assert len(r) == len(o) == order + 1
        for rj, oj in zip(r, o):
            np.testing.assert_allclose(oj.numpy(), np.asarray(rj),
                                       atol=ATOL)
