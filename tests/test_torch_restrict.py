"""``separable_push`` and ``restrict`` of the PyTorch port against the JAX
package (``interpol_tpu/ops/separable.py``, ``ops/resize.py``).

Float64 on both sides at ``atol=1e-10``: the same sampling matrices and
tensordots, summed in another order.  The adjoint identity <resize x, y> =
<x, restrict(y, reduce_sum=True)> holds in float64 to 1e-10 of the sum of
|terms|."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interpol_tpu.ops import resize as jr
from interpol_tpu.ops import separable as js
from interpol_tpu_torch.ops import resize as tr
from interpol_tpu_torch.ops import separable as ts

ATOL = 1e-10


def test_separable_push_matches_jax():
    rng = np.random.default_rng(0)
    inp = rng.standard_normal((2, 3, 7, 9))
    lines = [np.linspace(-0.7, 5.4, 7), 1.3 * np.arange(9) - 0.4]
    oshape = (5, 11)
    for orders, bounds, ex in [((3, 1), (3, 0), 1), ((1, 2), (6, 4), 0)]:
        ref = js.separable_push(jnp.asarray(inp),
                                [jnp.asarray(l) for l in lines], oshape,
                                orders, bounds, ex)
        out = ts.separable_push(torch.as_tensor(inp),
                                [torch.as_tensor(l) for l in lines], oshape,
                                orders, bounds, ex)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


CASES = [
    # ishape, factor / shape, anchor, order, reduce_sum
    ((12, 9), dict(factor=[2, 2]), "c", 1, False),
    ((12, 9), dict(shape=[5, 4]), "e", 3, True),
    ((12, 9), dict(factor=[2, 1.5]), ["f", "l"], 3, False),
    ((12, 9), dict(shape=[6, 4]), "l", 1, True),
    ((10, 8, 9), dict(shape=[5, 4, 4]), "e", 3, False),
    ((10, 8, 9), dict(factor=[2, 2, 3]), ["c", "f", "l"], 1, True),
]


@pytest.mark.parametrize("ish,geom,anchor,order,reduce_sum", CASES)
def test_restrict_matches_jax(ish, geom, anchor, order, reduce_sum):
    img = np.random.default_rng(1).standard_normal((2, 1) + ish)
    kw = dict(geom, anchor=anchor, interpolation=order,
              reduce_sum=reduce_sum, bound="dct2")
    ref = jr.restrict(jnp.asarray(img), **kw)
    out = tr.restrict(torch.as_tensor(img), **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_restrict_is_the_adjoint_of_resize():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((1, 2, 6, 5, 7)))
    y = torch.as_tensor(rng.standard_normal((1, 2, 11, 9, 13)))
    for anchor, order in [("e", 3), ("c", 1), (["f", "l", "c"], 3)]:
        kw = dict(anchor=anchor, interpolation=order, bound="dct2")
        rx = tr.resize(x, shape=[11, 9, 13], prefilter=False, **kw)
        ry = tr.restrict(y, shape=[6, 5, 7], reduce_sum=True, **kw)
        lhs, rhs = (rx * y).sum().item(), (x * ry).sum().item()
        assert abs(lhs - rhs) <= 1e-10 * (rx * y).abs().sum().item()


def test_restrict_not_ported_yet_raises():
    img = torch.zeros((1, 1, 8, 8), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="prefilter"):
        tr.restrict(img, factor=[2, 2], prefilter=True)
    with pytest.raises(NotImplementedError, match="label"):
        tr.restrict(img.long(), factor=[2, 2])
