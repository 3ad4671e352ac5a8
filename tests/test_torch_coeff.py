"""The interpolating prefilter of the PyTorch port (``ops/coeff.py``)
against the JAX package (``interpol_tpu/ops/coeff.py``).

Float64 on both sides: the filter matrices to 1e-12 (the same scalar
recursion on the identity), ``spline_coeff`` / ``spline_coeff_nd`` and the
prefiltered ``grid_pull`` / ``grid_grad`` / ``grid_push`` to 1e-10 (the same
products summed in another order), the adjoint identities to rtol 1e-12;
the resize-identity contract at rtol 1e-5, atol 1e-7, as the JAX package
holds it (``tests/test_coeff.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import interpol_tpu as itp
import interpol_tpu_torch as itt
from interpol_tpu.ops import coeff as jc
from interpol_tpu_torch.ops import coeff as tc
from interpol_tpu_torch.ops import resize as tr

ATOL = 1e-10
BOUND_IDS = {"dct1": 2, "dct2": 3, "dft": 6}


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("bound", ["dct1", "dct2", "dft"])
def test_filter_matrix_matches_jax(bound):
    x = np.random.default_rng(0).standard_normal((3, 1))
    for order in range(2, 8):
        for n in (2, 3, 9, 37):
            np.testing.assert_allclose(
                tc._filter_matrix_np(n, order, bound),
                jc._filter_matrix_np(n, order, bound), rtol=0, atol=1e-12)
        # a line of one sample: the identity in both packages (neither
        # builds a matrix there)
        b = BOUND_IDS[bound]
        np.testing.assert_array_equal(
            tc.spline_coeff(_t(x), order, b, axis=1).numpy(),
            np.asarray(jc.spline_coeff(jnp.asarray(x), order, b, axis=1)))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_spline_coeff_matches_jax(axis):
    # every filter bound and the zero / replicate aliases
    x = np.random.default_rng(1).standard_normal((6, 5, 7))
    for order, bound in [(2, 0), (3, 1), (4, 2), (5, 3), (7, 6)]:
        ref = jc.spline_coeff(jnp.asarray(x), order, bound, axis=axis)
        out = tc.spline_coeff(_t(x), order, bound, axis=axis)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_public_spline_coeff_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 6, 7))
    for fn, kw in [("spline_coeff", dict(interpolation=3, dim=1)),
                   ("spline_coeff", dict(interpolation="quadratic",
                                         bound="replicate")),
                   ("spline_coeff_nd", dict(interpolation=[3, 5, 2, 4],
                                            bound=["dct1", "dft", "zero",
                                                   "dct2"])),
                   ("spline_coeff_nd", dict(interpolation=3, dim=2))]:
        ref = getattr(itp, fn)(jnp.asarray(x), **kw)
        out = getattr(itt, fn)(_t(x), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # orders 0 and 1 are the identity
    np.testing.assert_array_equal(
        itt.spline_coeff_nd(_t(x), interpolation=[0, 1, 1, 0]).numpy(), x)


def test_unsupported_bound_raises():
    x = torch.zeros((3, 8))
    for bad in ("dst1", "dst2"):
        with pytest.raises(NotImplementedError):
            itt.spline_coeff(x, 3, bad)
    with pytest.raises(NotImplementedError):
        itt.grid_pull(x[None, None], torch.zeros((1, 2, 2, 2)),
                      interpolation=3, bound="dst2", prefilter=True)


@pytest.mark.parametrize("bound", ["dct1", "dct2", "dft"])
def test_matrix_path_matches_scan_path(bound, monkeypatch):
    x = _t(np.random.default_rng(3).standard_normal((5, 37, 4)))
    b = BOUND_IDS[bound]
    for order in (2, 3, 5, 7):
        mat = [tc.spline_coeff(x, order, b, axis=a) for a in (0, 1, 2)]
        with monkeypatch.context() as m:
            m.setattr(tc, "_MATRIX_MAX", 0)        # force the scan path
            for a, ref in enumerate(mat):
                scan = tc.spline_coeff(x, order, b, axis=a)
                np.testing.assert_allclose(scan.numpy(), ref.numpy(),
                                           rtol=1e-10, atol=1e-10)


def test_scan_path_matches_jax():
    # past the matrix path's limit (2048): the blocked scan, 17 chunks
    x = np.random.default_rng(4).standard_normal((2, 2100))
    ref = jc.spline_coeff(jnp.asarray(x), 3, 2, axis=1)
    out = tc.spline_coeff(_t(x), 3, 2, axis=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("bound", ["dct1", "dct2", "dft"])
def test_adjoint_identity_and_vjp(bound, scan, monkeypatch):
    """<F u, v> == <u, F^T v> with the backward's transpose (dct1 is not
    self-adjoint), and the VJP equal to ``jax.vjp``'s on both paths."""
    if scan:
        monkeypatch.setattr(tc, "_MATRIX_MAX", 0)
        monkeypatch.setattr(jc, "_MATRIX_MAX", 0)
    rng = np.random.default_rng(5)
    u, v = rng.standard_normal((2, 3, 23))
    b = BOUND_IDS[bound]
    ut = _t(u).requires_grad_()
    fu = tc.spline_coeff(ut, 3, b, axis=-1)
    (ftv,) = torch.autograd.grad(fu, ut, _t(v))
    lhs, rhs = (fu.detach() * _t(v)).sum().item(), (ut * ftv).sum().item()
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    _, pull = jax.vjp(lambda t: jc.spline_coeff(t, 3, b, axis=-1),
                      jnp.asarray(u))
    (ref,) = pull(jnp.asarray(v))
    np.testing.assert_allclose(ftv.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("scan", [False, True])
def test_double_backward_through_prefiltered_pull(scan, monkeypatch):
    if scan:
        monkeypatch.setattr(tc, "_MATRIX_MAX", 0)
    rng = np.random.default_rng(6)
    img = _t(rng.standard_normal((1, 4, 5))).requires_grad_()
    grid = _t(rng.uniform(-0.5, 4.5, (3, 2, 2))).requires_grad_()

    def f(i, g):
        return itt.grid_pull(i, g, interpolation=[3, 2], bound=["dct1", 1],
                             prefilter=True)
    assert torch.autograd.gradgradcheck(f, (img, grid))


@pytest.mark.parametrize("fn,kw", [
    ("grid_pull", dict(interpolation=3, bound="dct1", max_disp=1.0)),
    ("grid_grad", dict(interpolation=[4, 3, 2], bound=["dft", "dct2",
                                                       "replicate"])),
    ("grid_push", dict(interpolation=5, bound="dct2", extrapolate=True,
                       max_disp=1.0))])
def test_prefiltered_ops_match_jax(fn, kw):
    rng = np.random.default_rng(7)
    ish = (5, 6, 4)
    img = rng.standard_normal((2,) + ish)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    grid = ident + rng.uniform(-1, 1, (1,) + ish + (3,))
    ref = getattr(itp, fn)(jnp.asarray(img), jnp.asarray(grid),
                           prefilter=True, **kw)
    out = getattr(itt, fn)(_t(img), _t(grid), prefilter=True, **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("bound", ["dct1", "dct2", "dft"])
def test_resize_identity(bound):
    """Resizing to the same shape with the prefilter gives the input back
    (this holds iff the prefilter inverts the spline's sampling), at
    orders 0-7."""
    rng = np.random.default_rng(42)
    for order in range(8):
        for n in (1, 2, 3, 7, 9, 11):
            x = _t(rng.standard_normal((1, 1, n)))
            y = tr.resize(x, shape=[n], anchor="e", interpolation=order,
                          bound=bound, prefilter=True)
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5,
                                       atol=1e-7)


def test_float32_input_and_device_cache():
    """A float32 input is filtered in float64 (no TF32 switch reaches
    it) and comes back float32; the device copy of a matrix is made once
    per (n, order, bound, dtype, device)."""
    x = np.random.default_rng(8).standard_normal((3, 40, 5))
    ref = tc.spline_coeff(_t(x), 3, 3, axis=1)
    before = tc._device_matrix.cache_info()
    out = tc.spline_coeff(_t(x).float(), 3, 3, axis=1)
    after = tc._device_matrix.cache_info()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.float().numpy(), rtol=0,
                               atol=1e-6)
    assert after.hits == before.hits + 1
