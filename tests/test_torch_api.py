"""User-facing API of the PyTorch port against the JAX package:
``grid_pull`` / ``grid_grad`` (shape engine, both the dense-warp path and
the plain gather) and the grid constructors.  Float64, ``atol=1e-10``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import interpol_tpu as itp
import interpol_tpu_torch as itt

ATOL = 1e-10


def dense_case(batch_img, batch_grid, C, ish, disp=1.0, seed=0):
    rng = np.random.default_rng(seed)
    D = len(ish)
    img = rng.standard_normal(batch_img + ((C,) if C else ()) + ish)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    grid = ident + rng.uniform(-disp, disp, batch_grid + ish + (D,))
    return img, grid


@pytest.mark.parametrize("fn", ["grid_pull", "grid_grad"])
@pytest.mark.parametrize("batch_img,batch_grid,C,max_disp", [
    ((2,), (1,), 3, 1.0),       # grid batch broadcasts
    ((), (2,), 0, 1.0),         # no channel, image broadcasts
    ((1, 2), (3, 1), 2, 1.0),   # two batch dims
    ((2,), (2,), 2, None),      # plain gather (no max_disp)
])
def test_grid_ops_match_jax(fn, batch_img, batch_grid, C, max_disp):
    img, grid = dense_case(batch_img, batch_grid, C, (5, 6, 7))
    kw = dict(interpolation=[3, 2, 1], bound=["dct2", "zero", "dft"],
              extrapolate=False, max_disp=max_disp)
    ref = getattr(itp, fn)(jnp.asarray(img), jnp.asarray(grid), **kw)
    out = getattr(itt, fn)(torch.as_tensor(img), torch.as_tensor(grid),
                           **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_grid_pull_plain_gather_off_grid():
    # a sampling grid of another shape than the image: the plain gather
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 6, 7))
    grid = rng.uniform(-1, 7, (4, 5, 2))
    ref = itp.grid_pull(jnp.asarray(img), jnp.asarray(grid), 5, "dst2", 2)
    out = itt.grid_pull(torch.as_tensor(img), torch.as_tensor(grid), 5,
                        "dst2", 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_grid_constructors():
    np.testing.assert_array_equal(
        itt.identity_grid((3, 4, 5), dtype=torch.float64).numpy(),
        np.asarray(itp.identity_grid((3, 4, 5), dtype=jnp.float64)))
    disp = np.random.default_rng(4).standard_normal((2, 3, 4, 2))
    np.testing.assert_allclose(
        itt.add_identity_grid(torch.as_tensor(disp)).numpy(),
        np.asarray(itp.add_identity_grid(jnp.asarray(disp))), atol=ATOL)
    mat = np.random.default_rng(5).standard_normal((2, 4, 4))
    np.testing.assert_allclose(
        itt.affine_grid(torch.as_tensor(mat), (3, 4, 5)).numpy(),
        np.asarray(itp.affine_grid(jnp.asarray(mat), (3, 4, 5))),
        atol=ATOL)


def test_not_ported_yet_raises():
    img, grid = dense_case((1,), (1,), 1, (4, 4, 4))
    # prefilter=True is the identity at orders 0 and 1, as in JAX: the
    # pull, gradient and push (dense-warp and generic paths) match
    for fn, kw in [("grid_pull", dict(max_disp=1.0)),
                   ("grid_grad", dict(interpolation=[1, 0, 1])),
                   ("grid_push", dict(bound="dct2"))]:
        ref = getattr(itp, fn)(jnp.asarray(img), jnp.asarray(grid),
                               prefilter=True, **kw)
        out = getattr(itt, fn)(torch.as_tensor(img), torch.as_tensor(grid),
                               prefilter=True, **kw)
        assert tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # the calls that raised before the prefilter and the label path were
    # ported: cubic and mixed orders with the prefilter, an integer map
    lab = np.floor(2 * img).astype(np.int64)
    for fn, x, kw in [("grid_pull", img, dict(interpolation=3)),
                      ("grid_push", img, dict(interpolation=[1, 1, 2])),
                      ("grid_pull", lab, dict(interpolation=1))]:
        ref = np.asarray(getattr(itp, fn)(jnp.asarray(x), jnp.asarray(grid),
                                          prefilter=True, **kw))
        out = getattr(itt, fn)(torch.as_tensor(x), torch.as_tensor(grid),
                               prefilter=True, **kw)
        assert str(out.dtype) == f"torch.{ref.dtype}"
        assert tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    img, grid = torch.as_tensor(img), torch.as_tensor(grid)
    # check_spread is ported: it measures the grid and raises on a
    # broken bound
    with pytest.raises(RuntimeError, match="windowed-contract VIOLATED"):
        itt.grid_grad(img, grid + 3.0, max_disp=1.0, check_spread=True)
    with pytest.raises(ValueError, match="tile_spread"):
        itt.grid_pull(img, grid, tile_spread=1.0)
