"""Label maps in the PyTorch port against the JAX package: ``grid_pull`` of
an integer map or with ``classes=`` (one soft map per class, optionally
prefiltered, pulled on the dense-warp path under ``max_disp`` or on the
generic path, then a strict argmax), and ``resize`` / ``restrict`` of
integer maps.

Labels are compared exactly, with their dtype and shape, on grids whose
soft values have no exact ties between classes (random displacements;
float64 grids on both sides), except where a test builds a tie on purpose
to hold the tie rule.  ``restrict`` splats a label map as float32 in both
packages, so it is compared at float32's precision."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import interpol_tpu as itp
import interpol_tpu_torch as itt
from interpol_tpu.ops import resize as jr

SH = (6, 7, 5)


def label_case(seed=0, n=4, shape=SH):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, n, (1,) + shape).astype(np.int32)
    ident = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                 indexing="ij"), -1)
    grid = (ident + rng.uniform(-1, 1, shape + (len(shape),)))[None]
    return lab, grid


def assert_labels_equal(out, ref):
    ref = np.asarray(ref)
    assert str(out.dtype) == f"torch.{ref.dtype}"
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kw", [
    dict(interpolation=1),                                   # generic
    dict(interpolation=3, bound="dct2", prefilter=True),
    dict(interpolation=2, max_disp=1.0),                     # dense warp
    dict(interpolation=3, bound="dct1", prefilter=True, max_disp=1.0),
    dict(interpolation=1, max_disp=1.0, tile_spread=1.0, classes=[3, 1]),
], ids=["generic", "generic-prefilter", "window", "window-prefilter",
        "adaptive-classes"])
def test_label_pull_matches_jax(kw):
    lab, grid = label_case()
    ref = itp.grid_pull(jnp.asarray(lab), jnp.asarray(grid), **kw)
    out = itt.grid_pull(torch.as_tensor(lab), torch.as_tensor(grid), **kw)
    assert_labels_equal(out, ref)


def test_classes_on_a_float_map_and_the_tie_rule():
    # a float map with classes=: the output keeps the float dtype; a
    # half-voxel shift at order 1 ties two classes at exactly 0.5, and the
    # first class in the order of ``classes`` keeps the voxel; a voxel of
    # no listed class stays 0
    lab = np.array([[[0., 2., 2., 5., 5., 7.]]])
    grid = (np.arange(6.) + 0.5)[None, :, None]
    for classes in ([2, 5, 7], [7, 5, 2], [5]):
        kw = dict(interpolation=1, bound="replicate", classes=classes)
        ref = itp.grid_pull(jnp.asarray(lab), jnp.asarray(grid), **kw)
        out = itt.grid_pull(torch.as_tensor(lab), torch.as_tensor(grid), **kw)
        assert_labels_equal(out, ref)


def test_label_pull_ignores_the_grid_gradient():
    # a grid that requires grad (a model's flow): the labels are the same
    # and carry no gradient
    lab, grid = label_case(seed=1)
    lab, grid = torch.as_tensor(lab), torch.as_tensor(grid)
    kw = dict(interpolation=3, max_disp=1.0)
    ref = itt.grid_pull(lab, grid, **kw)
    out = itt.grid_pull(lab, grid.clone().requires_grad_(), **kw)
    assert not out.requires_grad
    assert torch.equal(out, ref)


@pytest.mark.parametrize("kw", [
    dict(factor=[2, 1.5]),                          # order 1
    dict(factor=[2, 2], interpolation=3),           # prefilter by default
], ids=["linear", "cubic"])
def test_resize_label_map_matches_jax(kw):
    lab = label_case(seed=2, shape=(6, 7))[0][None]
    ref = jr.resize(jnp.asarray(lab), **kw)
    out = itt.resize(torch.as_tensor(lab), **kw)
    assert_labels_equal(out, ref)


@pytest.mark.parametrize("kw", [dict(factor=2),
                                dict(factor=[2, 2], interpolation=3,
                                     prefilter=True)],
                         ids=["default", "cubic-prefilter"])
def test_restrict_label_map_matches_jax(kw):
    lab = label_case(seed=3, shape=(8, 8))[0][None].astype(np.int64)
    ref = np.asarray(jr.restrict(jnp.asarray(lab), **kw))
    out = itt.restrict(torch.as_tensor(lab), **kw)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_integer_input_to_grad_and_push_matches_jax():
    # not label maps: the gradient and the splat of an integer image run
    # in the grid's float dtype, as the JAX package promotes them
    lab, grid = label_case(seed=4, shape=(6, 7))
    for fn, kw in [("grid_grad", dict(interpolation=3)),
                   ("grid_push", dict(interpolation=2, prefilter=True)),
                   ("grid_grad", dict(interpolation=3, max_disp=1.0))]:
        ref = np.asarray(getattr(itp, fn)(jnp.asarray(lab),
                                          jnp.asarray(grid), **kw))
        out = getattr(itt, fn)(torch.as_tensor(lab), torch.as_tensor(grid),
                               **kw)
        assert out.dtype == torch.float64 and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-10)
