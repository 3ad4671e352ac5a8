"""The coarse-to-fine pyramid of the PyTorch port (``models/pyramid.py``)
against the JAX package's (``interpol_tpu/models/pyramid.py``).

Float64 on both sides.  The level shapes are equal; the image pyramids
agree at ``atol=1e-10`` (the same restrictions); ``run_level`` and
``register`` agree at ``atol=1e-8`` on the losses and the parameters: each
SGD step feeds the previous step's rounding into the next, through a
gradient of norm ~1 at ``lr=1`` (the per-step differences are ~1e-12)."""
import numpy as np
import torch

import jax.numpy as jnp

from interpol_tpu.models import pyramid as jp
from interpol_tpu.models import warp as jwarp
from interpol_tpu.ops.resize import resize as jresize
from interpol_tpu_torch.models import pyramid as tp
from interpol_tpu_torch.models import warp as twarp

ATOL = 1e-10
ATOL_SGD = 1e-8


def smooth_image(shape, seed):
    """Band-limited random image (white noise upsampled), (1, 1, *shape),
    as the JAX package's pyramid tests make it."""
    rng = np.random.default_rng(seed)
    coarse = tuple(max(3, n // 4) for n in shape)
    x = rng.standard_normal((1, 1) + coarse)
    return np.array(jresize(jnp.asarray(x), shape=list(shape),
                            anchor=["e"] * len(shape), interpolation=3,
                            prefilter=False))


def models(**cfg):
    return jp.PyramidModel(**cfg), tp.PyramidModel(**cfg, device="cpu",
                                                   dtype=torch.float64)


def test_level_shapes_and_image_pyramid_match_jax():
    jm, tm = models(vol_shape=(48, 37), coarse_shape=(4, 4), levels=3,
                    interpolation=3, max_disp=4.0)
    assert tm.level_shapes() == jm.level_shapes()
    for level in range(3):
        assert tm.level_model(level).max_disp == \
            jm.level_model(level).max_disp
        assert tm.level_model(level).vol_shape == \
            jm.level_model(level).vol_shape
    assert tuple(tm.init_params(2).shape) == jm.init_params(2).shape
    img = smooth_image((48, 37), 0)
    ref = jp.image_pyramid(jm, jnp.asarray(img))
    out = tp.image_pyramid(tm, torch.as_tensor(img))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_run_level_matches_jax():
    wcfg = dict(vol_shape=(16, 16), coarse_shape=(4, 4), interpolation=1,
                max_disp=2.0)
    jm = jwarp.WarpModel(**wcfg)
    tm = twarp.WarpModel(**wcfg, device="cpu", dtype=torch.float64)
    moving = smooth_image((16, 16), 3)
    fixed = np.roll(moving, 1, axis=2)
    p0 = 0.1 * np.random.default_rng(4).standard_normal((1, 4, 4, 2))
    p_ref, tr_ref = jp.run_level(jm, jnp.asarray(p0), jnp.asarray(moving),
                                 jnp.asarray(fixed), 4, 1.0)
    p_out, tr_out = tp.run_level(tm, torch.as_tensor(p0),
                                 torch.as_tensor(moving),
                                 torch.as_tensor(fixed), 4, 1.0)
    assert tuple(tr_out.shape) == (4,)
    np.testing.assert_allclose(tr_out.numpy(), np.asarray(tr_ref),
                               atol=ATOL_SGD)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(p_ref),
                               atol=ATOL_SGD)


def test_register_matches_jax_and_keeps_params():
    """A tiny 3-D pyramid, cubic, two levels, ``tile_spread="auto"`` (the
    adaptive windows on every level), warm-started from given params."""
    vol = (16, 12, 16)
    jm, tm = models(vol_shape=vol, coarse_shape=(3, 3, 3), levels=2,
                    interpolation=3, max_disp=2.0, steps_per_level=4,
                    tile_spread="auto")
    moving = smooth_image(vol, 11)
    fixed = np.roll(moving, 1, axis=4)
    p0 = 0.05 * np.random.default_rng(12).standard_normal((1, 3, 3, 3, 3))
    p_ref, l_ref = jp.register(jm, jnp.asarray(moving), jnp.asarray(fixed),
                               lr=1.0, params=jnp.asarray(p0))
    params = torch.as_tensor(p0.copy())
    p_out, l_out = tp.register(tm, torch.as_tensor(moving),
                               torch.as_tensor(fixed), lr=1.0,
                               params=params)
    assert tuple(l_out.shape) == (2, 4)
    assert torch.isfinite(l_out).all()
    np.testing.assert_array_equal(params.numpy(), p0)   # left as it was
    np.testing.assert_allclose(l_out.numpy(), np.asarray(l_ref),
                               atol=ATOL_SGD)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(p_ref),
                               atol=ATOL_SGD)
    for level in range(2):
        assert l_out[level, -1] < l_out[level, 0]
