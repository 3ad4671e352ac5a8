"""The ported slice as a whole: ``WarpModel.dense_flow`` and ``warp`` of
the PyTorch port against the JAX model, with the JAX parameters carried
over (float64, ``atol=1e-10``); and the port's independence from JAX."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interpol_tpu.models import warp as jwarp
from interpol_tpu_torch.models import warp as twarp

ATOL = 1e-10


def jax_model_and_data(seed=0, **cfg):
    model = jwarp.WarpModel(vol_shape=(12, 10, 16), coarse_shape=(4, 4, 4),
                            interpolation=3, bound="dct2", max_disp=1.0,
                            **cfg)
    rng = np.random.default_rng(seed)
    params = 0.5 * rng.standard_normal((2, 4, 4, 4, 3))
    moving = rng.standard_normal((2, 3, 12, 10, 16))
    fixed = rng.standard_normal((2, 3, 12, 10, 16))
    return model, params, moving, fixed


@pytest.mark.parametrize("cfg", [{}, dict(coarse_clamp=True),
                                 dict(tile_spread="auto")])
def test_warp_model_matches_jax(cfg):
    jmodel, params, moving, fixed = jax_model_and_data(**cfg)
    tmodel = twarp.WarpModel(**jmodel._asdict(), device="cpu",
                             dtype=torch.float64)
    tmodel.load_jax_params(params)
    np.testing.assert_allclose(
        tmodel.dense_flow().detach().numpy(),
        np.asarray(jmodel.dense_flow(jnp.asarray(params))), atol=ATOL)
    ref = jmodel.warp(jnp.asarray(params), jnp.asarray(moving))
    out = tmodel(torch.as_tensor(moving))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    ref_loss = jwarp.mse_loss(jmodel, jnp.asarray(params),
                              jnp.asarray(moving), jnp.asarray(fixed))
    loss = twarp.mse_loss(tmodel, torch.as_tensor(moving),
                          torch.as_tensor(fixed))
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=ATOL)


def test_params_and_config_carry_over():
    jmodel, params, _, _ = jax_model_and_data()
    t = twarp.params_from_jax(params, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(t.numpy(), params)
    tmodel = twarp.WarpModel(**jmodel._asdict())
    assert tuple(tmodel.params.shape) == (1, 4, 4, 4, 3)
    assert not tmodel.params.any()
    assert tmodel.auto_tile_spread() == jmodel.auto_tile_spread()


def test_port_imports_no_jax():
    code = ("import sys, interpol_tpu_torch; "
            "sys.exit(int(any(m == 'jax' or m.startswith('jax.') "
            "or m.startswith('interpol_tpu.') or m == 'interpol_tpu' "
            "for m in sys.modules)))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
