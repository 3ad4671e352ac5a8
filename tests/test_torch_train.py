"""The training paths of the PyTorch port against the JAX package, float64
on the CPU at ``atol=1e-10 * max(1, max|ref|)``: one ``WarpModel``
``train_step`` (loss, parameter gradient, updated parameters), the
``SVFModel`` loss and gradient with and without the Jacobian term, and the
deformation-field algebra of ``ops/flow.py``.  The backward rules run
through the hand-wired adjoints of ``ops/window.py`` (their plain
versions, on the CPU)."""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import interpol_tpu_torch as itt
from interpol_tpu.models import svf as jsvf
from interpol_tpu.models import warp as jwarp
from interpol_tpu.ops import flow as jflow

ATOL = 1e-10


def assert_close(out, ref):
    ref = np.asarray(ref)
    atol = ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=atol)


def test_warp_train_step_matches_jax():
    jmodel = jwarp.WarpModel(vol_shape=(6, 7, 8), coarse_shape=(3, 3, 3),
                             interpolation=3, bound="dct2", max_disp=0.5)
    rng = np.random.default_rng(0)
    params = 0.5 * rng.standard_normal((2, 3, 3, 3, 3))
    moving = rng.standard_normal((2, 2, 6, 7, 8))
    fixed = 0.9 * moving + 0.1 * rng.standard_normal(moving.shape)
    ref_params, ref_loss = jwarp.train_step(
        jmodel, jnp.asarray(params), jnp.asarray(moving), jnp.asarray(fixed),
        0.1)
    ref_grad = (params - np.asarray(ref_params)) / 0.1

    model = itt.WarpModel(**jmodel._asdict(), batch=2, device="cpu",
                          dtype=torch.float64)
    model.load_jax_params(params)
    tm, tf = torch.as_tensor(moving), torch.as_tensor(fixed)
    (grad,) = torch.autograd.grad(itt.mse_loss(model, tm, tf),
                                  [model.params])
    loss = itt.train_step(model, tm, tf, lr=0.1)
    assert_close(loss, ref_loss)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0, atol=1e-9)
    assert_close(model.params.detach(), ref_params)


# one jitted JAX loss-and-gradient per jac_weight (a static argument)
_svf_value_and_grad = jax.jit(jax.value_and_grad(jsvf.svf_mse_loss, argnums=1),
                              static_argnums=(0, 4))


@pytest.mark.parametrize("jac_weight", [0.0, 0.1])
def test_svf_loss_and_gradient_match_jax(jac_weight):
    # linear warp and upsampling (the exponential is linear anyway; the
    # Jacobian term is cubic): the JAX graph stays small enough to trace
    jmodel = jsvf.SVFModel(vol_shape=(8, 9, 10), coarse_shape=(4, 4, 4),
                           interpolation=1, bound="dct2", max_disp=0.5,
                           steps=3)
    rng = np.random.default_rng(1)
    params = 0.5 * rng.standard_normal((1, 4, 4, 4, 3))
    moving = rng.standard_normal((1, 1, 8, 9, 10))
    fixed = 0.9 * moving
    ref_loss, ref_grad = _svf_value_and_grad(
        jmodel, jnp.asarray(params), jnp.asarray(moving), jnp.asarray(fixed),
        jac_weight)

    model = itt.SVFModel(**jmodel._asdict(), device="cpu",
                         dtype=torch.float64)
    model.load_jax_params(params)
    loss = itt.svf_mse_loss(model, torch.as_tensor(moving),
                            torch.as_tensor(fixed), jac_weight)
    (grad,) = torch.autograd.grad(loss, [model.params])
    assert_close(loss.detach(), ref_loss)
    assert_close(grad, ref_grad)
    before = model.params.detach().clone()
    step_loss = itt.svf_train_step(model, torch.as_tensor(moving),
                                   torch.as_tensor(fixed), lr=0.1,
                                   jac_weight=jac_weight)
    assert step_loss.item() == loss.item()
    torch.testing.assert_close(model.params.detach(), before - 0.1 * grad,
                               rtol=0, atol=0)


def test_flow_ops_match_jax():
    rng = np.random.default_rng(2)
    u = 0.3 * rng.standard_normal((1, 5, 6, 7, 3))
    v = 0.3 * rng.standard_normal((1, 5, 6, 7, 3))
    ju, jv, tu, tv = (jnp.asarray(u), jnp.asarray(v), torch.as_tensor(u),
                      torch.as_tensor(v))
    assert_close(itt.compose_disp(tu, tv, max_disp=0.5),
                 jflow.compose_disp(ju, jv, max_disp=0.5))
    assert_close(itt.exp_disp(tu, steps=2, max_disp=0.5),
                 jflow.exp_disp(ju, steps=2, max_disp=0.5))
    assert_close(itt.invert_disp(tu, iters=3, max_disp=0.5),
                 jflow.invert_disp(ju, iters=3, max_disp=0.5))
    assert_close(itt.jacobian_det(tu), jflow.jacobian_det(ju))


def test_models_live_on_the_card_by_default():
    for cls in (itt.WarpModel, itt.SVFModel):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert inspect.signature(itt.params_from_jax).parameters[
        "device"].default == "cuda"
