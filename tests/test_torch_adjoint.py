"""Adjoints of the dense-warp window tier of the PyTorch port against the
JAX package, float64 on the CPU at ``atol=1e-10 * max(1, max|ref|)``.

The plain push, pushgrad and hess are held to ``_push_impl``,
``_pushgrad_xla`` and ``_hess_xla``; each autograd Function's backward to
``jax.vjp`` of the JAX window op, and second derivatives to ``jax.grad``;
``grid_push`` / ``grid_count`` to the JAX API.  The CUDA kernels are held
to these plain versions in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import interpol_tpu as itp
import interpol_tpu_torch as itt
from interpol_tpu.ops import window as jw
from interpol_tpu_torch.ops import cuda_warp
from interpol_tpu_torch.ops import window as tw

from test_torch_window import CASES, warp_case

ATOL = 1e-10   # float64 on both sides; only the summation order differs


def assert_close(out, ref):
    ref = np.asarray(ref)
    atol = ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("orders,bounds,ex,ish,md,brk", CASES)
def test_push_matches_jax(orders, bounds, ex, ish, md, brk):
    inp, grid = warp_case(ish, disp=md, break_contract=brk)
    ref = jw._push_impl(jnp.asarray(inp[0]), jnp.asarray(grid[0]), orders,
                        bounds, ex, md)
    out = tw._push_impl_torch(torch.as_tensor(inp), torch.as_tensor(grid),
                              orders, bounds, ex, md)
    assert_close(out[0], ref)


# the second-order cases: mixed orders and bounds with 'hist', a grid that
# breaks max_disp, per-axis max_disp, 2-D
@pytest.mark.parametrize("orders,bounds,ex,ish,md,brk",
                         [CASES[i] for i in (2, 5, 6, 7)])
def test_pushgrad_hess_match_jax(orders, bounds, ex, ish, md, brk):
    inp, grid = warp_case(ish, disp=md, break_contract=brk)
    ct = np.random.default_rng(1).standard_normal(inp.shape + (len(ish),))
    ref_pg = jw._pushgrad_xla(jnp.asarray(ct[0]), jnp.asarray(grid[0]),
                              orders, bounds, ex, md)
    ref_h = jw._hess_xla(jnp.asarray(inp[0]), jnp.asarray(grid[0]), orders,
                         bounds, ex, md)
    tg = torch.as_tensor(grid)
    out_pg = tw._pushgrad_impl_torch(torch.as_tensor(ct), tg, orders,
                                     bounds, ex, md)
    out_h = tw._hess_impl_torch(torch.as_tensor(inp), tg, orders, bounds,
                                ex, md)
    assert_close(out_pg[0], ref_pg)
    assert_close(out_h[0], ref_h)
    torch.testing.assert_close(out_h, out_h.transpose(-1, -2), rtol=0,
                               atol=0)


def test_slabs_match_one_shot(monkeypatch):
    # the x-slab streaming of the second-order plain versions (256^3 on
    # the card) against one shot, at a small size with tiny slabs
    orders, bounds, ex, ish, md, _ = CASES[2]
    inp, grid = warp_case(ish, disp=md, B=2)
    ct = np.random.default_rng(2).standard_normal(inp.shape + (3,))
    args = (torch.as_tensor(grid), orders, bounds, ex, md)
    one_pg = tw._pushgrad_impl_torch(torch.as_tensor(ct), *args)
    one_h = tw._hess_impl_torch(torch.as_tensor(inp), *args)
    monkeypatch.setattr(tw, "_SLAB_VOX", 126)
    assert len(tw._x_slabs(ish)) == 3
    torch.testing.assert_close(
        tw._pushgrad_impl_torch(torch.as_tensor(ct), *args), one_pg,
        rtol=0, atol=ATOL)
    torch.testing.assert_close(
        tw._hess_impl_torch(torch.as_tensor(inp), *args), one_h, rtol=0,
        atol=0)


# one small 2-D configuration for every Function (JAX compiles per
# configuration; the 3-D plain versions are held to JAX above, and the
# train steps of test_torch_train.py run the Functions in 3-D):
# orders, bounds, extrapolate, ishape, max_disp
VJP_CASE = ((3, 2), (0, 4), 2, (7, 9), 0.5)


@pytest.mark.parametrize("op", ["pull", "push", "grad", "pushgrad"])
def test_function_backward_matches_jax_vjp(op):
    orders, bounds, ex, ish, md = VJP_CASE
    D = len(ish)
    inp, grid = warp_case(ish, disp=md, B=2, seed=3)
    rng = np.random.default_rng(4)
    if op == "pushgrad":
        inp = rng.standard_normal(inp.shape + (D,))
    ct = rng.standard_normal(inp.shape[:2] + ish
                             + ((D,) if op == "grad" else ()))
    jf = getattr(jw, f"{op}_window")
    out, vjp = jax.vjp(
        jax.vmap(lambda a, g: jf(a, g, orders, bounds, ex, md)),
        jnp.asarray(inp), jnp.asarray(grid))
    ref_di, ref_dg = vjp(jnp.asarray(ct))
    ti = torch.tensor(inp, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    tout = getattr(tw, f"{op}_window")(ti, tg, orders, bounds, ex, md)
    di, dg = torch.autograd.grad(tout, [ti, tg], torch.as_tensor(ct))
    assert_close(tout.detach(), out)
    assert_close(di, ref_di)
    assert_close(dg, ref_dg)


def test_backward_computes_only_what_is_asked(monkeypatch):
    # the train step differentiates the grid alone: no push may run
    orders, bounds, ex, ish, md = VJP_CASE
    inp, grid = warp_case(ish, disp=md)
    tg = torch.tensor(grid, requires_grad=True)

    def no_push(*args):
        raise AssertionError("push ran for an input that needs no grad")

    monkeypatch.setattr(tw, "_push", no_push)
    out = tw.pull_window(torch.as_tensor(inp), tg, orders, bounds, ex, md)
    (dg,) = torch.autograd.grad(out.sum(), [tg])
    assert dg.shape == tg.shape


def test_gradcheck_pull_push():
    # cubic, no mask, displacements well inside max_disp: smooth in both
    rng = np.random.default_rng(5)
    ish = (2, 3, 4)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    grid = torch.tensor(ident + rng.uniform(-0.3, 0.3, (1,) + ish + (3,)),
                        requires_grad=True)
    inp = torch.tensor(rng.standard_normal((1, 2) + ish),
                       requires_grad=True)
    opts = ((3, 3, 3), (3, 0, 6), 1, 0.5)
    for fn in (tw.pull_window, tw.push_window):
        assert torch.autograd.gradcheck(lambda i, g: fn(i, g, *opts),
                                        (inp, grid), fast_mode=True)


def test_second_order_matches_jax():
    # d/d(inp, grid) of sum(d_grid), d_grid the grid gradient of
    # sum(pull**2) built with create_graph=True; and hess_window's backward
    orders, bounds, ex, ish, md = VJP_CASE
    inp, grid = warp_case(ish, disp=md, B=2, seed=7)
    ct = np.random.default_rng(8).standard_normal(
        inp.shape + (len(ish),) * 2)

    def jvm(fn):
        return jax.vmap(lambda a, g: fn(a, g, orders, bounds, ex, md))

    def dgrid_sum(a, g):
        return jnp.sum(jax.grad(
            lambda g2: jnp.sum(jvm(jw.pull_window)(a, g2) ** 2))(g))
    ref_di, ref_dg = jax.grad(dgrid_sum, argnums=(0, 1))(
        jnp.asarray(inp), jnp.asarray(grid))
    _, vjp = jax.vjp(jvm(jw.hess_window), jnp.asarray(inp),
                     jnp.asarray(grid))
    ref_hi, ref_hg = vjp(jnp.asarray(ct))

    ti = torch.tensor(inp, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    out = tw.pull_window(ti, tg, orders, bounds, ex, md)
    (dg,) = torch.autograd.grad(out.square().sum(), [tg], create_graph=True)
    di2, dg2 = torch.autograd.grad(dg.sum(), [ti, tg])
    assert_close(di2, ref_di)
    assert_close(dg2, ref_dg)
    h = tw.hess_window(ti, tg, orders, bounds, ex, md)
    hi, hg = torch.autograd.grad(h, [ti, tg], torch.as_tensor(ct))
    assert_close(hi, ref_hi)
    assert_close(hg, ref_hg)


def test_grid_push_count_match_jax():
    rng = np.random.default_rng(6)
    ish = (4, 5, 6)
    img = rng.standard_normal((2, 3) + ish)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    grid = ident + rng.uniform(-0.5, 0.5, (2,) + ish + (3,))
    kw = dict(interpolation=[3, 2, 1], bound=["dct2", "zero", "dft"],
              extrapolate=False, max_disp=0.5)
    assert_close(
        itt.grid_push(torch.as_tensor(img), torch.as_tensor(grid), **kw),
        itp.grid_push(jnp.asarray(img), jnp.asarray(grid), **kw))
    del kw["extrapolate"]
    assert_close(itt.grid_count(torch.as_tensor(grid), **kw),
                 itp.grid_count(jnp.asarray(grid), **kw))
    assert itt.push is itt.grid_push and itt.count is itt.grid_count
    # without max_disp, or onto another shape: the generic path
    del kw["max_disp"]
    assert_close(
        itt.grid_push(torch.as_tensor(img), torch.as_tensor(grid), **kw),
        itp.grid_push(jnp.asarray(img), jnp.asarray(grid), **kw))
    assert_close(
        itt.grid_count(torch.as_tensor(grid), shape=(4, 4, 4), max_disp=1.0,
                       **kw),
        itp.grid_count(jnp.asarray(grid), shape=(4, 4, 4), max_disp=1.0,
                       **kw))


def test_cuda_wrappers_refuse_cpu_tensors():
    inp, grid = warp_case((4, 5, 6))
    ti = torch.as_tensor(inp, dtype=torch.float32)
    tg = torch.as_tensor(grid, dtype=torch.float32)
    opts = ((3, 3, 3), (3, 3, 3), 1, 1.5)
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_warp.push_cuda(ti, tg, *opts)
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_warp.push_cuda(ti[..., None].expand(ti.shape + (3,)), tg,
                            *opts, deriv=True)
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_warp.hess_cuda(ti, tg, *opts)
