"""The scattered tier's public functions (``ops/scattered.py``), the box
helpers and the pointwise B-spline functions of the PyTorch port against
the JAX package, float64 on the CPU at ``atol=1e-10 * max(1, max|ref|)``.

The JAX public functions run their Pallas kernels, which this CPU would
only emulate (interpret mode: tens of seconds per call); they equal the
XLA cores (``interpol_tpu.ops.ndkernels``), and the JAX package's own
``test_scattered.py`` holds them to those cores, so the cores are the
reference here, and ``jax.grad`` of ``interpol_tpu.ops.pushpull`` for the
derivatives.  The cases loop inside few tests: one ``jax.jit`` per
configuration.  The kernels are held to the port's plain versions on the
card in ``test_torch_cuda.py``."""
import importlib.util
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interpol_tpu.ops import ndkernels as jnd
from interpol_tpu.ops import pushpull as jpp
from interpol_tpu.ops import scattered as jsc
from interpol_tpu.ops import splines as jspl
from interpol_tpu_torch.ops import scattered as tsc
from interpol_tpu_torch.ops import splines as tspl

ATOL = 1e-10   # float64 on both sides; only the summation order differs
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close(out, ref):
    ref = np.asarray(ref)
    atol = ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


def cloud(ish, P, C=2, seed=0):
    """Volume (C, *ish) N(0, 1) and P points uniform over [-1.5, n + 0.5]
    per axis: some outside the volume on each side."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((C,) + tuple(ish))
    hi = np.asarray(ish, float) + 0.5
    grid = -1.5 + (hi + 1.5) * rng.uniform(size=(P, len(ish)))
    return inp, grid


# orders, bounds, extrapolate, ishape, points, oshape of the splats
CASES = [
    ((0, 1, 3), (0, 3, 6), 1, (5, 6, 7), 60, (6, 5, 7)),
    ((5, 3, 1), (1, 2, 4), 0, (6, 5, 7), 50, (6, 5, 7)),
    ((3, 3, 3), (3, 3, 3), 1, (7, 6, 8), 60, (7, 6, 8)),
    ((1, 5), (5, 6), 0, (9, 8), 70, (7, 9)),
    ((3, 0), (4, 3), 1, (8, 9), 70, (8, 9)),
    ((0,), (2,), 0, (13,), 40, (13,)),
    ((5,), (6,), 1, (12,), 40, (15,)),
    ((3,), (3,), 1, (11,), 40, (11,)),
]


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _jax_six(inp, grid, vals, ct, oshape, orders, bounds, ex):
    args = (orders, bounds, ex)
    return (jnd.pull_core(inp, grid, *args), jnd.grad_core(inp, grid, *args),
            jnd.hess_core(inp, grid, *args),
            jnd.push_core(vals, grid, oshape, *args),
            jnd.pushgrad_core(ct, grid, oshape, *args),
            jnd.count_core(grid, oshape, *args))


def _torch_six(inp, grid, vals, ct, oshape, orders, bounds, ex, **kw):
    spl = {k: v for k, v in kw.items() if k != "pre"}
    return (tsc.pull_scattered(inp, grid, orders, bounds, ex, **kw),
            tsc.grad_scattered(inp, grid, orders, bounds, ex, **kw),
            tsc.hess_scattered(inp, grid, orders, bounds, ex, **kw),
            tsc.push_scattered(vals, grid, oshape, orders, bounds, ex, **spl),
            tsc.pushgrad_scattered(ct, grid, oshape, orders, bounds, ex,
                                   **spl),
            tsc.count_scattered(grid, oshape, orders, bounds, ex, **spl))


@pytest.mark.parametrize("orders,bounds,ex,ish,P,osh", CASES)
def test_public_functions_match_jax(orders, bounds, ex, ish, P, osh):
    inp, grid = cloud(ish, P, seed=len(ish) + P)
    D = len(ish)
    rng = np.random.default_rng(P)
    vals = rng.standard_normal((2, P))
    ct = rng.standard_normal((2, P, D))
    refs = _jax_six(*map(jnp.asarray, (inp, grid, vals, ct)), osh, orders,
                    bounds, ex)
    t = [torch.as_tensor(a) for a in (inp, grid, vals, ct)]
    outs = _torch_six(*t, osh, orders, bounds, ex)
    shapes = [(2, P), (2, P, D), (2, P, D, D), (2,) + osh, (2,) + osh,
              (1,) + osh]
    for out, ref, shape in zip(outs, refs, shapes):
        assert tuple(out.shape) == shape
        assert out.dtype == torch.float64
        assert_close(out, ref)
    # interpret=True on CPU tensors is the same plain path; pre= from the
    # same volume reads the same values; every box gives the same result
    box = tsc.auto_box(ish, P)
    pre = tsc.precompute_tables(t[0], orders, bounds, box)
    for kw in (dict(interpret=True), dict(box=box, pre=pre),
               dict(box=(1,) * D)):
        for a, b in zip(_torch_six(*t, osh, orders, bounds, ex, **kw), outs):
            assert torch.equal(a, b)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_pre_from_another_volume_follows_the_contract(D):
    # the values and the grid gradient read pre, the input gradient is
    # push(ct) (pushgrad, pushhess) into inp, whatever pre holds, and pre
    # gets none (interpol_tpu/ops/scattered.py:800-815, :936-943)
    inp, grid = cloud((6, 7, 5)[:D], 50, seed=20 + D)
    other, _ = cloud((6, 7, 5)[:D], 1, seed=30 + D)
    rng = np.random.default_rng(40 + D)
    orders, bounds, ex = (3, 1, 2)[:D], (3, 4, 0)[:D], 1
    box = (4,) * D
    args = (orders, bounds, ex)
    jcores = {"pull": jnd.pull_core, "grad": jnd.grad_core,
              "hess": jnd.hess_core}
    tfns = {"pull": tsc.pull_scattered, "grad": tsc.grad_scattered,
            "hess": tsc.hess_scattered}
    for op, jcore in jcores.items():
        ref, vjp = jax.vjp(lambda a, g: jcore(a, g, *args),
                           jnp.asarray(other), jnp.asarray(grid))
        ct = rng.standard_normal(ref.shape)
        ref_dother, ref_dgrid = vjp(jnp.asarray(ct))
        # the input gradient of a gather is linear in the cotangent alone
        _, vjp_inp = jax.vjp(lambda a: jcore(a, jnp.asarray(grid), *args),
                             jnp.asarray(inp))
        (ref_dinp,) = vjp_inp(jnp.asarray(ct))
        ti = torch.tensor(inp, requires_grad=True)
        tg = torch.tensor(grid, requires_grad=True)
        tp = tsc.precompute_tables(torch.tensor(other, requires_grad=True),
                                   orders, bounds, box)
        out = tfns[op](ti, tg, *args, box=box, pre=tp)
        assert_close(out, ref)
        d_inp, d_grid, d_pre = torch.autograd.grad(
            out, [ti, tg, tp], torch.as_tensor(ct), allow_unused=True)
        assert_close(d_inp, ref_dinp)
        assert d_pre is None
        # (hess: the third-order grid leg reads pre too, where the JAX
        # package reads inp; the two agree when pre is built from inp)
        assert_close(d_grid, ref_dgrid)


def test_pre_errors_and_the_lift():
    inp, grid = cloud((6, 7), 30, seed=3)
    ti, tg = torch.as_tensor(inp), torch.as_tensor(grid)
    args = ((3, 3), (3, 3), 1)
    pre = tsc.precompute_tables(ti, *args[:2], (4, 4))
    # the 2-D lift of interpol_tpu/ops/scattered.py:532-537
    assert pre.shape == (2, 6, 7, 1) and pre.is_contiguous()
    assert torch.equal(pre[..., 0], ti)
    assert tsc.precompute_tables(ti[:, 0], (3,), (3,), (4,)).shape \
        == (2, 7, 1, 1)
    assert tsc.precompute_tables(ti.float(), *args[:2], (4, 4)).dtype \
        == torch.float32
    for fn in (tsc.pull_scattered, tsc.grad_scattered, tsc.hess_scattered):
        with pytest.raises(ValueError, match="requires the box"):
            fn(ti, tg, *args, pre=pre)
        with pytest.raises(ValueError, match="does not match"):
            fn(ti, tg, *args, box=(4, 4), pre=pre[..., 0])
        with pytest.raises(ValueError, match="does not match"):
            fn(ti, tg, *args, box=(4, 4), pre=pre[:1])
        with pytest.raises(ValueError, match="box"):
            fn(ti, tg, *args, box=(4, 4, 1))
    with pytest.raises(ValueError, match="grid"):
        tsc.pull_scattered(ti, tg[None], *args)
    with pytest.raises(ValueError, match="orders"):
        tsc.pull_scattered(ti, tg, (3,), (3,), 1)
    with pytest.raises(ValueError, match="spatial axes"):
        tsc.push_scattered(ti[:, 0], tg, (6, 7, 2), *args)
    # 2-D pull / grad / hess from the lifted pre equal the JAX cores
    jargs = (jnp.asarray(inp), jnp.asarray(grid), *args)
    for fn, core in ((tsc.pull_scattered, jnd.pull_core),
                     (tsc.grad_scattered, jnd.grad_core),
                     (tsc.hess_scattered, jnd.hess_core)):
        assert_close(fn(ti, tg, *args, box=(4, 4), pre=pre), core(*jargs))


@pytest.mark.parametrize("op,D", [("pull", 3), ("grad", 3), ("pull", 2),
                                  ("grad", 1)])
def test_autograd_matches_jax_to_second_order(op, D):
    inp, grid = cloud((5, 6, 7)[:D], 40, seed=50 + D)
    orders, bounds, ex = (3, 2, 5)[:D], (3, 6, 1)[:D], 1
    args = (orders, bounds, ex)
    jf = {"pull": jpp.pull, "grad": jpp.grad}[op]
    tf = {"pull": tsc.pull_scattered, "grad": tsc.grad_scattered}[op]

    def f(a, g):
        return jf(a[None], g[None], *args)[0]

    def first(a, g):
        return jax.grad(lambda a2, g2: jnp.sum(f(a2, g2) ** 2),
                        argnums=(0, 1))(a, g)

    def first_sum(a, g):
        da, dg = first(a, g)
        return jnp.sum(da) + jnp.sum(dg)

    ja, jg = jnp.asarray(inp), jnp.asarray(grid)
    refs1 = jax.jit(first)(ja, jg)
    refs2 = jax.jit(jax.grad(first_sum, argnums=(0, 1)))(ja, jg)
    box = (4,) * D
    for kw in ({}, {"box": box}):
        ti = torch.tensor(inp, requires_grad=True)
        tg = torch.tensor(grid, requires_grad=True)
        if kw:   # pre= from the same volume: the same derivatives
            kw["pre"] = tsc.precompute_tables(ti, orders, bounds, box)
        out = tf(ti, tg, *args, **kw)
        da, dg = torch.autograd.grad(out.square().sum(), [ti, tg],
                                     create_graph=True)
        assert_close(da, refs1[0])
        assert_close(dg, refs1[1])
        grads = torch.autograd.grad(da.sum() + dg.sum(), [ti, tg])
        for g, r in zip(grads, refs2):
            assert_close(g, r)


def test_splat_autograd_matches_jax():
    inp, grid = cloud((6, 5, 7), 40, seed=60)
    args = ((3, 1, 2), (3, 0, 6), 1)
    osh = (6, 5, 7)
    rng = np.random.default_rng(61)
    vals, ct = rng.standard_normal((2, 40)), rng.standard_normal((2, 40, 3))
    u = rng.standard_normal((2,) + osh)
    refs = jax.jit(lambda v, c, g: jax.vjp(
        lambda v2, c2, g2: (jpp.push(v2[None], g2[None], osh, *args)[0],
                            jpp.pushgrad(c2[None], g2[None], osh, *args)[0],
                            jpp.count(g2[None], osh, *args)[0]),
        v, c, g)[1]((jnp.asarray(u), jnp.asarray(u), jnp.asarray(u[:1]))))(
        jnp.asarray(vals), jnp.asarray(ct), jnp.asarray(grid))
    tv, tc, tg = (torch.tensor(a, requires_grad=True)
                  for a in (vals, ct, grid))
    tu = torch.as_tensor(u)
    outs = (tsc.push_scattered(tv, tg, osh, *args),
            tsc.pushgrad_scattered(tc, tg, osh, *args),
            tsc.count_scattered(tg, osh, *args))
    loss = sum((o * tu[:o.shape[0]]).sum() for o in outs)
    for g, r in zip(torch.autograd.grad(loss, [tv, tc, tg]), refs):
        assert_close(g, r)


def test_box_helpers_match_jax():
    assert set(jsc.__all__) <= set(tsc.__all__)
    assert tsc.DEFAULT_BOX == jsc.DEFAULT_BOX
    assert tsc.MIN_POINTS == jsc.MIN_POINTS
    shapes = [(256, 256, 256), (48, 48, 64), (7, 6, 8), (300, 17, 1),
              (4096, 4096), (64, 1), (96, 80), (1_000_000,), (50,),
              (129, 1, 1), (2, 3, 4), (1, 1, 1)]
    for shape in shapes:
        for P in (1, 100, 20_000, 32768, 1_000_000, 16_777_216):
            assert tsc.auto_box(shape, P) == jsc.auto_box(shape, P)
            assert tsc.auto_box_splat(shape, P) == \
                jsc.auto_box_splat(shape, P)
            box = jsc.auto_box(shape, P)
            for orders in [(0,) * len(shape), (3,) * len(shape),
                           tuple(range(1, 8))[:len(shape)]]:
                for ish in (shape, None):
                    assert tsc.box_geometry(orders, box, ish) == \
                        jsc.box_geometry(orders, box, ish)


def test_bspline_pointwise_match_jax():
    assert set(jspl.__all__) <= set(tspl.__all__)
    # knots (integers and half-integers) included, and beyond the support
    x = np.concatenate([np.linspace(-5, 5, 401), np.arange(-5, 5.5, 0.5),
                        np.random.default_rng(7).uniform(-5, 5, 300)])
    for order in range(8):
        for name in ("bspline_weight", "bspline_grad", "bspline_hess"):
            ref = getattr(jspl, name)(jnp.asarray(x), order)
            out = getattr(tspl, name)(torch.as_tensor(x), order)
            assert_close(out, ref)
    # beta_p sums to 1 over the integer shifts (partition of unity)
    xs = torch.as_tensor(x % 1)[:, None] + torch.arange(-4, 5)
    assert torch.allclose(tspl.bspline_weight(xs, 3).sum(-1),
                          torch.ones(len(x), dtype=torch.float64))


def test_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_scattered", os.path.join(ROOT, "examples",
                                        "torch_scattered.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    moved = ex.main("cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("sampled: (1, 1, 1, 1, 20000) mean")
    assert lines[1].startswith("d(sum)/d(points): (20000, 3) |g| mean")
    assert [ln.split(":")[0] for ln in lines[2:]] == [
        "iter 0", "iter 1", "iter 2"]
    assert moved.shape == (512, 3) and torch.isfinite(moved).all()
