"""The generic push/pull path of the PyTorch port against the JAX package,
float64 on the CPU at ``atol=1e-10 * max(1, max|ref|)``.

The plain cores (``ops/ndkernels.py``) are held to
``interpol_tpu.ops.ndkernels``; ``grid_pull`` / ``grid_grad`` /
``grid_push`` / ``grid_count`` without ``max_disp`` to the JAX API; each
Function of ``ops/pushpull.py`` to ``jax.vjp`` of
``interpol_tpu.ops.pushpull``, and second derivatives to ``jax.grad``.  On
the CPU the JAX package runs its XLA cores here (its scattered tier is for
the TPU).  The CUDA kernels are held to these plain versions in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import interpol_tpu as itp
import interpol_tpu_torch as itt
from interpol_tpu.ops import ndkernels as jnd
from interpol_tpu.ops import pushpull as jpp
from interpol_tpu_torch.ops import ndkernels as tnd
from interpol_tpu_torch.ops import pushpull as tpp
from interpol_tpu_torch.ops import scattered

ATOL = 1e-10   # float64 on both sides; only the summation order differs


def assert_close(out, ref):
    ref = np.asarray(ref)
    atol = ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(out.detach()), ref, rtol=0,
                               atol=atol)


def cloud(ish, oshape, B=2, C=2, seed=0):
    """Volume (B, C, *ish) and points (B, *oshape, D) uniform over
    [-1.5, n + 0.5] per axis: some outside the volume on each side."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((B, C) + tuple(ish))
    lo = -1.5
    hi = np.asarray(ish, float) + 0.5
    grid = lo + (hi - lo) * rng.uniform(size=(B,) + tuple(oshape)
                                        + (len(ish),))
    return inp, grid


# orders, bounds, extrapolate, ishape, oshape (of the points)
CASES = [
    ((3, 2, 1), (3, 0, 6), 1, (5, 6, 7), (3, 4, 2)),      # dct2 zero dft
    ((1, 3), (4, 3), 0, (6, 5), (4, 6)),                  # dst1 dct2
    ((2,), (6,), 2, (9,), (11,)),                         # dft, 'hist'
    ((0, 5, 3), (4, 6, 0), 2, (4, 5, 6), (2, 3, 3)),      # order 0 and 5
]
CORES = ["push", "count", "pushgrad", "hess", "pushhess"]


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("orders,bounds,ex,ish,osh", CASES)
def test_plain_cores_match_jax(core, orders, bounds, ex, ish, osh):
    inp, grid = cloud(ish, osh, B=1)
    D = len(ish)
    g = grid.reshape(1, -1, D)
    rng = np.random.default_rng(1)
    P = g.shape[1]
    jg = jnp.asarray(g[0])
    tg = torch.as_tensor(g)
    if core == "push":
        v = rng.standard_normal((1, 2, P))
        ref = jnd.push_core(jnp.asarray(v[0]), jg, ish, orders, bounds, ex)
        out = tnd.push_core(torch.as_tensor(v), tg, ish, orders, bounds, ex)
    elif core == "count":
        ref = jnd.count_core(jg, ish, orders, bounds, ex)
        out = tnd.count_core(tg, ish, orders, bounds, ex)
    elif core == "pushgrad":
        v = rng.standard_normal((1, 2, P, D))
        ref = jnd.pushgrad_core(jnp.asarray(v[0]), jg, ish, orders, bounds,
                                ex)
        out = tnd.pushgrad_core(torch.as_tensor(v), tg, ish, orders,
                                bounds, ex)
    elif core == "hess":
        ref = jnd.hess_core(jnp.asarray(inp[0]), jg, orders, bounds, ex)
        out = tnd.hess_core(torch.as_tensor(inp), tg, orders, bounds, ex)
    else:
        # pushhess: the adjoint of hess_core in the image, by jax.vjp
        ct = rng.standard_normal((1, 2, P, D, D))
        _, vjp = jax.vjp(lambda a: jnd.hess_core(a, jg, orders, bounds, ex),
                         jnp.asarray(inp[0]))
        (ref,) = vjp(jnp.asarray(ct[0]))
        out = tnd.pushhess_core(torch.as_tensor(ct), tg, ish, orders,
                                bounds, ex)
    assert_close(out[0], ref)


@pytest.mark.parametrize("fn", ["grid_pull", "grid_grad", "grid_push",
                                "grid_count"])
@pytest.mark.parametrize("orders,bounds,ex,ish,osh", CASES[:3])
def test_api_generic_path_matches_jax(fn, orders, bounds, ex, ish, osh):
    inp, grid = cloud(ish, osh, seed=2)
    kw = dict(interpolation=list(orders),
              bound=[("zero", "replicate", "dct1", "dct2", "dst1", "dst2",
                      "dft")[b] for b in bounds], extrapolate=ex)
    if fn in ("grid_pull", "grid_grad"):
        args = (inp, grid)
    elif fn == "grid_push":
        vals = np.random.default_rng(3).standard_normal((2, 2) + osh)
        args, kw = (vals, grid), dict(kw, shape=ish)
    else:
        args, kw = (grid,), dict(kw, shape=ish)
    ref = getattr(itp, fn)(*map(jnp.asarray, args), **kw)
    out = getattr(itt, fn)(*map(torch.as_tensor, args), **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    assert_close(out, ref)


# one 2-D configuration for every Function (JAX compiles per
# configuration): orders, bounds, extrapolate, ishape, oshape
VJP_CASE = ((3, 2), (0, 4), 2, (7, 9), (3, 5))


def _vjp_inputs(op):
    orders, bounds, ex, ish, osh = VJP_CASE
    D = len(ish)
    inp, grid = cloud(ish, osh, seed=4)
    rng = np.random.default_rng(5)
    if op in ("push", "pushgrad"):
        inp = rng.standard_normal((2, 2) + osh + ((D,) if op == "pushgrad"
                                                  else ()))
    shape_out = {"pull": (2, 2) + osh, "grad": (2, 2) + osh + (D,),
                 "hess": (2, 2) + osh + (D, D), "push": (2, 2) + ish,
                 "pushgrad": (2, 2) + ish, "count": (2, 1) + ish}[op]
    return inp, grid, rng.standard_normal(shape_out)


def _ops(lib, op):
    orders, bounds, ex, ish, _ = VJP_CASE
    if op in ("pull", "grad", "hess"):
        return lambda a, g: getattr(lib, op)(a, g, orders, bounds, ex)
    if op == "count":
        return lambda g: lib.count(g, ish, orders, bounds, ex)
    return lambda a, g: getattr(lib, op)(a, g, ish, orders, bounds, ex)


@pytest.mark.parametrize("op", ["pull", "push", "count", "grad", "pushgrad",
                                "hess"])
def test_function_backward_matches_jax_vjp(op):
    inp, grid, ct = _vjp_inputs(op)
    args = (grid,) if op == "count" else (inp, grid)

    def ref(c, *a):   # one jit: a warm cache loads it whole
        out, vjp = jax.vjp(_ops(jpp, op), *a)
        return out, vjp(c)
    out, refs = jax.jit(ref)(jnp.asarray(ct), *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = _ops(tpp, op)(*targs)
    grads = torch.autograd.grad(tout, targs, torch.as_tensor(ct))
    assert_close(tout, out)
    for g, r in zip(grads, refs):
        assert_close(g, r)


@pytest.mark.parametrize("op", ["pull", "grad"])
def test_second_order_matches_jax(op):
    # d/d(inp, grid) of sum(d_inp) + sum(d_grid), the first derivatives of
    # sum(op(inp, grid)**2) built with create_graph=True
    inp, grid, _ = _vjp_inputs(op)
    f = _ops(jpp, op)

    def first_sum(a, g):
        da, dg = jax.grad(lambda a2, g2: jnp.sum(f(a2, g2) ** 2),
                          argnums=(0, 1))(a, g)
        return jnp.sum(da) + jnp.sum(dg)
    refs = jax.jit(jax.grad(first_sum, argnums=(0, 1)))(jnp.asarray(inp),
                                                       jnp.asarray(grid))
    ti = torch.tensor(inp, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    out = _ops(tpp, op)(ti, tg)
    da, dg = torch.autograd.grad(out.square().sum(), [ti, tg],
                                 create_graph=True)
    grads = torch.autograd.grad(da.sum() + dg.sum(), [ti, tg])
    for g, r in zip(grads, refs):
        assert_close(g, r)


def test_fused_forwards_when_the_grid_needs_grad():
    # the forward's extra planes (value+grad, grad+hess) ride the graph
    orders, bounds, ex, _, _ = VJP_CASE
    inp, grid, _ = _vjp_inputs("pull")
    ti = torch.as_tensor(inp)
    tg = torch.tensor(grid.reshape(2, -1, 2), requires_grad=True)
    opts = (orders, bounds, ex)

    def names():
        return [type(fn(ti, tg, opts).grad_fn).__name__
                for fn in (tpp._pull, tpp._grad)]
    assert names() == ["PullGradBackward", "GradHessBackward"]
    tg.requires_grad_(False)
    ti.requires_grad_()
    assert names() == ["PullBackward", "GradBackward"]


def test_box_schedule():
    # boxes in key order, each box's points in input order, then the
    # outliers of each batch, then the masked points
    rng = np.random.default_rng(6)
    shape3, box = (10, 7, 5), (4, 4, 4)
    g = torch.as_tensor(rng.uniform(-2, 11, (2, 60, 3)))
    keys, perm, seg, nb = scattered.box_schedule(g, shape3, box, 0)
    assert nb == (3, 2, 2)
    ntile = 12
    pts = g.reshape(-1, 3)[perm]
    inside = ((pts >= 0) & (pts <= torch.tensor(shape3) - 1.0)).all(-1)
    kept = ((pts > -0.05) & (pts < torch.tensor(shape3) - 0.95)).all(-1)
    for i in range(2 * ntile):
        sl = slice(int(seg[i]), int(seg[i + 1]))
        assert bool(inside[sl].all())
        b, t = divmod(i, ntile)
        cell = torch.floor(pts[sl]).long() // torch.tensor(box)
        tid = (cell[:, 0] * nb[1] + cell[:, 1]) * nb[2] + cell[:, 2]
        assert bool((tid == t).all())
        assert bool((perm[sl] // 60 == b).all())
        assert bool((perm[sl][1:] > perm[sl][:-1]).all())
    out = slice(int(seg[2 * ntile]), int(seg[2 * ntile + 2]))
    assert bool((kept[out] & ~inside[out]).all())
    assert not bool(kept[int(seg[2 * ntile + 2]):].any())
    assert int(seg[-1]) == 120


def test_lift3_and_margins():
    g = torch.rand(2, 5, 2)
    g3, shape3, orders3, bounds3 = scattered.lift3(g, (4, 6), (3, 1),
                                                   (6, 0))
    assert g3.shape == (2, 5, 3) and bool((g3[..., 2] == 0).all())
    assert (shape3, orders3, bounds3) == ((4, 6, 1), (3, 1, 0), (6, 0, 3))
    # every tap of a point anchored at floor(g) lies inside the margins
    t = torch.linspace(0, 0.999, 101, dtype=torch.float32)
    for order in range(8):
        lo, hi = scattered.splat_margins(order)
        for c in (0.0, 1.0, 117.0):
            g1 = c + t
            n0 = torch.round(g1) if order == 0 \
                else torch.floor(g1 - (order - 1) / 2)
            assert bool((n0 - c >= lo).all())
            assert bool((n0 + order - c <= hi).all())
