"""The multi-device layer of the PyTorch port (``interpol_tpu_torch/
parallel/``, ``interpol_tpu_torch/entry.py``) against the JAX package's
(``interpol_tpu/parallel/``) on the same mesh shapes.

One module-scoped spawn of four gloo ranks on the CPU
(``tests/_torch_ranks.py``, which imports no JAX) runs every function of
the port's layer in float64 on a 4-rank 'x' mesh, a 2 x 2 ('data', 'x')
mesh (its 'x' dimension a 2-rank ring; with and without the batch sharded
over 'data'), a 4-rank 'data' mesh, and the dry run
``dryrun_multichip(4)``; rank 0 sends the full results back.  Here the same
inputs go through the JAX functions on meshes of the same shapes (the
virtual CPU devices of ``tests/conftest.py``), held at the JAX tests'
tolerances (``tests/test_sharding.py``): 1e-11 for the spatial ops, 1e-12
for the batch and point ops, 1e-10 for gradients.

The spawn takes a few seconds; every collective has a 60 s timeout, the
parent waits at most 300 s for the ranks and kills any left.
"""
import multiprocessing
import socket
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from interpol_tpu.parallel import batch as jdp
from interpol_tpu.parallel import points as jps
from interpol_tpu.parallel import spatial as jsp

import _torch_ranks as R

ATOL, ATOL_PTS, ATOL_GRAD = 1e-11, 1e-12, 1e-10


@pytest.fixture(scope="module")
def ranks():
    """The results of :func:`_torch_ranks.run_all` from four gloo ranks."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=R.rank_main, args=(r, port, queue),
                         daemon=True) for r in range(R.WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    try:
        got = [queue.get(timeout=max(1.0, deadline - time.monotonic()))
               for _ in procs]
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    errors = [msg for _, status, msg in got if status != "ok"]
    assert not errors, errors[0]
    return next(out for rank, _, out in got if rank == 0)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < R.WORLD:
        pytest.skip(f"needs {R.WORLD} JAX devices")
    return {"x4": _mesh((4,), ("x",)), "x2": _mesh((2,), ("x",)),
            "dx22": _mesh((2, 2), ("data", "x")),
            "data4": _mesh((4,), ("data",))}


def J(fn, n, *args, **kw):
    """``fn(*args, **kw)`` under ``jax.jit``, the first ``n`` arguments
    traced (an eager ``shard_map`` runs op by op, far slower)."""
    return jax.jit(lambda *a: fn(*a, *args[n:], **kw))(*args[:n])


def _close(out, ref, atol):
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("tag", ["x4", "x2"])
def test_pull_sharded_matches_jax(ranks, meshes, tag):
    for order, bound in R.PULL_CASES:
        inp, grid = R.spatial_case()
        o, b = (order,) * 2, (bound,) * 2
        ref = J(jsp.pull_sharded, 2, jnp.asarray(inp), jnp.asarray(grid),
                o, b, 1, mesh=meshes[tag], max_disp=1.5)
        _close(ranks[f"{tag}/pull/{order}/{bound}"], ref, ATOL)
    assert ranks[f"{tag}/halo_raises"]


@pytest.mark.parametrize("tag", ["x4", "x2"])
def test_push_count_sharded_match_jax(ranks, meshes, tag):
    for order, bound in R.PUSH_CASES:
        inp, grid = R.spatial_case(1)
        o, b = (order,) * 2, (bound,) * 2
        ref = J(jsp.push_sharded, 2, jnp.asarray(inp), jnp.asarray(grid),
                inp.shape[2:], o, b, 1, mesh=meshes[tag], max_disp=1.5)
        _close(ranks[f"{tag}/push/{order}/{bound}"], ref, ATOL)
    _, grid = R.spatial_case(2)
    ref = J(jsp.count_sharded, 1, jnp.asarray(grid), (32, 6), (3, 3),
            (3, 3), 1, mesh=meshes[tag], max_disp=1.5)
    _close(ranks[f"{tag}/count"], ref, ATOL)


@pytest.mark.parametrize("tag", ["x4", "x2"])
def test_grad_sharded_and_extrapolate_match_jax(ranks, meshes, tag):
    inp, grid = R.spatial_case(3)
    ref = J(jsp.grad_sharded, 2, jnp.asarray(inp), jnp.asarray(grid), (3, 3),
            (3, 3), 1, mesh=meshes[tag], max_disp=1.5)
    _close(ranks[f"{tag}/grad"], ref, ATOL)
    # extrapolate 0 takes the gather path (global extents)
    inp, grid = R.spatial_case(4)
    ref = J(jsp.pull_sharded, 2, jnp.asarray(inp), jnp.asarray(grid), (3, 3),
            (3, 3), 0, mesh=meshes[tag], max_disp=1.5)
    _close(ranks[f"{tag}/pull_ex0"], ref, ATOL)


@pytest.mark.parametrize("tag", ["x4", "x2"])
def test_window_and_gather_paths_match_jax(ranks, meshes, tag):
    # the window path (edge-rank halo correction, the push's signed folds)
    # and the gather path (global folding), each held to JAX's same path
    for bound in R.WINDOW_PULL_BOUNDS:
        inp, grid = R.spatial_case(2)
        for w in (True, False):
            ref = J(jsp.pull_sharded, 2, jnp.asarray(inp), jnp.asarray(grid),
                    (3, 3), (bound,) * 2, 1, mesh=meshes[tag],
                    max_disp=1.5, use_window=w)
            _close(ranks[f"{tag}/pullw/{bound}/{w}"], ref, ATOL)
    for bound in R.WINDOW_PUSH_BOUNDS:
        inp, grid = R.spatial_case(3)
        for w in (True, False):
            ref = J(jsp.push_sharded, 2, jnp.asarray(inp), jnp.asarray(grid),
                    (32, 6), (3, 3), (bound,) * 2, 1, mesh=meshes[tag],
                    max_disp=1.5, use_window=w)
            _close(ranks[f"{tag}/pushw/{bound}/{w}"], ref, ATOL)


@pytest.mark.parametrize("tag", ["x4", "x2"])
def test_pull_sharded_gradients_match_jax(ranks, meshes, tag):
    inp, grid = R.spatial_case(5)

    def loss(v, g):
        return (jsp.pull_sharded(v, g, (3, 3), (6, 6), 1, mesh=meshes[tag],
                                 max_disp=1.5) ** 2).sum()
    gv, gg = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(inp),
                                                      jnp.asarray(grid))
    _close(ranks[f"{tag}/dpull_inp"], gv, ATOL_GRAD)
    _close(ranks[f"{tag}/dpull_grid"], gg, ATOL_GRAD)


def test_batch_and_slab_sharded_2d_mesh_match_jax(ranks, meshes):
    # batch over 'data' x slab over 'x' (the dry run's layout)
    inp, grid = R.spatial_case(6)
    for w in (True, False):
        kw = dict(mesh=meshes["dx22"], max_disp=1.5, batch_axis="data",
                  use_window=w)
        ref = J(jsp.pull_sharded, 2, jnp.asarray(inp), jnp.asarray(grid),
                (3, 3), (3, 3), 1, **kw)
        _close(ranks[f"dx22/pull_b/{w}"], ref, ATOL)
        ref = J(jsp.push_sharded, 2, jnp.asarray(inp), jnp.asarray(grid),
                (32, 6), (3, 3), (3, 3), 1, **kw)
        _close(ranks[f"dx22/push_b/{w}"], ref, ATOL)


def test_batch_dp_matches_jax(ranks, meshes):
    m = meshes["data4"]
    inp, grid, _ = R.batch_case(0)
    _close(ranks["dp/pull"], J(jdp.pull_dp, 2, jnp.asarray(inp),
                               jnp.asarray(grid), (3, 3), (3, 3), 1, mesh=m),
           ATOL_PTS)
    _, grid, inp = R.batch_case(1)
    o, b = (2, 2), (6, 6)
    g = jnp.asarray(grid)
    _close(ranks["dp/push"], J(jdp.push_dp, 2, jnp.asarray(inp), g, (6, 5),
                               o, b, 1, mesh=m), ATOL_PTS)
    _close(ranks["dp/count"], J(jdp.count_dp, 1, g, (6, 5), o, b, 1, mesh=m),
           ATOL_PTS)
    inp2 = np.random.default_rng(1).standard_normal((8, 2, 6, 5))
    _close(ranks["dp/grad"], J(jdp.grad_dp, 2, jnp.asarray(inp2), g, o, b, 1,
                               mesh=m), ATOL_PTS)


def test_point_sharding_matches_jax(ranks, meshes):
    m = meshes["data4"]
    inp, pts, _ = R.point_case(3)
    v, p = jnp.asarray(inp), jnp.asarray(pts)
    _close(ranks["pts/pull"], J(jps.pull_points, 2, v, p, (3, 3), (3, 3), 1,
                                mesh=m), ATOL_PTS)
    _close(ranks["pts/grad"], J(jps.grad_points, 2, v, p, (3, 3), (3, 3), 1,
                                mesh=m), ATOL_PTS)
    _, pts, vals = R.point_case(4)
    p = jnp.asarray(pts)
    _close(ranks["pts/push"], J(jps.push_points, 2, jnp.asarray(vals), p,
                                (7, 6), (2, 2), (6, 6), 1, mesh=m), ATOL_PTS)
    _close(ranks["pts/count"], J(jps.count_points, 1, p, (7, 6), (2, 2),
                                 (6, 6), 1, mesh=m), ATOL_PTS)


def test_point_sharded_loss_gradients_match_jax(ranks, meshes):
    inp, pts, _ = R.point_case(5)
    tgt = jnp.asarray(R.target(9, (2, 2, 24)))

    def loss(v, g):
        out = jps.pull_points(v, g, (3, 3), (3, 3), 1, mesh=meshes["data4"])
        return jnp.sum((out - tgt) ** 2)
    gv, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(inp),
                                                      jnp.asarray(pts))
    _close(ranks["pts/dloss_inp"], gv, ATOL_GRAD)
    _close(ranks["pts/dloss_pts"], gp, ATOL_GRAD)


@pytest.mark.parametrize("tag", ["x4", "dx22"])
def test_slab_points_match_jax(ranks, meshes, tag):
    kw = dict(mesh=meshes[tag], point_axis="data" if tag == "dx22" else None)
    o3 = (3,) * 3
    for bound in (3, 2):
        inp, pts, _ = R.slab_case(11)
        v, p = jnp.asarray(inp), jnp.asarray(pts)
        for ex in (0, 1):
            ref = J(jps.pull_points_slab, 2, v, p, o3, (bound,) * 3, ex, **kw)
            _close(ranks[f"{tag}/slab_pull/{bound}/{ex}"], ref, ATOL_PTS)
        ref = J(jps.grad_points_slab, 2, v, p, o3, (bound,) * 3, 1, **kw)
        _close(ranks[f"{tag}/slab_grad/{bound}"], ref, ATOL_PTS)
    _, pts, vals = R.slab_case(12)
    ref = J(jps.push_points_slab, 2, jnp.asarray(vals), jnp.asarray(pts),
            (16, 6, 5), o3, o3, 1, **kw)
    _close(ranks[f"{tag}/slab_push"], ref, ATOL_PTS)


@pytest.mark.parametrize("tag", ["x4", "dx22"])
def test_slab_points_loss_gradients_match_jax(ranks, meshes, tag):
    inp, pts, _ = R.slab_case(14)
    tgt = jnp.asarray(R.target(9, (2, 2, 48)))
    kw = dict(mesh=meshes[tag], point_axis="data" if tag == "dx22" else None)

    def loss(v, g):
        out = jps.pull_points_slab(v, g, (3,) * 3, (3,) * 3, 1, **kw)
        return jnp.sum((out - tgt) ** 2)
    gv, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(inp),
                                                      jnp.asarray(pts))
    _close(ranks[f"{tag}/slab_dloss_inp"], gv, ATOL_GRAD)
    _close(ranks[f"{tag}/slab_dloss_pts"], gp, ATOL_GRAD)


def test_coeff_sharded_matches_jax(ranks, meshes):
    from interpol_tpu.parallel.coeff import spline_coeff_nd_sharded
    m = meshes["x4"]
    x = jnp.asarray(R.coeff_case())
    shard = NamedSharding(m, P(None, "x"))
    f = jax.jit(lambda v: spline_coeff_nd_sharded(
        v, (3, 3, 3), (3, 3, 6), 3, mesh=m, axis_name="x", sharded_axis=0),
        out_shardings=shard)
    _close(ranks["coeff"], f(jax.device_put(x, shard)), ATOL)
    # the result keeps the input's sharding: dim 1 over 'x'
    assert str(ranks["coeff_placements"]) == "(Shard(dim=1),)"


def test_halo_width_matches_jax():
    from interpol_tpu_torch.parallel import halo_width
    for orders in [(1, 1), (3, 3, 3), (5, 2), (0,)]:
        for md in (0.0, 0.5, 1.5, 4.0):
            assert halo_width(orders, md) == jsp.halo_width(orders, md)


def test_dryrun_multichip_finite(ranks):
    # dryrun_multichip(4) on the four ranks: a 1 x 4 ('data', 'x') mesh
    assert np.isfinite(ranks["dryrun"])


def test_dryrun_multichip_spawns_its_ranks():
    # with no process group and no card: two gloo ranks in child
    # processes, which run the step on the group they set up (a 1 x 2
    # mesh) and return the same loss
    from interpol_tpu_torch import entry
    assert np.isfinite(entry.dryrun_multichip(2))
