"""Rank bodies of the PyTorch port's multi-device tests
(``tests/test_torch_parallel.py``), and the cases they share with it.

Imports no JAX: a spawned rank imports this module to unpickle its target.
The inputs are made from seeds with numpy on every rank (the same global
arrays everywhere), the results go back to the parent as numpy arrays.
"""
import datetime
import os
import traceback

import numpy as np

WORLD = 4
TIMEOUT = datetime.timedelta(seconds=60)


# ------------------------------------------------------------ cases

def spatial_case(seed=0, n=32, disp=1.5):
    """Volume (2, 2, n, 6) sharded along axis 0; grid = identity + bounded
    displacement (``tests/test_sharding.py::spatial_case``)."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((2, 2, n, 6))
    ident = np.stack(np.meshgrid(np.arange(n), np.arange(6),
                                 indexing="ij"), -1).astype(np.float64)
    grid = ident[None] + rng.uniform(-disp, disp, (2, n, 6, 2))
    return inp, grid


def point_case(seed, P=24, ish=(7, 6)):
    """``TestPointSharding._case``: a (2, 2, *ish) volume, (2, P, D) points
    in [-1, max(ish)), (2, 2, P) values."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((2, 2) + ish)
    pts = rng.uniform(-1, max(ish), (2, P, len(ish)))
    vals = rng.standard_normal((2, 2, P))
    return inp, pts, vals


def slab_case(seed, P=48, ish=(16, 6, 5)):
    """``TestSlabPointSharding._case``: in-volume points and four per batch
    outside."""
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((2, 2) + ish)
    pts = rng.uniform(0, np.asarray(ish) - 1, (2, P, len(ish)))
    pts[:, :4] = rng.uniform(-2, np.asarray(ish) + 1, (2, 4, len(ish)))
    vals = rng.standard_normal((2, 2, P))
    return inp, pts, vals


def batch_case(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 2, 6, 5)),
            rng.uniform(-1, 6, (8, 4, 3, 2)),
            rng.standard_normal((8, 2, 4, 3)))


def coeff_case():
    return np.random.default_rng(7).standard_normal((2, 16, 12, 8))


def target(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


# (order, bound) of the spatial pulls and pushes, as tests/test_sharding.py
PULL_CASES = [(1, 3), (3, 6), (3, 0), (2, 5), (5, 2)]
PUSH_CASES = [(1, 3), (3, 6), (2, 0)]
WINDOW_PULL_BOUNDS = [0, 2, 3, 5, 6]
WINDOW_PUSH_BOUNDS = [1, 3, 6]
# the meshes: name -> (shape, dimension names)
MESHES = {"x4": ((4,), ("x",)), "x2": ((2, 2), ("data", "x")),
          "data4": ((4,), ("data",))}


# ------------------------------------------------------------ the ranks

def _np(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def _spatial(par, mesh, tag, out):
    """Every slab-sharded op of ``parallel/spatial.py`` on ``mesh``'s 'x'
    dimension (the 'data' dimension, where there is one, replicates)."""
    import torch
    sp = par.spatial
    T = torch.tensor
    kw = dict(mesh=mesh, max_disp=1.5)
    for order, bound in PULL_CASES:
        inp, grid = spatial_case()
        o, b = (order,) * 2, (bound,) * 2
        out[f"{tag}/pull/{order}/{bound}"] = _np(
            sp.pull_sharded(T(inp), T(grid), o, b, 1, **kw))
    for order, bound in PUSH_CASES:
        inp, grid = spatial_case(1)
        o, b = (order,) * 2, (bound,) * 2
        out[f"{tag}/push/{order}/{bound}"] = _np(sp.push_sharded(
            T(inp), T(grid), inp.shape[2:], o, b, 1, **kw))
    _, grid = spatial_case(2)
    out[f"{tag}/count"] = _np(sp.count_sharded(
        T(grid), (32, 6), (3, 3), (3, 3), 1, **kw))
    inp, grid = spatial_case(3)
    out[f"{tag}/grad"] = _np(sp.grad_sharded(
        T(inp), T(grid), (3, 3), (3, 3), 1, **kw))
    for bound in WINDOW_PULL_BOUNDS:
        inp, grid = spatial_case(2)
        for w in (True, False):
            out[f"{tag}/pullw/{bound}/{w}"] = _np(sp.pull_sharded(
                T(inp), T(grid), (3, 3), (bound,) * 2, 1, use_window=w,
                **kw))
    for bound in WINDOW_PUSH_BOUNDS:
        inp, grid = spatial_case(3)
        for w in (True, False):
            out[f"{tag}/pushw/{bound}/{w}"] = _np(sp.push_sharded(
                T(inp), T(grid), (32, 6), (3, 3), (bound,) * 2, 1,
                use_window=w, **kw))
    inp, grid = spatial_case(4)
    out[f"{tag}/pull_ex0"] = _np(sp.pull_sharded(
        T(inp), T(grid), (3, 3), (3, 3), 0, **kw))
    # the gradient of sum(pull_sharded ** 2) in the volume and the grid
    inp, grid = spatial_case(5)
    v, g = T(inp).requires_grad_(), T(grid).requires_grad_()
    loss = (sp.pull_sharded(v, g, (3, 3), (6, 6), 1, **kw).full_tensor()
            ** 2).sum()
    gv, gg = torch.autograd.grad(loss, [v, g])
    out[f"{tag}/dpull_inp"], out[f"{tag}/dpull_grid"] = _np(gv), _np(gg)
    try:
        inp, grid = spatial_case()
        sp.pull_sharded(T(inp), T(grid), (3, 3), (3, 3), 1, mesh=mesh,
                        halo=100)
        out[f"{tag}/halo_raises"] = np.array(False)
    except ValueError:
        out[f"{tag}/halo_raises"] = np.array(True)


def _batched(par, mesh, out):
    """On the 2 x 2 mesh: the window and gather paths with the batch
    sharded over 'data' and the slab over 'x'."""
    import torch
    T = torch.tensor
    inp, grid = spatial_case(6)
    for w in (True, False):
        kw = dict(mesh=mesh, max_disp=1.5, batch_axis="data", use_window=w)
        out[f"dx22/pull_b/{w}"] = _np(par.spatial.pull_sharded(
            T(inp), T(grid), (3, 3), (3, 3), 1, **kw))
        out[f"dx22/push_b/{w}"] = _np(par.spatial.push_sharded(
            T(inp), T(grid), (32, 6), (3, 3), (3, 3), 1, **kw))


def _batch_dp(par, mesh, out):
    import torch
    T = torch.tensor
    inp, grid, inp2 = batch_case(0)
    out["dp/pull"] = _np(par.pull_dp(T(inp), T(grid), (3, 3), (3, 3), 1,
                                     mesh=mesh))
    _, grid, inp = batch_case(1)
    o, b = (2, 2), (6, 6)
    out["dp/push"] = _np(par.push_dp(T(inp), T(grid), (6, 5), o, b, 1,
                                     mesh=mesh))
    out["dp/count"] = _np(par.count_dp(T(grid), (6, 5), o, b, 1, mesh=mesh))
    inp2 = np.random.default_rng(1).standard_normal((8, 2, 6, 5))
    out["dp/grad"] = _np(par.grad_dp(T(inp2), T(grid), o, b, 1, mesh=mesh))


def _points(par, mesh, out):
    import torch
    ps, T = par.points, torch.tensor
    inp, pts, _ = point_case(3)
    out["pts/pull"] = _np(ps.pull_points(T(inp), T(pts), (3, 3), (3, 3), 1,
                                         mesh=mesh))
    out["pts/grad"] = _np(ps.grad_points(T(inp), T(pts), (3, 3), (3, 3), 1,
                                         mesh=mesh))
    _, pts, vals = point_case(4)
    out["pts/push"] = _np(ps.push_points(T(vals), T(pts), (7, 6), (2, 2),
                                         (6, 6), 1, mesh=mesh))
    out["pts/count"] = _np(ps.count_points(T(pts), (7, 6), (2, 2), (6, 6),
                                           1, mesh=mesh))
    inp, pts, _ = point_case(5)
    v, g = T(inp).requires_grad_(), T(pts).requires_grad_()
    loss = ((ps.pull_points(v, g, (3, 3), (3, 3), 1, mesh=mesh)
             .full_tensor() - T(target(9, (2, 2, 24)))) ** 2).sum()
    gv, gg = torch.autograd.grad(loss, [v, g])
    out["pts/dloss_inp"], out["pts/dloss_pts"] = _np(gv), _np(gg)


def _slab(par, mesh, tag, out, point_axis=None):
    import torch
    ps, T = par.points, torch.tensor
    kw = dict(mesh=mesh, point_axis=point_axis)
    o3 = (3,) * 3
    for bound in (3, 2):
        inp, pts, _ = slab_case(11)
        for ex in (0, 1):
            out[f"{tag}/slab_pull/{bound}/{ex}"] = _np(ps.pull_points_slab(
                T(inp), T(pts), o3, (bound,) * 3, ex, **kw))
        out[f"{tag}/slab_grad/{bound}"] = _np(ps.grad_points_slab(
            T(inp), T(pts), o3, (bound,) * 3, 1, **kw))
    _, pts, vals = slab_case(12)
    out[f"{tag}/slab_push"] = _np(ps.push_points_slab(
        T(vals), T(pts), (16, 6, 5), o3, o3, 1, **kw))
    inp, pts, _ = slab_case(14)
    v, g = T(inp).requires_grad_(), T(pts).requires_grad_()
    loss = ((ps.pull_points_slab(v, g, o3, o3, 1, **kw).full_tensor()
             - T(target(9, (2, 2, 48)))) ** 2).sum()
    gv, gg = torch.autograd.grad(loss, [v, g])
    out[f"{tag}/slab_dloss_inp"], out[f"{tag}/slab_dloss_pts"] = (
        _np(gv), _np(gg))


def run_all(out):
    """Every function of ``interpol_tpu_torch.parallel`` on the meshes of
    :data:`MESHES` and the 2 x 2 ('data', 'x') mesh, float64; then
    ``dryrun_multichip`` on all the ranks (float32)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from interpol_tpu_torch import entry
    from interpol_tpu_torch import parallel as par

    meshes = {name: init_device_mesh("cpu", shape, mesh_dim_names=names)
              for name, (shape, names) in MESHES.items()}
    _spatial(par, meshes["x4"], "x4", out)
    _spatial(par, meshes["x2"], "x2", out)
    _batched(par, meshes["x2"], out)
    _batch_dp(par, meshes["data4"], out)
    _points(par, meshes["data4"], out)
    _slab(par, meshes["x4"], "x4", out)
    _slab(par, meshes["x2"], "dx22", out, point_axis="data")
    x = torch.tensor(coeff_case())
    out["coeff"] = _np(par.spline_coeff_nd_sharded(
        x, (3, 3, 3), (3, 3, 6), 3, mesh=meshes["x4"], axis_name="x"))
    y = par.spline_coeff_nd_sharded(x, (3, 3, 3), (3, 3, 6), 3,
                                    mesh=meshes["x4"], axis_name="x")
    out["coeff_placements"] = np.array(str(y.placements))
    out["dryrun"] = np.array(entry.dryrun_multichip(WORLD))


def rank_main(rank, port, queue):
    """One gloo rank: run :func:`run_all`, send rank 0's results (the
    others send only their status) to the parent."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["_INTERPOL_TORCH_DRYRUN_CHILD"] = "1"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    try:
        out = {}
        run_all(out)
        queue.put((rank, "ok", out if rank == 0 else None))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()
