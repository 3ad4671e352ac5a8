"""Entry points of the PyTorch port: a one-device forward and a
multi-device dry run.  The counterpart of the JAX package's
``__graft_entry__.py``.

    python -m interpol_tpu_torch.entry [N_DEVICES]

runs :func:`entry` on the card and :func:`dryrun_multichip` on
``N_DEVICES`` ranks (4 by default).
"""
from __future__ import annotations

import datetime
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

_CHILD = "_INTERPOL_TORCH_DRYRUN_CHILD"
TIMEOUT = datetime.timedelta(seconds=60)


def entry(device="cuda"):
    """The forward of the flagship registration warp, a 32^3 ``WarpModel``
    (coarse 8^3, cubic, dct2).  Returns ``(fn, example_args)``:
    ``fn(params, moving)`` -> the warped volume."""
    from .models import WarpModel

    model = WarpModel(vol_shape=(32, 32, 32), coarse_shape=(8, 8, 8),
                      interpolation=3, bound="dct2", device=device)
    rng = np.random.default_rng(0)
    moving = torch.tensor(rng.standard_normal((1, 1) + model.vol_shape),
                          dtype=torch.float32, device=device)

    def fn(params, moving):
        return model.warp(moving, params)

    return fn, (model.params.detach(), moving)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _step(n_devices: int, device: str) -> float:
    """One training step of a ``WarpModel`` on a ``('data', 'x')`` mesh of
    ``n_devices`` ranks (the process group is up): batch data parallelism
    times the slab sharding of the volumes, the warp through
    ``pull_sharded`` (the ring halo exchange over 'x').  Returns the loss,
    checked finite."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from .models import WarpModel
    from .parallel import spatial as sp

    dx = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    dd = n_devices // dx
    mesh = init_device_mesh(device.split(":")[0], (dd, dx),
                            mesh_dim_names=("data", "x"))
    vol = (16, 8, 8)
    model = WarpModel(vol_shape=vol, coarse_shape=(4, 4, 4),
                      interpolation=1, bound="dct2", device=device)
    B, C, max_disp = dd * 2, 1, 0.9
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=device)
    params = torch.tensor(0.01 * rng.standard_normal((B, 4, 4, 4, 3)),
                          **f32).requires_grad_()
    moving = torch.tensor(rng.standard_normal((B, C) + vol), **f32)
    fixed = torch.tensor(rng.standard_normal((B, C) + vol), **f32)
    places = sp.placements(mesh, {"data": Shard(0), "x": Shard(2)})
    moving = sp.as_dtensor(moving, mesh, places)
    fixed = sp.as_dtensor(fixed, mesh, places)

    flow = model.dense_flow(params)     # (B, *vol, 3), on every rank
    warped = sp.pull_sharded(moving, flow, (1,) * 3, (3,) * 3, 1, mesh=mesh,
                             axis_name="x", max_disp=max_disp,
                             batch_axis="data")
    loss = ((warped - fixed) ** 2).mean().full_tensor()
    (g,) = torch.autograd.grad(loss, [params])
    with torch.no_grad():
        new = params - 0.1 * g
    value = float(loss.detach())
    if not (np.isfinite(value) and torch.isfinite(new).all()):
        raise AssertionError(f"non-finite loss or step: {value}")
    return value


def _rank(rank, n_devices, port, backend, queue):
    """One rank of the spawned dry run (a child process)."""
    import torch.distributed as dist
    os.environ[_CHILD] = "1"
    device = f"cuda:{rank}" if backend == "nccl" else "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n_devices,
                            timeout=TIMEOUT)
    try:
        queue.put((rank, _step(n_devices, device)))
    except BaseException as e:
        queue.put((rank, repr(e)))
        raise
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> float:
    """One distributed training step on an ``n_devices`` mesh, axes
    ``('data', 'x')``: batch data parallelism times the spatial slab
    sharding of the volumes, the warp through ``pull_sharded``.  Tiny
    shapes; the loss must be finite.  Returns it.

    Where a process group of ``n_devices`` ranks is up, this rank runs its
    share of the step.  Otherwise one card runs it alone (``n_devices``
    1: a one-rank NCCL group on a file store), and more ranks than cards
    run as ``n_devices`` gloo ranks on the CPU in child processes (NCCL
    ranks, one per card, where the host has that many), the counterpart of
    the JAX package's virtual CPU mesh.  A child that finds no group fails
    rather than spawning again."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the process group has "
                             f"{dist.get_world_size()} ranks, not "
                             f"{n_devices}")
        device = "cpu" if dist.get_backend() == "gloo" else \
            f"cuda:{torch.cuda.current_device()}"
        loss = _step(n_devices, device)
    elif os.environ.get(_CHILD):
        raise RuntimeError("dry-run child without a process group")
    elif n_devices == 1 and torch.cuda.is_available():
        with tempfile.TemporaryDirectory() as tmp:
            store = dist.FileStore(os.path.join(tmp, "store"), 1)
            dist.init_process_group("nccl", store=store, rank=0,
                                    world_size=1, timeout=TIMEOUT)
            try:
                loss = _step(1, f"cuda:{torch.cuda.current_device()}")
            finally:
                dist.destroy_process_group()
    else:
        loss = _spawn(n_devices)
    print(f"dryrun_multichip({n_devices}): loss={loss:.6f} OK", flush=True)
    return loss


def _spawn(n_devices: int) -> float:
    import torch.multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= n_devices else "gloo"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, n_devices, port, backend,
                                             queue), daemon=True)
             for r in range(n_devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    try:
        out = dict(queue.get(timeout=max(1.0, deadline - time.monotonic()))
                   for _ in procs)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    losses = set(out.values())
    if len(losses) != 1 or not isinstance(out[0], float):
        raise RuntimeError(f"dry-run ranks disagree or failed: {out}")
    return out[0]


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry:", tuple(out.shape), out.dtype)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
