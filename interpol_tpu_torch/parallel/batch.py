"""Batch data parallelism: the leading batch axis sharded over one mesh
dimension.

PyTorch port of ``interpol_tpu/parallel/batch.py``.  Every (batch,
channel) slice of pull / push / count / grad is independent, so batch
parallelism needs no collective: each rank runs the single-device op of
``ops/pushpull.py`` on its shard (on the card, kernels 3 and 4:
``csrc/gather.cu``, ``csrc/splat.cu``), and the result is that shard of a
``DTensor`` sharded along dim 0.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

from torch.distributed.tensor import DTensor, Shard

from ..ops import pushpull as _pp
from .spatial import as_dtensor, placements

__all__ = ["pull_dp", "push_dp", "count_dp", "grad_dp", "batch_sharded"]


def batch_sharded(fn, mesh, axis_name: str, n_arrays: int):
    """``fn`` of ``n_arrays`` batch-leading arrays, run per rank on their
    shards along dim 0 over ``mesh[axis_name]`` (the batch must divide the
    dimension's size); returns a DTensor sharded likewise."""
    places = placements(mesh, {axis_name: Shard(0)})

    def run(*arrays):
        if len(arrays) != n_arrays:
            raise ValueError(f"expected {n_arrays} arrays, got {len(arrays)}")
        size = mesh.size(mesh.mesh_dim_names.index(axis_name))
        if arrays[0].shape[0] % size:
            raise ValueError(f"batch ({arrays[0].shape[0]}) must divide "
                             f"the mesh axis ({size})")
        loc = [as_dtensor(a, mesh, places).to_local() for a in arrays]
        return DTensor.from_local(fn(*loc), mesh, places, run_check=False)
    return run


def pull_dp(inp, grid, orders, bounds, extrapolate, *, mesh,
            axis_name: str = "data") -> DTensor:
    """Batch-sharded grid_pull: (B, C, *ish) x (B, *osh, D) -> (B, C, *osh)
    with B sharded over ``axis_name``."""
    f = partial(_pp.pull, orders=orders, bounds=bounds,
                extrapolate=extrapolate)
    return batch_sharded(f, mesh, axis_name, 2)(inp, grid)


def push_dp(inp, grid, oshape: Tuple[int, ...], orders, bounds,
            extrapolate, *, mesh, axis_name: str = "data") -> DTensor:
    """Batch-sharded grid_push."""
    f = partial(_pp.push, oshape=tuple(oshape), orders=orders,
                bounds=bounds, extrapolate=extrapolate)
    return batch_sharded(f, mesh, axis_name, 2)(inp, grid)


def count_dp(grid, oshape: Tuple[int, ...], orders, bounds, extrapolate, *,
             mesh, axis_name: str = "data") -> DTensor:
    """Batch-sharded grid_count."""
    f = partial(_pp.count, oshape=tuple(oshape), orders=orders,
                bounds=bounds, extrapolate=extrapolate)
    return batch_sharded(f, mesh, axis_name, 1)(grid)


def grad_dp(inp, grid, orders, bounds, extrapolate, *, mesh,
            axis_name: str = "data") -> DTensor:
    """Batch-sharded grid_grad."""
    f = partial(_pp.grad, orders=orders, bounds=bounds,
                extrapolate=extrapolate)
    return batch_sharded(f, mesh, axis_name, 2)(inp, grid)
