"""Distributed spline prefiltering.

PyTorch port of ``interpol_tpu/parallel/coeff.py``.  The filter along one
axis is independent per line, so for a volume sharded along one spatial
axis the sweeps along the other axes run locally, and the sweep along the
sharded ("home") axis runs after moving the sharding to another spatial
axis: ``redistribute(Shard(home) -> Shard(alt))``, an all-to-all, then
back.  With one spatial axis the array is replicated for that sweep.  The
filter itself is the port's ``ops/coeff.py`` (float64 products).
"""
from __future__ import annotations

from typing import Sequence

from torch.distributed.tensor import DTensor, Shard

from ..ops.coeff import spline_coeff
from .spatial import as_dtensor, placements

__all__ = ["spline_coeff_nd_sharded"]


def spline_coeff_nd_sharded(inp, orders: Sequence[int],
                            bounds: Sequence[int], ndim: int, *, mesh,
                            axis_name: str = "x",
                            sharded_axis: int = 0) -> DTensor:
    """Prefilter the last ``ndim`` axes of ``inp`` while it is sharded
    along spatial axis ``sharded_axis`` over ``mesh[axis_name]``.  Returns
    the filtered array with that sharding."""
    D = ndim
    lead = inp.ndim - D
    home = lead + sharded_axis
    alt = next((lead + i for i in range(D) if i != sharded_axis), None)

    def spec(dim):
        return placements(mesh, {axis_name: None if dim is None
                                 else Shard(dim)})

    out = as_dtensor(inp, mesh, spec(home))
    for d in range(D):
        axis = lead + d
        if axis == home:
            out = out.redistribute(mesh, spec(alt))
        loc = spline_coeff(out.to_local(), orders[d], bounds[d], axis=axis)
        out = DTensor.from_local(loc, mesh, out.placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
        if axis == home:
            out = out.redistribute(mesh, spec(home))
    return out
