"""Point-parallel scattered sampling: the point axis sharded over ranks.

PyTorch port of ``interpol_tpu/parallel/points.py``.  With the volume
replicated, every point is independent:

  * :func:`pull_points` / :func:`grad_points` need no collective: each rank
    samples its own point shard with the single-device op (on the card,
    kernel 3, ``csrc/gather.cu``);
  * the splats :func:`push_points` / :func:`count_points` accumulate into
    the shared volume: each rank splats its shard into a private volume
    (kernel 4, ``csrc/splat.cu``) and one all-reduce merges them, the
    counterpart of ``psum``.  The all-reduce is DTensor's ``Partial ->
    Replicate`` redistribution, whose backward hands every rank the
    cotangent of the replicated output as it is (a loss computed alike on
    every rank then differentiates as on one device);
    ``torch.distributed.nn.functional.all_reduce`` sums the cotangents in
    its backward and would scale such gradients by the rank count.

A replicated input that each rank uses for its share of the points (the
volume of a pull, the points of a slab pull) has a gradient that is a
partial sum over the ranks (``spatial.local(..., partial_over=...)``).

Slab-sharded volumes (:func:`pull_points_slab`, :func:`grad_points_slab`,
:func:`push_points_slab`): the volume shards along its first spatial axis
over ``vol_axis`` with ring-exchanged halos, the points are replicated or
sharded over an orthogonal ``point_axis``.  Every rank evaluates its
points against its halo-extended slab on the global-folding plain cores
(``ops/ndkernels.py``; on every device, as the JAX package runs its jnp
cores), masks the points whose clipped axis-0 coordinate another slab
owns, and one all-reduce over ``vol_axis`` merges (each point has one
owner).  The taps of an owned point reach at most ``(order + 1) // 2 + 1``
rows past it, so the halo covers them.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..ops import ndkernels as nd
from ..ops import pushpull as _pp
from . import spatial as sp

__all__ = ["pull_points", "grad_points", "push_points", "count_points",
           "pull_points_slab", "grad_points_slab", "push_points_slab"]


def _merged(out, mesh, places, over):
    """``out`` as a partial sum over the mesh dimension ``over`` with the
    other dimensions as ``places``, all-reduced over ``over``."""
    names = mesh.mesh_dim_names
    part = [Partial() if names[i] == over else p
            for i, p in enumerate(places)]
    full = [Replicate() if names[i] == over else p
            for i, p in enumerate(places)]
    return DTensor.from_local(out, mesh, part, run_check=False).redistribute(
        mesh, full)


def _point_op(fn, inp, points, mesh, axis_name, out_dim):
    """A pull-family op on a replicated volume and points sharded along
    dim 1 over ``axis_name``: (B, C, P_loc, ...) sharded along ``out_dim``."""
    inp_d = sp.as_dtensor(inp, mesh, sp.placements(mesh, {}))
    pts_d = sp.as_dtensor(points, mesh,
                          sp.placements(mesh, {axis_name: Shard(1)}))
    out = fn(sp.local(inp_d, (axis_name,)), pts_d.to_local())
    return DTensor.from_local(
        out, mesh, sp.placements(mesh, {axis_name: Shard(out_dim)}),
        run_check=False)


def pull_points(inp, points, orders, bounds, extrapolate, *, mesh,
                axis_name: str = "data") -> DTensor:
    """Point-sharded scattered pull: (B, C, *ishape) replicated x (B, P, D)
    point-sharded -> (B, C, P) point-sharded.  P must divide the mesh
    axis."""
    f = partial(_pp.pull, orders=orders, bounds=bounds,
                extrapolate=extrapolate)
    return _point_op(f, inp, points, mesh, axis_name, 2)


def grad_points(inp, points, orders, bounds, extrapolate, *, mesh,
                axis_name: str = "data") -> DTensor:
    """Point-sharded scattered spatial gradients: -> (B, C, P, D)."""
    f = partial(_pp.grad, orders=orders, bounds=bounds,
                extrapolate=extrapolate)
    return _point_op(f, inp, points, mesh, axis_name, 2)


def push_points(values, points, oshape: Tuple[int, ...], orders, bounds,
                extrapolate, *, mesh, axis_name: str = "data") -> DTensor:
    """Point-sharded splat: (B, C, P) x (B, P, D) -> (B, C, *oshape)
    replicated (each rank splats its shard; one all-reduce merges)."""
    vals = sp.as_dtensor(values, mesh,
                         sp.placements(mesh, {axis_name: Shard(2)}))
    pts = sp.as_dtensor(points, mesh,
                        sp.placements(mesh, {axis_name: Shard(1)}))
    out = _pp.push(vals.to_local(), pts.to_local(), tuple(oshape), orders,
                   bounds, extrapolate)
    return _merged(out, mesh, sp.placements(mesh, {}), axis_name)


def count_points(points, oshape: Tuple[int, ...], orders, bounds,
                 extrapolate, *, mesh, axis_name: str = "data") -> DTensor:
    """Point-sharded splat density: (B, P, D) -> (B, 1, *oshape)."""
    pts = sp.as_dtensor(points, mesh,
                        sp.placements(mesh, {axis_name: Shard(1)}))
    out = _pp.count(pts.to_local(), tuple(oshape), orders, bounds,
                    extrapolate)
    return _merged(out, mesh, sp.placements(mesh, {}), axis_name)


# ------------------------------------------------ slab-sharded volumes

def _slab_geom(ishape, mesh, vol_axis, orders, halo):
    axis = sp.Axis(mesh, vol_axis)
    H = halo if halo is not None else sp.halo_width(orders, 0.0)
    n_loc = sp._check(ishape[0], axis.size, H)
    return axis, H, n_loc


def _own_mask(pts, N, n_loc, axis, dtype):
    """Points whose clipped axis-0 coordinate lies in this rank's slab."""
    x0 = axis.index * n_loc
    xc = torch.clamp(pts[..., 0], 0, N - 1)
    return ((xc >= x0) & (xc < x0 + n_loc)).to(dtype)


def _slab_gather(core, inp, points, orders, bounds, extrapolate, mesh,
                 vol_axis, point_axis, halo, trailing):
    D = points.shape[-1]
    ishape = tuple(inp.shape[2:])
    axis, H, n_loc = _slab_geom(ishape, mesh, vol_axis, orders, halo)
    inp_d = sp.as_dtensor(inp, mesh, sp.placements(
        mesh, {vol_axis: Shard(2)}))
    pts_d = sp.as_dtensor(points, mesh, sp.placements(
        mesh, {point_axis: Shard(1)}))
    inp_l = sp.local(inp_d, (point_axis,) if point_axis else ())
    pts_l = sp.local(pts_d, (vol_axis,))
    left, right = sp._exchange_halos(inp_l, axis, H)
    ext = torch.cat([left, inp_l, right], dim=2)
    shifts = (sp._shift(axis, n_loc, H),) + (None,) * (D - 1)
    out = core(ext, pts_l, tuple(orders), tuple(bounds), extrapolate,
               fold_shapes=ishape, shifts=shifts)        # (B, C, P_loc, ...)
    own = _own_mask(pts_l, ishape[0], n_loc, axis, out.dtype)
    out = out * own.reshape(own.shape[:1] + (1,) + own.shape[1:]
                            + (1,) * trailing)
    return _merged(out, mesh, sp.placements(mesh, {point_axis: Shard(2)}),
                   vol_axis)


def pull_points_slab(inp, points, orders, bounds, extrapolate, *, mesh,
                     vol_axis: str = "x", point_axis: str = None,
                     halo: int = None) -> DTensor:
    """Scattered pull from a slab-sharded volume.

    inp (B, C, *ishape) sharded along spatial axis 0 over ``vol_axis``;
    points (B, P, D) sharded over ``point_axis`` (or replicated) -> (B, C,
    P) sharded like the points.  Out-of-volume points (``extrapolate=1``)
    are exact while their boundary-folded taps stay within the owner
    slab's halo; raise ``halo`` for clouds that extrapolate further."""
    return _slab_gather(nd.pull_core, inp, points, orders, bounds,
                        extrapolate, mesh, vol_axis, point_axis, halo, 0)


def grad_points_slab(inp, points, orders, bounds, extrapolate, *, mesh,
                     vol_axis: str = "x", point_axis: str = None,
                     halo: int = None) -> DTensor:
    """Scattered spatial gradients from a slab-sharded volume: -> (B, C, P,
    D) sharded like the points."""
    return _slab_gather(nd.grad_core, inp, points, orders, bounds,
                        extrapolate, mesh, vol_axis, point_axis, halo, 1)


def push_points_slab(values, points, oshape: Tuple[int, ...], orders,
                     bounds, extrapolate, *, mesh, vol_axis: str = "x",
                     point_axis: str = None, halo: int = None) -> DTensor:
    """Scattered splat into a slab-sharded volume (the adjoint of
    :func:`pull_points_slab`).

    values (B, C, P) / points (B, P, D) sharded over ``point_axis`` -> (B,
    C, *oshape) sharded along spatial axis 0 over ``vol_axis``.  Each rank
    splats its owned points into its halo-extended slab, the margins ride
    the ring to the neighbouring slabs, and an all-reduce over
    ``point_axis`` merges the point shards."""
    D = points.shape[-1]
    oshape = tuple(int(s) for s in oshape)
    axis, H, n_loc = _slab_geom(oshape, mesh, vol_axis, orders, halo)
    ext_shape = (n_loc + 2 * H,) + oshape[1:]
    vals_d = sp.as_dtensor(values, mesh, sp.placements(
        mesh, {point_axis: Shard(2)}))
    pts_d = sp.as_dtensor(points, mesh, sp.placements(
        mesh, {point_axis: Shard(1)}))
    vals_l = sp.local(vals_d, (vol_axis,))
    pts_l = sp.local(pts_d, (vol_axis,))
    own = _own_mask(pts_l, oshape[0], n_loc, axis, vals_l.dtype)
    shifts = (sp._shift(axis, n_loc, H),) + (None,) * (D - 1)
    ext = nd.push_core(vals_l * own[:, None], pts_l, ext_shape,
                       tuple(orders), tuple(bounds), extrapolate,
                       fold_shapes=oshape, shifts=shifts)
    out = ext[:, :, H:H + n_loc]
    from_left, from_right = sp.ring(ext[:, :, -H:], ext[:, :, :H], axis)
    out = torch.cat([out[:, :, :H] + from_left, out[:, :, H:]], dim=2)
    out = torch.cat([out[:, :, :-H], out[:, :, -H:] + from_right], dim=2)
    places = sp.placements(mesh, {vol_axis: Shard(2)})
    if point_axis is None:
        return DTensor.from_local(out, mesh, places, run_check=False)
    return _merged(out, mesh, places, point_axis)
