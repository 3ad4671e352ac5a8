"""Slab-sharded pull / grad / push / count with a ring halo exchange.

PyTorch port of ``interpol_tpu/parallel/spatial.py``.  A volume too large
for one device is sharded into slabs along its first spatial axis over one
dimension of a ``DeviceMesh``; the grid holds *global* voxel coordinates.

  pull / grad : each rank ring-exchanges a halo of width H with its
      neighbours (:func:`_exchange_halos`, ``dist.batch_isend_irecv`` on
      the mesh dimension's group), extends its slab and samples locally;
      boundary folding runs against the global axis length and maps into
      the halo-extended buffer by ``(folded + H - start) % n_global``
      (``ops/ndkernels.py``'s global-folding mode).
  push / count : the adjoint: each rank splats into a halo-extended local
      buffer, the margins ride the ring back to the ranks that own them and
      are added.  Deterministic: a local splat and one ring add.

Dense-warp grids (one sample per voxel, ``max_disp > 0``, extrapolate)
take the window path (``use_window=None`` decides, as in the JAX package):
the shard-local problem is itself a dense warp on the halo-extended slab,
so ``ops/window.py``'s Functions run on it, which on the card are kernels
1a / 1b (``csrc/warp.cu``) and 2a (``csrc/push.cu``).  The edge ranks'
halos are then replaced by the boundary fold of their own slab
(:func:`_corrected_halos`; zeros for the zero bound, the ring itself for
dft), and the window push folds its margins back with their signs.

Arrays are ``DTensor``s (``torch.distributed.tensor``): ``inp`` (B, C,
*ishape) sharded along dim 2 over ``mesh[axis_name]`` (and dim 0 over
``batch_axis``), ``grid`` (B, *oshape, D) along dim 1; a plain tensor is
taken as the same global array on every rank.  Inside each function the
local shards go through the single-device ops, and the result comes back
as ``DTensor.from_local(..., run_check=False)``.  The ring exchange is a
``torch.autograd.Function`` whose backward sends the halo cotangents back
along the ring and adds them, so the sharded ops differentiate like the
one-device ones.  CPU tensors ride a gloo group, CUDA tensors NCCL.

Contract: every sample stays within ``max_disp`` voxels of its own slab
along axis 0; the halo is ``ceil(max_disp) + (max(orders)+1)//2 + 1``
(:func:`halo_width`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..options import BoundType
from ..ops import ndkernels as nd
from ..ops import window as wd
from ..ops.bounds import fold_index, fold_sign

__all__ = ["halo_width", "pull_sharded", "push_sharded", "count_sharded",
           "grad_sharded"]


def halo_width(orders: Tuple[int, ...], max_disp: float = 0.0) -> int:
    """Halo needed for slab-sharded sampling with axis-0 displacements
    bounded by ``max_disp`` voxels."""
    return int(math.ceil(max_disp)) + (max(orders) + 1) // 2 + 1


def _check(n_global, ndev, H):
    n_loc = n_global // ndev
    if n_loc * ndev != n_global:
        raise ValueError(
            f"sharded axis ({n_global}) must divide the mesh axis ({ndev})")
    if H > n_loc:
        raise ValueError(f"halo ({H}) exceeds slab width ({n_loc})")
    if ndev > 1 and 2 * H + n_loc > n_global:
        raise ValueError(
            f"halo ({H}) too large: extended slab aliases (n={n_global})")
    return n_loc


# --------------------------------------------------------------- the mesh

class Axis:
    """One dimension of a ``DeviceMesh`` as this rank sees it: its size,
    this rank's index along it, its process group and the global ranks of
    the ring neighbours."""

    def __init__(self, mesh, name: str):
        names = mesh.mesh_dim_names or ()
        if name not in names:
            raise ValueError(f"mesh has no dimension {name!r} ({names})")
        self.size = mesh.size(names.index(name))
        self.index = mesh.get_local_rank(name)
        self.group = mesh.get_group(name)
        ranks = dist.get_process_group_ranks(self.group)
        self.left = ranks[(self.index - 1) % self.size]
        self.right = ranks[(self.index + 1) % self.size]


def placements(mesh, dims: Dict[Optional[str], object]):
    """A placement per mesh dimension: ``dims`` maps dimension names to
    placements (None keys are skipped), Replicate elsewhere."""
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names or ()
    for name, p in dims.items():
        if name is not None and p is not None:
            out[names.index(name)] = p
    return out


def as_dtensor(x, mesh, places) -> DTensor:
    """``x`` laid out as ``places`` over ``mesh``: a DTensor is
    redistributed where it differs, a plain tensor is the same global array
    on every rank (its shards are local slices)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(places):
        x = x.redistribute(mesh, places)
    return x


def local(x: DTensor, partial_over: Sequence[str] = ()) -> torch.Tensor:
    """The local shard; its gradient is a partial sum over the mesh
    dimensions in ``partial_over`` (a replicated input that each rank uses
    for part of the work, such as the volume of a point-sharded pull)."""
    if not partial_over:
        return x.to_local()
    names = x.device_mesh.mesh_dim_names
    gp = [Partial() if names[i] in partial_over else p
          for i, p in enumerate(x.placements)]
    return x.to_local(grad_placements=gp)


class _Ring(torch.autograd.Function):
    """(to_right, to_left) -> (from_left, from_right) along the ring of one
    mesh dimension: each rank sends ``to_right`` to its right neighbour and
    ``to_left`` to its left, and receives its left neighbour's ``to_right``
    and its right neighbour's ``to_left``.  The adjoint is the same ring
    run backwards, itself a ``_Ring`` (so it differentiates again)."""

    @staticmethod
    def forward(ctx, to_right, to_left, axis):
        ctx.axis = axis
        return _ring_exchange(to_right, to_left, axis)

    @staticmethod
    def backward(ctx, d_from_left, d_from_right):
        # my to_right became my right neighbour's from_left, so its
        # cotangent comes back from the right; to_left's from the left
        g_left, g_right = _Ring.apply(d_from_right.contiguous(),
                                      d_from_left.contiguous(), ctx.axis)
        return g_right, g_left, None


def _ring_exchange(to_right, to_left, axis):
    to_right, to_left = to_right.contiguous(), to_left.contiguous()
    from_left = torch.empty_like(to_right)
    from_right = torch.empty_like(to_left)
    ops = [dist.P2POp(dist.isend, to_right, axis.right, axis.group, tag=1),
           dist.P2POp(dist.irecv, from_left, axis.left, axis.group, tag=1),
           dist.P2POp(dist.isend, to_left, axis.left, axis.group, tag=2),
           dist.P2POp(dist.irecv, from_right, axis.right, axis.group, tag=2)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def ring(to_right, to_left, axis: Axis):
    """Differentiable ring exchange (:class:`_Ring`); on a mesh dimension
    of one rank the messages wrap onto the rank itself."""
    if axis.size == 1:
        return to_right, to_left
    return _Ring.apply(to_right, to_left, axis)


def _exchange_halos(slab, axis: Axis, H):
    """Ring-exchange: (left_halo, right_halo) of width H along dim 2 of a
    (B, C, n_loc, ...) slab: the left neighbour's last H rows and the
    right neighbour's first H rows (the slab's own on one rank)."""
    return ring(slab[:, :, -H:], slab[:, :, :H], axis)


def _shift(axis: Axis, n_loc, H):
    """Local-coordinate shift: global folded index + shift, mod n_global,
    is the halo-extended buffer position."""
    return H - axis.index * n_loc


# ------------------------------------------------ dense-warp window path

def _edge_halo_tables(n_global, n_loc, H, bound):
    """Fold tables for the edge ranks' halo correction: local row indices
    (and signs or None) inside the first / last slab that boundary-fold the
    global rows [-H..-1] / [n..n+H-1]."""
    li = np.arange(-H, 0)
    ri = np.arange(n_global, n_global + H)
    lf = fold_index(li, n_global, bound)
    rf = fold_index(ri, n_global, bound) - (n_global - n_loc)
    ls = fold_sign(li, n_global, bound, np.float64)
    rs = fold_sign(ri, n_global, bound, np.float64)
    if (lf >= n_loc).any() or (rf < 0).any():
        raise ValueError(
            f"boundary fold depth exceeds the slab width ({n_loc}); "
            "increase the per-device slab or reduce the halo")
    return lf, ls, rf, rs


def _dense_eligible(inp, grid, extrapolate, max_disp):
    ishape = tuple(inp.shape[2:])
    return (max_disp > 0 and extrapolate == 1
            and tuple(grid.shape[1:-1]) == ishape)


def _sgn(x, s, dim=2):
    if s is None:
        return x
    shape = [1] * x.ndim
    shape[dim] = len(s)
    return x * torch.as_tensor(s, dtype=x.dtype,
                               device=x.device).reshape(shape)


def _rows(x, idx):
    return torch.index_select(x, 2, torch.as_tensor(idx, device=x.device))


def _corrected_halos(slab, axis: Axis, H, n_global, bound):
    """Ring halos along dim 2, with boundary-correct content on the edge
    ranks (the ring itself for dft: the wrap IS the ring content)."""
    left, right = _exchange_halos(slab, axis, H)
    if bound == BoundType.dft:
        return left, right
    lf, ls, rf, rs = _edge_halo_tables(n_global, slab.shape[2], H, bound)
    if axis.index == 0:
        left = torch.zeros_like(left) if bound == BoundType.zero \
            else _sgn(_rows(slab, lf), ls)
    if axis.index == axis.size - 1:
        right = torch.zeros_like(right) if bound == BoundType.zero \
            else _sgn(_rows(slab, rf), rs)
    return left, right


def _local_dense_grid(grid_loc, axis: Axis, n_loc, H):
    """Global grid coordinates -> the halo-extended local frame, edge-padded
    along axis 0 to cover the extended slab (the halo rows' outputs are
    discarded)."""
    D = grid_loc.shape[-1]
    off = torch.zeros(D, dtype=grid_loc.dtype, device=grid_loc.device)
    off[0] = axis.index * n_loc - H
    gl = grid_loc - off
    lo = gl[:, :1].expand((-1, H) + tuple(gl.shape[2:]))
    hi = gl[:, -1:].expand((-1, H) + tuple(gl.shape[2:]))
    return torch.cat([lo, gl, hi], dim=1)


def _window_setup(orders, bounds, max_disp, H):
    smin, smax = wd.window_range(max(orders), max_disp)
    if H < max(-smin, smax):
        raise ValueError(f"halo ({H}) narrower than the window "
                         f"[{smin}, {smax}]")
    # axis 0's bound inside the local warp never matters (interior samples
    # never reach the extended slab's own pad; halo-row outputs are
    # discarded): replicate, the real bounds elsewhere
    return (int(BoundType.replicate),) + tuple(bounds[1:])


# ------------------------------------------------------------ the ops

def _setup(inp, grid, orders, max_disp, halo, mesh, axis_name, batch_axis,
           oshape=None):
    """(axis, H, n_loc, inp DTensor, grid DTensor) for a slab-sharded op
    whose volume (``inp`` or, for a push, ``oshape``) shards along axis 0."""
    axis = Axis(mesh, axis_name)
    shape = tuple(oshape) if oshape is not None else tuple(inp.shape[2:])
    H = halo if halo is not None else halo_width(orders, max_disp)
    n_loc = _check(shape[0], axis.size, H)
    vol = placements(mesh, {axis_name: Shard(2), batch_axis: Shard(0)})
    pts = placements(mesh, {axis_name: Shard(1), batch_axis: Shard(0)})
    return (axis, H, n_loc, as_dtensor(inp, mesh, vol),
            as_dtensor(grid, mesh, pts), vol)


def _gather_sharded(kind, inp, grid, orders, bounds, extrapolate, mesh,
                    axis_name, halo, max_disp, batch_axis, use_window):
    """pull_sharded / grad_sharded (``kind`` 'pull' / 'grad')."""
    D = grid.shape[-1]
    ishape = tuple(inp.shape[2:])
    axis, H, n_loc, inp_d, grid_d, vol = _setup(
        inp, grid, orders, max_disp, halo, mesh, axis_name, batch_axis)
    if use_window is None:
        use_window = _dense_eligible(inp_d, grid_d, extrapolate, max_disp)
    inp_l, grid_l = inp_d.to_local(), grid_d.to_local()
    if use_window:
        lbounds = _window_setup(orders, bounds, max_disp, H)
        left, right = _corrected_halos(inp_l, axis, H, ishape[0], bounds[0])
        ext = torch.cat([left, inp_l, right], dim=2)
        gext = _local_dense_grid(grid_l, axis, n_loc, H)
        fn = wd.pull_window if kind == "pull" else wd.grad_window
        out = fn(ext, gext, tuple(orders), lbounds, 1, max_disp)
        out = out[:, :, H:H + n_loc]
    else:
        left, right = _exchange_halos(inp_l, axis, H)
        ext = torch.cat([left, inp_l, right], dim=2)
        shifts = (_shift(axis, n_loc, H),) + (None,) * (D - 1)
        gflat = grid_l.reshape(grid_l.shape[0], -1, D)
        core = nd.pull_core if kind == "pull" else nd.grad_core
        out = core(ext, gflat, tuple(orders), tuple(bounds), extrapolate,
                   fold_shapes=ishape, shifts=shifts)
        tail = () if kind == "pull" else (D,)
        out = out.reshape(out.shape[:2] + tuple(grid_l.shape[1:-1]) + tail)
    return DTensor.from_local(out, mesh, vol, run_check=False)


def pull_sharded(inp, grid, orders, bounds, extrapolate, *, mesh,
                 axis_name: str = "x", halo: int = None,
                 max_disp: float = 0.0, batch_axis: str = None,
                 use_window: bool = None) -> DTensor:
    """Slab-sharded grid_pull.

    inp (B, C, *ishape) and grid (B, *oshape, D) sharded along their first
    spatial axis over ``mesh[axis_name]`` (and the batch over
    ``batch_axis``); grid holds *global* voxel coordinates.  Returns (B,
    C, *oshape) with the same sharding."""
    return _gather_sharded("pull", inp, grid, orders, bounds, extrapolate,
                           mesh, axis_name, halo, max_disp, batch_axis,
                           use_window)


def grad_sharded(inp, grid, orders, bounds, extrapolate, *, mesh,
                 axis_name: str = "x", halo: int = None,
                 max_disp: float = 0.0, batch_axis: str = None,
                 use_window: bool = None) -> DTensor:
    """Slab-sharded grid_grad; the layout of :func:`pull_sharded`,
    returning (B, C, *oshape, D)."""
    return _gather_sharded("grad", inp, grid, orders, bounds, extrapolate,
                           mesh, axis_name, halo, max_disp, batch_axis,
                           use_window)


def _add_rows(out, rows, idx):
    """``out`` plus ``rows`` added at the dim-2 indices ``idx``."""
    return out.index_add(2, torch.as_tensor(idx, device=out.device), rows)


def push_sharded(inp, grid, oshape: Tuple[int, ...], orders, bounds,
                 extrapolate, *, mesh, axis_name: str = "x",
                 halo: int = None, max_disp: float = 0.0,
                 batch_axis: str = None, use_window: bool = None) -> DTensor:
    """Slab-sharded grid_push (the adjoint of :func:`pull_sharded`).

    inp (B, C, *gshape) and grid (B, *gshape, D) sharded along the first
    spatial axis; output (B, C, *oshape) sharded likewise."""
    D = grid.shape[-1]
    oshape = tuple(int(s) for s in oshape)
    axis, H, n_loc, inp_d, grid_d, vol = _setup(
        inp, grid, orders, max_disp, halo, mesh, axis_name, batch_axis,
        oshape)
    ext_shape = (n_loc + 2 * H,) + oshape[1:]
    if use_window is None:
        use_window = (max_disp > 0 and extrapolate == 1
                      and tuple(grid.shape[1:-1]) == oshape
                      and tuple(inp.shape[2:]) == oshape)
    inp_l, grid_l = inp_d.to_local(), grid_d.to_local()
    first, last = axis.index == 0, axis.index == axis.size - 1
    if use_window:
        lbounds = _window_setup(orders, bounds, max_disp, H)
        gext = _local_dense_grid(grid_l, axis, n_loc, H)
        pad = torch.zeros(inp_l.shape[:2] + (H,) + tuple(inp_l.shape[3:]),
                          dtype=inp_l.dtype, device=inp_l.device)
        vext = torch.cat([pad, inp_l, pad], dim=2)
        ext = wd.push_window(vext, gext, tuple(orders), lbounds, 1,
                             max_disp)               # (B, C, n_loc + 2H, ...)
        out = ext[:, :, H:H + n_loc]
        left_m, right_m = ext[:, :, :H], ext[:, :, -H:]
        from_left, from_right = ring(right_m, left_m, axis)
        if int(bounds[0]) != BoundType.dft:
            # the edge ranks: the wrapped ring pieces are not theirs; their
            # own margins fold back through the global boundary into their
            # own slab (the adjoint of the pull's halo correction)
            lf, ls, rf, rs = _edge_halo_tables(oshape[0], n_loc, H,
                                               bounds[0])
            zero = int(bounds[0]) == BoundType.zero
            if first:
                from_left = torch.zeros_like(from_left)
                if not zero:
                    out = _add_rows(out, _sgn(left_m, ls), lf)
            if last:
                from_right = torch.zeros_like(from_right)
                if not zero:
                    out = _add_rows(out, _sgn(right_m, rs), rf)
    else:
        B, C = inp_l.shape[:2]
        shifts = (_shift(axis, n_loc, H),) + (None,) * (D - 1)
        gflat = grid_l.reshape(grid_l.shape[0], -1, D)
        vals = inp_l.reshape(B, C, -1)
        ext = nd.push_core(vals, gflat, ext_shape, tuple(orders),
                           tuple(bounds), extrapolate, fold_shapes=oshape,
                           shifts=shifts)            # (B, C, n_loc + 2H, ...)
        out = ext[:, :, H:H + n_loc]
        from_left, from_right = ring(ext[:, :, -H:], ext[:, :, :H], axis)
    out = torch.cat([out[:, :, :H] + from_left, out[:, :, H:]], dim=2)
    out = torch.cat([out[:, :, :-H], out[:, :, -H:] + from_right], dim=2)
    return DTensor.from_local(out, mesh, vol, run_check=False)


def count_sharded(grid, oshape: Tuple[int, ...], orders, bounds,
                  extrapolate, *, mesh, axis_name: str = "x",
                  halo: int = None, max_disp: float = 0.0,
                  batch_axis: str = None) -> DTensor:
    """Slab-sharded grid_count = push_sharded of unit weights."""
    pts = placements(mesh, {axis_name: Shard(1), batch_axis: Shard(0)})
    grid_d = as_dtensor(grid, mesh, pts)
    g = grid_d.to_local()
    ones = torch.ones((g.shape[0], 1) + tuple(g.shape[1:-1]),
                      dtype=g.dtype, device=g.device)
    vol = placements(mesh, {axis_name: Shard(2), batch_axis: Shard(0)})
    ones = DTensor.from_local(ones, mesh, vol, run_check=False)
    return push_sharded(ones, grid_d, oshape, orders, bounds, extrapolate,
                        mesh=mesh, axis_name=axis_name, halo=halo,
                        max_disp=max_disp, batch_axis=batch_axis)
