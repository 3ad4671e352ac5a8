"""Per-tile geometry of the adaptive window mode (``tile_spread``).

PyTorch port of ``interpol_tpu/ops/pallas_warp.py:74-100, 431-463`` and
of the tiles of ``interpol_tpu/ops/window.py::_lift3`` (``:284-305``).
In adaptive mode each tile of the TPU kernel's grid gets an integer base
displacement per axis, the rounded tile mean of the displacement clipped
to ``ceil(max_disp)``, and a sample keeps its taps on an axis iff its node
origin offset minus the base lies in the *residual* window of
``tile_spread``.  The port carries over that function: the tiles are the
TPU kernel's tiles, on every device, so that the CUDA kernels, their plain
versions and the JAX package drop the same taps.

The bases are computed once per call, on the grid's device, in the working
dtype (at least float32), from a detached grid: they are constants for
every backward, as the JAX side's int32 cast makes them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["default_tile", "aligned", "lifted_tile", "tile_bases",
           "base_field"]


def default_tile(ishape: Optional[Sequence[int]] = None,
                 push: bool = False) -> Optional[Tuple[int, int, int]]:
    """The TPU kernel's tile of a 3-D volume, None for other ranks: (8, 8,
    128), or a full-span last axis for the pull family when ``z % 128 !=
    0`` and ``z <= 384`` (the push always keeps 128)."""
    if ishape is not None and len(ishape) != 3:
        return None
    tz = 128
    if (not push and ishape is not None and ishape[2] % 128 != 0
            and ishape[2] <= 384):
        tz = int(ishape[2])
    return (8, 8, tz)


def aligned(ishape: Sequence[int], tile: Sequence[int]) -> Tuple[int, ...]:
    """Volume shape rounded up to tile multiples."""
    return tuple(-(-n // t) * t for n, t in zip(ishape, tile))


def lifted_tile(ishape: Sequence[int], push: bool = False
                ) -> Tuple[int, ...]:
    """The tile of a D-dim volume (D in 1..3) on the last D axes: the 3-D
    tile, or the last D axes of the lifted (1, 8, 128) / (1, 1, 128)."""
    D = len(ishape)
    if D == 3:
        return default_tile(ishape, push)
    return ((1, 8, 128) if D == 2 else (1, 1, 128))[-D:]


def _edge_pad(t: torch.Tensor, ishape, tile):
    """Edge-replicate the spatial axes 1..D of ``t`` up to tile multiples
    (the alignment margin)."""
    for d, (n, a) in enumerate(zip(ishape, aligned(ishape, tile))):
        if a != n:
            idx = torch.arange(a, device=t.device).clamp_(max=n - 1)
            t = t.index_select(1 + d, idx)
    return t


def tile_bases(grid: torch.Tensor, max_disp: Sequence[float],
               tile: Sequence[int], wdtype=None) -> torch.Tensor:
    """Per-tile integer base displacements of a dense (B, *ishape, D)
    grid: int32 (B, *ntiles, D), the rounded (half to even) tile mean of
    each displacement component over the edge-replicated tile, clipped to
    [-ceil(max_disp), ceil(max_disp)] per axis.  ``max_disp`` is a
    per-axis tuple; ``tile`` covers the last D axes.

    The tile mean of the displacement is that of the grid minus that of
    the voxel's own index (a per-axis constant of the tile), so no
    displacement field is made: one pass over the grid sums the last tile
    axis in the grid's dtype, and the partial sums (1/t of the grid) are
    summed on in float64 (``wdtype`` when wider)."""
    D = grid.shape[-1]
    ishape = tuple(grid.shape[1:-1])
    tile = tuple(tile)[-D:]
    wdtype = torch.promote_types(wdtype or grid.dtype, torch.float64)
    dev = grid.device
    with torch.no_grad():
        g = _edge_pad(grid.detach(), ishape, tile)
        shape = [g.shape[0]]
        for n, t in zip(g.shape[1:-1], tile):
            shape += [n // t, t]
        m = g.reshape(shape + [D]).sum(dim=2 * D).to(wdtype)
        if D > 1:
            m = m.sum(dim=tuple(range(2, 2 * D, 2)))
        m = m / math.prod(tile)
        for d, (n, t) in enumerate(zip(ishape, tile)):
            a = -(-n // t) * t
            own = torch.arange(a, device=dev).clamp_(max=n - 1).to(wdtype)
            view = [1] * (D + 2)
            view[1 + d] = a // t
            m[..., d] -= own.reshape(a // t, t).mean(1).reshape(view[:-1])
        B = torch.tensor([float(math.ceil(md)) for md in max_disp],
                         dtype=wdtype, device=dev)
        return torch.clamp(torch.round(m), -B, B).to(torch.int32)


def base_field(bases: torch.Tensor, tile: Sequence[int],
               ishape: Sequence[int]) -> torch.Tensor:
    """Each voxel's tile base: int32 (B, *ntiles, D) -> (B, *ishape, D)."""
    out = bases
    for d, (t, n) in enumerate(zip(tuple(tile)[-len(ishape):], ishape)):
        out = out.repeat_interleave(t, dim=1 + d).narrow(1 + d, 0, n)
    return out
