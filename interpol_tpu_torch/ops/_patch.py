"""Host half of the race-free patch splat (``csrc/patch_splat.cuh``),
shared by the dense-warp push (``cuda_warp.push_cuda``) and the scattered
splat (``cuda_scattered.splat_cuda``): the ``PatchGeom`` kernel parameter,
the fold tables and the patch scratch buffer.

A tile ``t`` of an axis holds the items anchored in ``[t*T, (t+1)*T)``; its
patch covers the unfolded indices ``[t*T + lo, t*T + lo + E)``.  The
overlap-fold kernel needs, per axis and output index ``q``, every patch
cell that folds onto ``q`` with a non-zero sign: each unfolded ``u`` with
``fold(u) = q`` and each tile whose patch covers ``u``, as the cell's
offset along that axis of the scratch and its fold sign.  A voxel's cells
are the products of its three axes' lists (the scratch offset is a sum of
per-axis terms).  Built here with numpy from ``ops/bounds.py`` (the same
folds as the plain versions) and cached on the device.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .bounds import fold_index, fold_sign

__all__ = ["PatchGeom", "patch_geom", "PATCH_BYTES"]

# shared memory of one block's patch slab: a patch that fits is one slab
# (each slab walks every item's taps again); 48 KB needs no opt-in
PATCH_BYTES = 48 * 1024


class PatchGeom(ctypes.Structure):
    """Mirror of ``struct PatchGeom`` in ``csrc/patch_splat.cuh``."""
    _fields_ = [
        ("B", ctypes.c_longlong),
        ("C", ctypes.c_longlong),
        ("n", ctypes.c_int * 3),
        ("T", ctypes.c_int * 3),
        ("lo", ctypes.c_int * 3),
        ("E", ctypes.c_int * 3),
        ("NB", ctypes.c_int * 3),
        ("xslab", ctypes.c_int),
        ("cell_start", ctypes.c_void_p * 3),
        ("cell_off", ctypes.c_void_p * 3),
        ("cell_sign", ctypes.c_void_p * 3),
    ]


@lru_cache(maxsize=256)
def _fold_cells(n: int, bound: int, T: int, lo: int, E: int, nb: int,
                tstride: int, lstride: int, device: str):
    """(start int32 (n+1,), offset int64, sign float32) on ``device``: for
    each q, the patch cells of one axis that fold onto it, in increasing
    unfolded index u, then tile t; a cell's offset is ``t * tstride +
    (u - t*T - lo) * lstride``."""
    u = np.arange(lo, (nb - 1) * T + lo + E)
    q = fold_index(u, n, bound)
    sign = fold_sign(u, n, bound, np.float32)
    sign = np.ones(u.shape, np.float32) if sign is None else sign
    keep = sign != 0
    u, q, sign = u[keep], q[keep], sign[keep]
    # tiles covering u: t = floor((u - lo) / T) - k for k = 0, 1, ...
    # while the patch still reaches u
    last = (u - lo) // T
    cells = []
    for k in range(-(-E // T) + 1):
        t = last - k
        ok = (t >= 0) & (t < nb) & (u - t * T - lo < E)
        cells.append((q[ok], u[ok], t[ok], sign[ok]))
    q, u, t, sign = (np.concatenate(c) for c in zip(*cells))
    order = np.lexsort((t, u, q))
    q, u, t, sign = q[order], u[order], t[order], sign[order]
    start = np.zeros(n + 1, np.int32)
    start[1:] = np.cumsum(np.bincount(q, minlength=n))
    off = t.astype(np.int64) * tstride + (u - t * T - lo).astype(
        np.int64) * lstride
    return tuple(torch.as_tensor(a, device=device) for a in (
        start, off, sign.astype(np.float32)))


def patch_geom(B: int, C: int, shape: Sequence[int], bounds: Sequence[int],
               tile: Sequence[int], lo: Sequence[int],
               extent: Sequence[int], device):
    """Fill a ``PatchGeom`` and allocate the patch scratch (C, B, tiles,
    *extent).  Returns (geom, scratch, tables); keep ``tables`` alive
    until the kernels have run."""
    g = PatchGeom()
    g.B, g.C = B, C
    nb = [-(-shape[d] // tile[d]) for d in range(3)]
    psize = math.prod(extent)
    tstride = (nb[1] * nb[2] * psize, nb[2] * psize, psize)
    lstride = (extent[1] * extent[2], extent[2], 1)
    tables = []
    for d in range(3):
        g.n[d], g.T[d], g.lo[d], g.E[d], g.NB[d] = (
            shape[d], tile[d], lo[d], extent[d], nb[d])
        start, off, sign = _fold_cells(shape[d], int(bounds[d]), tile[d],
                                       lo[d], extent[d], nb[d], tstride[d],
                                       lstride[d], str(device))
        g.cell_start[d], g.cell_off[d], g.cell_sign[d] = (
            start.data_ptr(), off.data_ptr(), sign.data_ptr())
        tables += [start, off, sign]
    row = 4 * extent[1] * extent[2]
    if row > 200 * 1024:
        raise ValueError(f"patch rows of {row} bytes exceed shared memory "
                         f"(extent {tuple(extent)})")
    nslab = -(-extent[0] * row // PATCH_BYTES)
    g.xslab = -(-extent[0] // nslab)
    scratch = torch.empty(C * B * math.prod(nb) * psize,
                          dtype=torch.float32, device=device)
    return g, scratch, tables
