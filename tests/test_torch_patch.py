"""The host half of the race-free patch splat (``interpol_tpu_torch/ops/
_patch.py``) on the CPU: the per-axis fold tables that the overlap-fold
kernel (``csrc/patch_splat.cuh``) reads, held to ``ops/bounds.py``.

The kernels run only on the card; what they read from the host is checked
here: for every output index, the table lists each patch cell that folds
onto it (every tile whose patch covers an unfolded index u with fold(u) =
q and a non-zero sign) once, with its scratch offset and sign; and summing
the tiles' patches through the tables is the direct fold of every patch.
No JAX, no GPU:

    python -m pytest --noconftest tests/test_torch_patch.py -q
"""
import itertools

import numpy as np
import pytest

from interpol_tpu_torch.ops import _patch
from interpol_tpu_torch.ops.bounds import fold_index, fold_sign
from interpol_tpu_torch.ops.scattered import splat_margins
from interpol_tpu_torch.ops.window import window_range


def push_axis(n, order, md, tile=8):
    """(T, lo, E) of one axis of the dense push at full window."""
    smin, smax = window_range(order, md)
    T = min(tile, n)
    return T, smin, T + smax - smin


def splat_axis(n, order, box=16):
    """(T, lo, E) of one axis of the scattered splat."""
    lo, hi = splat_margins(order)
    T = min(box, n)
    return T, lo, T + hi - lo


def tables(n, bound, T, lo, E):
    """(tiles, start, offset, sign, tile * 1024 + local index) of one axis;
    offsets laid out as tile * 1000 + local index (E < 1000)."""
    nb = -(-n // T)
    start, off, sign = _patch._fold_cells(n, bound, T, lo, E, nb, 1000, 1,
                                          "cpu")
    off = off.numpy()
    return nb, start.numpy(), off, sign.numpy(), (off // 1000) * 1024 + \
        off % 1000


# (n, bound, order, max_disp): every bound, orders 0/1/3/7, max_disp
# 0/4/8, odd and even tile counts (8 a tile), axes shorter than a patch
AXES = [(n, b, o, md) for b in range(7) for o, md, n in [
    (0, 0.0, 37), (1, 4.0, 64), (3, 4.0, 40), (3, 8.0, 21), (7, 8.0, 9),
    (3, 0.0, 5), (1, 0.0, 48)]]


@pytest.mark.parametrize("n,bound,order,md", AXES)
def test_fold_tables_list_each_cell_once(n, bound, order, md):
    T, lo, E = push_axis(n, order, md)
    nb, start, off, sign, tl = tables(n, bound, T, lo, E)
    assert start[0] == 0 and np.all(np.diff(start) >= 0)
    t, ll = tl >> 10, tl & 1023
    assert np.all((t >= 0) & (t < nb) & (ll >= 0) & (ll < E))
    u = t * T + lo + ll
    expect = set()
    for tt in range(nb):
        uu = tt * T + lo + np.arange(E)
        s = fold_sign(uu, n, bound, np.float64)
        s = np.ones(E) if s is None else s
        for k in np.flatnonzero(s):
            expect.add((int(fold_index(uu[k], n, bound)), tt, k, s[k]))
    got = set()
    for q in range(n):
        for i in range(start[q], start[q + 1]):
            assert fold_index(u[i], n, bound) == q
            got.add((q, int(t[i]), int(ll[i]), float(sign[i])))
        # cells in increasing unfolded index, then tile
        key = u[start[q]:start[q + 1]] * (nb + 1) + t[start[q]:start[q + 1]]
        assert np.all(np.diff(key) > 0)
    assert got == expect and len(got) == len(off)


def fold_through_tables(patches, boxes, plans, shape):
    """The overlap-fold kernel on the host: each voxel sums, over the
    product of its three axes' cells, the tiles' patch cells (within a box
    of each patch, the whole patch for the kernel), in the tables'
    order."""
    out = np.zeros(shape)
    for q in itertools.product(*[range(n) for n in shape]):
        acc = 0.0
        s0, s1, s2 = (p[1] for p in plans)
        for i0 in range(s0[q[0]], s0[q[0] + 1]):
            t0, l0 = plans[0][4][i0] >> 10, plans[0][4][i0] & 1023
            for i1 in range(s1[q[1]], s1[q[1] + 1]):
                t1, l1 = plans[1][4][i1] >> 10, plans[1][4][i1] & 1023
                sm = 0.0
                for i2 in range(s2[q[2]], s2[q[2] + 1]):
                    t2, l2 = plans[2][4][i2] >> 10, plans[2][4][i2] & 1023
                    lo, hi = boxes[(t0, t1, t2)]
                    if all(a <= x <= b for a, x, b in zip(lo, (l0, l1, l2),
                                                          hi)):
                        sm += float(plans[2][3][i2]) * \
                            patches[(t0, t1, t2)][l0, l1, l2]
                acc += float(plans[0][3][i0]) * float(plans[1][3][i1]) * sm
        out[q] = acc
    return out


def direct_fold(patches, boxes, axes, bounds, shape):
    out = np.zeros(shape)
    for tix, patch in patches.items():
        lo, hi = boxes[tix]
        idx, sgn = [], []
        for d, t in enumerate(tix):
            n, (T, lo_d, E) = shape[d], axes[d]
            l = np.arange(lo[d], hi[d] + 1)
            u = t * T + lo_d + l
            s = fold_sign(u, n, bounds[d], np.float64)
            idx.append(fold_index(u, n, bounds[d]))
            sgn.append(np.ones(len(u)) if s is None else s)
        if any(len(i) == 0 for i in idx):
            continue
        w = sgn[0][:, None, None] * sgn[1][None, :, None] * \
            sgn[2][None, None, :]
        box = patch[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1]
        np.add.at(out, np.ix_(*idx), w * box)
    return out


# 3-D: shape, bounds, orders, max_disp, tile; lifted 1-D / 2-D axes are
# size 1, order 0, max_disp 0
VOLUMES = [
    ((13, 9, 11), (3, 6, 0), (3, 3, 3), 1.5, 4),
    ((10, 7, 9), (6, 1, 4), (1, 2, 5), 1.0, 4),
    ((9, 12, 5), (2, 5, 6), (3, 0, 7), 2.0, 3),
    ((1, 1, 23), (1, 1, 6), (0, 0, 3), 4.0, 8),     # 1-D, lifted
    ((1, 14, 11), (1, 3, 4), (0, 3, 1), 2.0, 4),    # 2-D, lifted
]


@pytest.mark.parametrize("shape,bounds,orders,md,tile", VOLUMES)
def test_table_fold_is_the_direct_fold(shape, bounds, orders, md, tile):
    """Random patches: the tables fold every patch as ``ops/bounds.py``
    does, and, restricted to a random box of each patch (some empty, NaN
    outside), exactly those boxes: a voxel reads only the cells that the
    tables list for it."""
    rng = np.random.default_rng(0)
    axes = [push_axis(n, o, md if n > 1 else 0.0, tile)
            for n, o in zip(shape, orders)]
    plans = [tables(n, b, *ax) for n, b, ax in zip(shape, bounds, axes)]
    nbs = [p[0] for p in plans]
    E = tuple(ax[2] for ax in axes)
    full = {tix: rng.standard_normal(E)
            for tix in itertools.product(*[range(k) for k in nbs])}
    whole = {tix: ((0,) * 3, tuple(e - 1 for e in E)) for tix in full}
    np.testing.assert_allclose(
        fold_through_tables(full, whole, plans, shape),
        direct_fold(full, whole, axes, bounds, shape), rtol=0, atol=1e-12)
    patches, boxes = {}, {}
    for tix in itertools.product(*[range(k) for k in nbs]):
        patch = np.full(E, np.nan)
        if rng.uniform() < 0.2:
            boxes[tix] = ((1,) * 3, (0,) * 3)          # nothing reached
        else:
            a = [int(rng.integers(0, e)) for e in E]
            b = [int(rng.integers(x, e)) for x, e in zip(a, E)]
            boxes[tix] = (tuple(a), tuple(b))
            patch[a[0]:b[0] + 1, a[1]:b[1] + 1, a[2]:b[2] + 1] = \
                rng.standard_normal([y - x + 1 for x, y in zip(a, b)])
        patches[tix] = patch
    got = fold_through_tables(patches, boxes, plans, shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, direct_fold(patches, boxes, axes,
                                                bounds, shape),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("order", [0, 1, 3, 7])
@pytest.mark.parametrize("bound", range(7))
def test_splat_box_tables(order, bound):
    for n, box in ((41, 16), (27, 8), (6, 16)):
        T, lo, E = splat_axis(n, order, box)
        nb, start, off, sign, tl = tables(n, bound, T, lo, E)
        assert start[-1] == len(off) and np.all(sign != 0)
        t, ll = tl >> 10, tl & 1023
        u = t * T + lo + ll
        np.testing.assert_array_equal(
            fold_index(u, n, bound),
            np.repeat(np.arange(n), np.diff(start)))
