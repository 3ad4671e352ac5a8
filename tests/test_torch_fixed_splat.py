"""The fixed-point splat on the CPU: the dense push's site tiles
(``cuda_warp.push_tile``) and the scattered box margins, and a plain
emulation of the kernels' arithmetic (``csrc/fixed_splat.cuh``: the keep
test of each item, the per-slice scale over the kept items, each float32
tap rounded to an int64 at that scale, summed with ``index_add_``,
converted back) held to the JAX package's float64 splats (and to the
port's float64 plain versions, themselves held to JAX), also where a
dropped item carries 1e12, 1e30, inf or NaN.

The kernels run only on the card (``test_torch_cuda.py`` holds them to the
plain versions); the emulation runs here only, as the design's precision
check: within 1e-5 * max(1, max|ref|) of the JAX splats, and within the
fixed point's own bound of the same taps summed in float64.
"""
import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interpol_tpu.ops import ndkernels as jnd
from interpol_tpu_torch.ops import cuda_warp
from interpol_tpu_torch.ops import ndkernels as tnd
from interpol_tpu_torch.ops import window as tw
from interpol_tpu_torch.ops.bounds import fold_index, fold_sign
from interpol_tpu_torch.ops.ndkernels import inbounds_mask
from interpol_tpu_torch.ops.scattered import splat_margins
from interpol_tpu_torch.ops.splines import bspline_taps, node_origin
from interpol_tpu_torch.ops.window import window_range

GATE = 1e-5   # the JAX float32 gate, 1e-5 * max(1, max|ref|)
# tap mass per item of each spec (kMass in csrc/fixed_splat.cuh)
MASS = {"push": 1.0, "pushgrad": 2.0, "pushhess": 4.0}


def splat_scale(vals, mass, keep=None):
    """The header's scale kernel: ``(S, k)`` per slice of ``vals`` (B, C,
    P, ...), P items: ``S = mass * sum |v|`` in float64 over the values of
    the items that ``keep`` (B, P) keeps (every item where it is None), a
    dropped item's value not read, and ``k = min(62 - ceil(log2 S), 127)``
    (0 where S is 0), int64."""
    B, C = vals.shape[:2]
    mag = vals.reshape(B, C, -1).double().abs()
    if keep is not None:
        per = mag.shape[-1] // keep.shape[-1]
        mag = torch.where(keep.repeat_interleave(per, -1)[:, None], mag,
                          0.0)
    S = mag.sum(-1) * mass
    m, e = torch.frexp(S)
    ceil = torch.where(m == 0.5, e - 1, e).to(torch.int64)
    k = torch.where(S > 0, torch.clamp(62 - ceil, max=127),
                    torch.zeros_like(ceil))
    return S, k


def assert_gate(out, ref):
    ref = np.asarray(ref, dtype=np.float64)
    tol = GATE * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(out, dtype=np.float64), ref,
                               rtol=0, atol=tol)


def tap_terms(vals, grid, oshape, orders, bounds, ex, spec, dtype,
              md=None):
    """(destination (taps, B, P), tap (taps, B, C, P) in ``dtype``, kept
    (B, P)) of every tap of every item, as the kernels compute them: the
    mask, the window test of the dense push (``md``: grid (B, *oshape, D)
    of sites), the unfolded factors and the fold sign of each axis."""
    B = grid.shape[0]
    D = grid.shape[-1]
    g = grid.reshape(B, -1, D).to(dtype)
    P = g.shape[1]
    trailing = {"push": 0, "pushgrad": 1, "pushhess": 2}[spec]
    v = vals.reshape(vals.shape[:2] + (P,) + (D,) * trailing).to(dtype)
    keep = torch.ones((B, P), dtype=torch.bool)
    mask = inbounds_mask(g, oshape, ex, torch.bool)
    if mask is not None:
        keep &= mask
    # per axis d, tensors of (1, .., order_d + 1, .., 1, B, P): the taps
    # of the D axes broadcast against each other
    lin, sign, axes = 0, torch.ones((), dtype=dtype), []
    for d in range(D):
        n0, t = node_origin(g[..., d], orders[d])
        w, dw, hw = bspline_taps(t, orders[d], grad=True, hess=True)
        if md is not None:
            smin, smax = window_range(orders[d], md)
            pos = torch.tensor(np.unravel_index(np.arange(P), oshape)[d])
            d0 = n0 - pos
            keep &= (d0 >= smin) & (d0 <= smax - orders[d])
        view = [1] * D + [B, P]
        view[d] = orders[d] + 1
        node = n0 + torch.arange(orders[d] + 1).reshape(-1, 1, 1)
        lin = lin + (fold_index(node, oshape[d], bounds[d])
                     * math.prod(oshape[d + 1:])).reshape(view)
        s = fold_sign(node, oshape[d], bounds[d], dtype)
        if s is not None:
            sign = sign * s.reshape(view)
        axes.append([torch.stack(f).reshape(view) for f in (w, dw, hw)])

    def prod(kinds):    # (taps.., B, 1, P)
        return math.prod(a[k] for a, k in zip(axes, kinds))[..., None, :]
    if spec == "push":
        tap = v * prod([0] * D)
    elif spec == "pushgrad":
        tap = sum(v[..., d] * prod([1 if e == d else 0 for e in range(D)])
                  for d in range(D))
    else:
        tap = 0
        for d in range(D):
            for e in range(d, D):
                kinds = [0] * D
                if d == e:
                    kinds[d] = 2
                    val = v[..., d, d]
                else:
                    kinds[d] = kinds[e] = 1
                    val = v[..., d, e] + v[..., e, d]
                tap = tap + val * prod(kinds)
    taps = math.prod(o + 1 for o in orders)
    lin = torch.broadcast_to(lin, [o + 1 for o in orders] + [B, P])
    tap = tap * sign[..., None, :] if sign.ndim else tap
    return (lin.reshape(taps, B, P),
            torch.broadcast_to(tap, lin.shape[:-1] + (v.shape[1], P))
            .reshape(taps, B, -1, P), keep)


def emulate(vals, grid, oshape, orders, bounds, ex, spec, md=None):
    """The kernels' arithmetic: the keep test of each item (the mask, and
    the window test of the dense push), the scale of each slice over the
    kept items, float32 taps of the kept items times the float32 power of
    two 2^k of their slice (exact), rounded half to even to int64, summed,
    converted back.  Also returns the same float32 taps summed in float64,
    the sum of their magnitudes, the count of taps per voxel and S per
    slice."""
    B, C = vals.shape[:2]
    V = math.prod(oshape)
    # (taps, B, P), (taps, B, C, P), (B, P)
    lin, t32, keep = tap_terms(vals, grid, oshape, orders, bounds, ex,
                               spec, torch.float32, md)
    S, k = splat_scale(vals, MASS[spec], keep)
    scale = torch.pow(2.0, k.double()).float()      # (B, C), exact
    keep = keep.expand(lin.shape)
    # one index per (tap, b, item): voxel lin of batch b at b * V + lin
    idx = (lin + V * torch.arange(B)[:, None]).flatten()
    t32 = torch.where(keep[:, :, None], t32, 0.0).permute(2, 0, 1, 3)
    q = torch.round(t32 * scale.T[:, None, :, None]).to(torch.int64)
    t64 = t32.double()

    def total(src):     # (C, taps, B, P) -> (B, C, V)
        out = src.new_zeros((C, B * V))
        out.index_add_(1, idx, src.reshape(C, -1))
        return out.reshape(C, B, V).transpose(0, 1)
    acc, exact, mag = total(q), total(t64), total(t64.abs())
    count = keep.new_zeros(B * V, dtype=torch.float64).index_add_(
        0, idx, keep.double().flatten()).reshape(B, V)
    inv = torch.pow(2.0, -k.double())[..., None]
    shape = (B, C) + tuple(oshape)
    return ((acc.double() * inv).float().reshape(shape),
            exact.reshape(shape), mag, count, S)


def spanning_values(shape, seed):
    """Values of random sign whose magnitudes span 1e-3 to 1e3 (float32
    numbers, held in float64)."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-3, 3, shape)
    return torch.tensor(mag * rng.choice([-1.0, 1.0], shape)).float() \
        .double()


def cloud(ish, P, B=2, seed=0):
    """Points uniform over [-2.5, n + 1.5] per axis (float32 numbers)."""
    rng = np.random.default_rng(seed)
    g = -2.5 + (np.asarray(ish) + 4.0) * rng.uniform(size=(B, P, len(ish)))
    return torch.tensor(g).float().double()


def warp_grid(ish, md, B=1, seed=0):
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    d = rng.uniform(-1, 1, (B,) + tuple(ish) + (len(ish),)) * md
    return torch.tensor(ident + d)


# (n, bound, order, max_disp): every bound, orders 0/1/3/7, max_disp
# 0/4/8, odd and even tile counts, axes shorter than a patch
AXES = [(n, b, o, md) for b in range(7) for o, md, n in [
    (0, 0.0, 37), (1, 4.0, 64), (3, 4.0, 40), (3, 8.0, 21), (7, 8.0, 9),
    (3, 0.0, 5), (1, 0.0, 48)]]


@pytest.mark.parametrize("n,bound,order,md", AXES)
def test_push_tile_holds_every_tap(n, bound, order, md):
    """The dense push's site tile over an axis of n, full window and
    adaptive (the tile inside one of the TPU's 8-site tiles, its patch
    moved by the tile's base, any base within ceil(max_disp)): every tap
    of every site whose node origin passes the window test lies in its
    tile's patch, the patch fits the shared-memory budget, and each patch
    cell folds into the axis; the scattered box design's margins hold
    every tap of a point in its box; then the fixed-point push of a 1-D
    warp along this axis within the gate of the float64 plain push."""
    smin, smax = window_range(order, md)
    span = smax - smin
    for cap, bases in ((None, (0,)), (8, (-math.ceil(md), 0,
                                          math.ceil(md)))):
        T, E = cuda_warp.push_tile((n, n, n), (span,) * 3,
                                   cap=None if cap is None else (cap,) * 3)
        assert cap is None or max(T) <= cap
        # the least patch, a one-site tile's, picks the budget
        least = cuda_warp._patch_bytes((1 + span,) * 3)
        if E is None:
            assert least > cuda_warp.WIDE_BYTES
            continue
        assert cuda_warp._patch_bytes(E) <= (
            cuda_warp.PATCH_BYTES if least <= cuda_warp.PATCH_BYTES
            else cuda_warp.WIDE_BYTES)
        assert E[0] == T[0] + span and math.prod(T) <= 4096
        for t, base in itertools.product(range(-(-n // T[0])), bases):
            sites = np.arange(t * T[0], min((t + 1) * T[0], n))
            d0 = np.arange(smin, smax - order + 1) + base
            u = (sites[:, None, None] + d0[None, :, None]
                 + np.arange(order + 1)[None, None, :])
            cell = u - (t * T[0] + smin + base)
            assert cell.min() >= 0 and cell.max() < E[0]
            folded = fold_index(u, n, bound)
            assert folded.min() >= 0 and folded.max() < n
            sign = fold_sign(u, n, bound, np.float64)
            assert sign is None or set(np.unique(sign)) <= {-1.0, 0.0, 1.0}
    lo, hi = splat_margins(order)
    g = torch.tensor(np.random.default_rng(n).uniform(0, n - 1, 4000),
                     dtype=torch.float32)
    n0, _ = node_origin(g, order)
    for box in (8, 16):
        origin = torch.div(torch.floor(g), box, rounding_mode="floor") \
            * box + lo
        assert torch.all(n0 >= origin)
        assert torch.all(n0 + order < origin + box + hi - lo)
    grid = warp_grid((n,), max(md, 0.5), B=2, seed=n + order)
    vals = spanning_values((2, 2, n), seed=bound)
    out = emulate(vals, grid, (n,), (order,), (bound,), 1, "push", md)[0]
    assert_gate(out, tw._push_impl_torch(vals, grid, (order,), (bound,), 1,
                                         md))


# 3-D: shape, bounds, orders, max_disp; lifted 1-D / 2-D volumes have
# size-1 axes of order 0
VOLUMES = [
    ((13, 9, 11), (3, 6, 0), (3, 3, 3), 1.5),
    ((10, 7, 9), (6, 1, 4), (1, 2, 5), 1.0),
    ((9, 12, 5), (2, 5, 6), (3, 0, 7), 2.0),
    ((1, 1, 23), (1, 1, 6), (0, 0, 3), 4.0),     # 1-D, lifted
    ((1, 14, 11), (1, 3, 4), (0, 3, 1), 2.0),    # 2-D, lifted
]


@pytest.mark.parametrize("shape,bounds,orders,md", VOLUMES)
def test_fixed_point_splats_match_jax(shape, bounds, orders, md):
    """The emulation against the JAX package's float64 splats: the
    scattered push and pushgrad (``ndkernels.push_core`` /
    ``pushgrad_core``) of a cloud with outliers; the scattered pushhess
    (the JAX package has none) and the dense push and pushgrad against
    the port's float64 plain versions, which ``test_torch_pushpull.py`` /
    ``test_torch_adjoint.py`` hold to JAX (the JAX window splats run op
    by op here, seconds each); all at the gate."""
    grid = warp_grid(shape, md)
    rng = np.random.default_rng(7)
    inp = torch.tensor(rng.standard_normal((1, 2) + shape))
    ct = torch.tensor(rng.standard_normal((1, 2) + shape + (3,)))
    for spec, vals, ref in [("push", inp, tw._push_impl_torch),
                            ("pushgrad", ct, tw._pushgrad_impl_torch)]:
        out = emulate(vals, grid, shape, orders, bounds, 2, spec, md)[0]
        assert_gate(out, ref(vals, grid, orders, bounds, 2, md))
    pts = cloud(shape, 150, B=1, seed=3)
    for k, (spec, ref) in enumerate([("push", jnd.push_core),
                                     ("pushgrad", jnd.pushgrad_core),
                                     ("pushhess", None)]):
        vals = torch.tensor(rng.standard_normal((1, 2, 150) + (3,) * k))
        out = emulate(vals, pts, shape, orders, bounds, 0, spec)[0]
        if ref is None:
            want = tnd.pushhess_core(vals, pts, shape, orders, bounds, 0)[0]
        else:
            want = ref(jnp.asarray(vals[0].numpy()), jnp.asarray(
                pts[0].numpy()), shape, orders, bounds, 0)
        assert_gate(out[0], want)


@pytest.mark.parametrize("order", [0, 1, 3, 7])
@pytest.mark.parametrize("bound", range(7))
def test_scale_bounds_every_sum(order, bound):
    """The per-(b, c) scale against a float64 bound, for each spec on a
    cloud with outliers and values spanning 1e-3 to 1e3: S bounds the sum
    of |tap| of every voxel and of the whole slice (up to the float32
    rounding of the taps; the kernels keep a factor 2 below 2^63), S 2^k <=
    2^62 < 2 S 2^k, and the fixed point is within K S 2^-62 of the same
    float32 taps summed in float64 (K taps reach the voxel, each rounded by
    at most half a quantum 2^-k < 2 S 2^-62), plus the float32 rounding of
    the result."""
    shape = (6, 7, 5)
    pts = cloud(shape, 60, seed=order * 7 + bound)
    for k, spec in enumerate(("push", "pushgrad", "pushhess")):
        vals = spanning_values((2, 2, 60) + (3,) * k, seed=bound + 10 * k)
        out, exact, mag, count, S = emulate(vals, pts, shape, (order,) * 3,
                                            (bound,) * 3, 1, spec)
        _, kexp = splat_scale(vals, MASS[spec])
        assert torch.all(mag.sum(-1) <= S * (1 + 2.0 ** -20))
        hi = S * torch.pow(2.0, kexp.double())
        assert torch.all(hi <= 2.0 ** 62) and torch.all(2 * hi > 2.0 ** 62)
        bound_ = (count[:, None] * S[..., None] * 2.0 ** -62
                  + 2.0 ** -24 * exact.abs().reshape(mag.shape))
        err = (out.double() - exact).abs().reshape(mag.shape)
        assert torch.all(err <= bound_)


# An item the splat drops sets no scale: a point outside extrapolate=0's
# mask, or a dense site whose node origin leaves the window, with a value
# of 1e12, 1e30 (orders above the rest of its slice), inf or NaN.
DROPPED = [1e12, 1e30, math.inf, math.nan]


def dropped_case(kind, rng):
    """(grid, oshape, orders, bounds, extrapolate, max_disp, index of the
    dropped item, specs).  Scattered: 200 points in (9, 10, 11), cubic,
    dct2, extrapolate 0, and one at x = -50.  Dense: an 8^3 push, linear,
    dct2, ``max_disp=2``, one site moved 4.9 voxels along z (inside the
    volume, outside the window)."""
    if kind == "scattered":
        ish = (9, 10, 11)
        pts = rng.uniform(0, np.asarray(ish) - 1, (1, 201, 3))
        pts[0, 200] = (-50.0, 5.0, 5.0)
        return (torch.tensor(pts).float().double(), ish, (3,) * 3, (3,) * 3,
                0, None, 200, ("push", "pushgrad", "pushhess"))
    ish = (8, 8, 8)
    grid = warp_grid(ish, 2.0, seed=5)
    grid[0, 3, 4, 1, 2] = 1.0 + 4.9
    return (grid.float().double(), ish, (1,) * 3, (3,) * 3, 1, 2.0,
            (3 * 8 + 4) * 8 + 1, ("push", "pushgrad"))


def jax_push(vals, grid, ish, orders, ex, md):
    """The JAX package's ``grid_push`` of (B, C, P) values at the points
    (B, P, D) of a cloud onto ``ish`` (its layout: points (B, P, 1, 1,
    D)) or, with ``md``, of a dense warp: float64 on the CPU (the generic
    tier's plain core, the window splat)."""
    import interpol_tpu as itp
    kw = dict(interpolation=list(orders), bound="dct2", extrapolate=bool(ex))
    if md is not None:
        return itp.grid_push(vals.numpy(), grid.numpy(), max_disp=md, **kw)
    B, C, P = vals.shape
    D = grid.shape[-1]
    return itp.grid_push(vals.numpy().reshape((B, C, P) + (1,) * (D - 1)),
                         grid.numpy().reshape((B, P) + (1,) * (D - 1) + (D,)),
                         shape=ish, **kw)


@pytest.mark.parametrize("v", DROPPED)
@pytest.mark.parametrize("kind", ["scattered", "dense"])
def test_dropped_item_sets_no_scale(kind, v):
    """The kernels' arithmetic with the value v at a dropped item of
    channel 0: every spec equal bit for bit to the same call with 0 there
    (the item adds nothing, not even to its slice's scale); for a finite v
    the push within 1e-5 * max(1, max|ref|) of the JAX package's
    ``grid_push`` of the same values (CPU, float64), where a scale over
    every value loses the whole slice at 1e30."""
    rng = np.random.default_rng(0)
    grid, ish, orders, bounds, ex, md, drop, specs = dropped_case(kind, rng)
    P = math.prod(grid.shape[1:-1])
    D = len(ish)
    for k, spec in enumerate(specs):
        shape = (1, 2) + tuple(grid.shape[1:-1]) + (D,) * k
        vals = torch.tensor(rng.standard_normal(shape))
        keep = tap_terms(vals, grid, ish, orders, bounds, ex, spec,
                         torch.float64, md)[2]
        assert keep.sum() == P - 1 and not keep[0, drop]
        zero = vals.clone()
        zero.reshape((2, P) + (D,) * k)[0, drop] = 0.0
        big = zero.clone()
        big.reshape((2, P) + (D,) * k)[0, drop] = v
        out = emulate(big, grid, ish, orders, bounds, ex, spec, md)[0]
        assert torch.equal(out, emulate(zero, grid, ish, orders, bounds, ex,
                                        spec, md)[0])
        if spec == "push" and math.isfinite(v):
            ref = jax_push(big, grid, ish, orders, ex, md)
            assert_gate(out, ref)
            # the scale over every value, as before: S of channel 0 is
            # about v, its quantum 2^-k far above the slice's taps
            _, k_all = splat_scale(big, MASS[spec])
            _, k_kept = splat_scale(big, MASS[spec], keep)
            assert k_all[0, 0] < k_kept[0, 0] - 30
            assert k_all[0, 1] == k_kept[0, 1]


@pytest.mark.parametrize("spec", ["push", "pushgrad", "pushhess"])
def test_every_item_kept_keeps_the_scale(spec):
    """Where every item is kept (extrapolate=True, a flow within
    ``max_disp``), the scale over the kept items is the scale over every
    value, S and k, so such a splat keeps its bits."""
    k = ("push", "pushgrad", "pushhess").index(spec)
    shape = (6, 7, 5)
    cases = [(cloud(shape, 60, seed=k), None)]
    if spec != "pushhess":
        cases.append((warp_grid(shape, 1.5, B=2, seed=k), 1.5))
    for grid, md in cases:
        P = math.prod(grid.shape[1:-1])
        vals = spanning_values((2, 3, P) + (3,) * k, seed=k)
        keep = tap_terms(vals, grid, shape, (3,) * 3, (3,) * 3, 1, spec,
                         torch.float64, md)[2]
        assert keep.all()
        S_all, k_all = splat_scale(vals, MASS[spec])
        S_kept, k_kept = splat_scale(vals, MASS[spec], keep)
        assert torch.equal(S_all, S_kept) and torch.equal(k_all, k_kept)
