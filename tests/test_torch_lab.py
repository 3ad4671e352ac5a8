"""The kernel lab of the PyTorch port (``ops/lab.py``: the plain versions of
``csrc/lab.cu``'s kernels) against the JAX package's lab kernels
(``scripts/tpu_kernel_lab*.py``), run through ``pl.pallas_call(...,
interpret=True)`` on the CPU at tiny shapes.

Tolerances, each with its reason:
- float32 FMA chains: 1e-5 * max(1, max|ref|) (``bench.py``'s float32 gate):
  the port rounds each step once (a fused multiply-add), the interpreted
  JAX kernel may round the product and the sum apart;
- bf16 FMA chains: 2^-5 * max(1, max|ref|): the JAX kernel rounds the bf16
  product and then the bf16 sum, the port (``__hfma2``) once, so a chain of
  bf16 accumulators can step apart by a few bf16 rounding steps (2^-8);
- the lane gathers: exact (the same float32 sums in the same order);
- the bf16 pull against ``_kernel_v4``: 1e-5 * max(1, max|ref|), the
  float32 gate: both round the float32 weights and values to bf16 and sum
  their products (exact in float32) in float32, in other orders (XLA keeps
  the bf16 products unrounded, ``xla_allow_excess_precision``, which the
  exact product makes the same thing).

The lab scripts were written when ``pallas_warp._coef_planes`` returned the
weight planes alone; it now returns (weights, gradients, Hessians), so the
test binds the older return in the lab modules' namespace to run their
``_kernel_v3`` / ``_kernel_v4`` bodies as written.
"""
import importlib
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from interpol_tpu_torch.ops import lab
from interpol_tpu_torch.ops.window import _pull_impl_torch

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture(scope="module")
def labs():
    """The JAX lab modules (``scripts/`` put on the path to import them)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return {name: importlib.import_module(name) for name in (
        "tpu_kernel_lab", "tpu_kernel_lab2", "tpu_kernel_lab4",
        "tpu_kernel_lab5")}


def _rows(kernel, shape, *args):
    """A (rows, ...) kernel over row blocks, interpreted, as the lab's FMA
    probes call theirs."""
    spec = pl.BlockSpec((1,) + tuple(shape[1:]), lambda i: (i, 0, 0))
    return np.asarray(pl.pallas_call(
        kernel, grid=(shape[0],), in_specs=[spec] * len(args),
        out_specs=spec, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True)(*args))


def _ab(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    lim = tol * max(1.0, np.abs(ref).max())
    assert np.abs(out - ref).max() <= lim, (np.abs(out - ref).max(), lim)


def test_fma_probe_matches_jax(labs):
    # fma_probe: one chain from 0, reps steps
    L1 = labs["tpu_kernel_lab"]
    shape = (2, 8, 128)
    a, b = _ab(shape)
    for reps in (1, 16, 64):
        ref = _rows(partial(L1._kernel_fma, reps=reps), shape, a, b)
        out = lab.fma(torch.tensor(a), torch.tensor(b), reps, nacc=1,
                      zero_init=True)
        _close(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_probe2_matches_jax(labs, dtype):
    # fma_probe2 / lab2's fma2bf: 8 chains from a * (k + 1), a fori_loop
    L1 = labs["tpu_kernel_lab"]
    shape = (2, 8, 128)
    a, b = _ab(shape, 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    for reps in (8, 64):
        ref = _rows(partial(L1._kernel_fma2, reps=reps, dtype=jdt), shape,
                    a, b)
        out = lab.fma(torch.tensor(a), torch.tensor(b), reps, nacc=8,
                      dtype=tdt)
        _close(out.numpy(), ref, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_probe3_matches_jax(labs, dtype):
    # fma_probe3: nacc chains unrolled (nacc 4, 8 and fma3n16's 16)
    L1 = labs["tpu_kernel_lab"]
    shape = (2, 16, 128)
    a, b = _ab(shape, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    for nacc in (4, 8, 16):
        ref = _rows(partial(L1._kernel_fma3, reps=4 * nacc, nacc=nacc,
                            dtype=jdt), shape, a, b)
        out = lab.fma(torch.tensor(a), torch.tensor(b), 4 * nacc,
                      nacc=nacc, dtype=tdt)
        _close(out.numpy(), ref, tol)


def test_fma_plain_rounds_each_step_once():
    # float32 chains: each step is the float64 value rounded to float32;
    # bf16 chains: to bf16, which torch's own float32 -> bf16 cast agrees
    # with on values that are exact in float32
    a, b = _ab((4, 64), 3)
    ta, tb = torch.tensor(a), torch.tensor(b)
    acc = np.zeros_like(a, dtype=np.float64)
    for _ in range(5):
        acc = np.float32(acc + a.astype(np.float64) * b).astype(np.float64)
    np.testing.assert_array_equal(
        lab.fma_plain(ta, tb, 5, nacc=1, zero_init=True).numpy(),
        acc.astype(np.float32))
    x = torch.tensor(a).double() * 3.0
    np.testing.assert_array_equal(
        lab._round_bf16(x).numpy(),
        x.float().to(torch.bfloat16).double().numpy())
    # ties go to even: 1 + 2^-8 lies halfway between 1 and 1 + 2^-7
    t = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8)],
                     dtype=torch.float64)
    np.testing.assert_array_equal(lab._round_bf16(t).numpy(),
                                  [1.0, 1 + 2.0 ** -6, -1.0])


def test_gather_probe_matches_jax(labs):
    # gather_probe: out[x, y, z] = v[x, y, clip(int(gz))], one read
    L1 = labs["tpu_kernel_lab"]
    rng = np.random.default_rng(4)
    for N in (16, 40):
        v = rng.standard_normal((8, 8, 2 * N)).astype(np.float32)
        gz = rng.uniform(-3, 2 * N + 3, (8, 8, N)).astype(np.float32)
        ref = pl.pallas_call(
            L1._kernel_gather, interpret=True,
            out_shape=jax.ShapeDtypeStruct((8, 8, N), jnp.float32))(
                jnp.asarray(gz), jnp.asarray(v))
        idx = lab.lane_index(torch.tensor(gz), 2 * N)
        out = lab.gather(torch.tensor(v), idx, reps=1)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_lane_gather_matches_jax(labs):
    # lab5's probe: reps chained reads at (idx + i) % T, summed in order
    L5 = labs["tpu_kernel_lab5"]
    rng = np.random.default_rng(5)
    # tab 8, reps 11: T % 4 == 0 (the card's 16-byte path) and every run
    # wraps past the row's end, some twice
    for tab, reps, rows in [(40, 5, 2), (130, 64, 1), (7, 9, 3), (8, 11, 2)]:
        table = rng.standard_normal((rows, 8, tab)).astype(np.float32)
        idx = rng.integers(0, tab, (rows, 8, 128)).astype(np.int32)
        spec_t = pl.BlockSpec((1, 8, tab), lambda i: (i, 0, 0))
        spec_i = pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))
        ref = pl.pallas_call(
            partial(L5._kernel, reps=reps), grid=(rows,),
            in_specs=[spec_t, spec_i], out_specs=spec_i, interpret=True,
            out_shape=jax.ShapeDtypeStruct((rows, 8, 128), jnp.float32))(
                jnp.asarray(table), jnp.asarray(idx))
        out = lab.gather(torch.tensor(table), torch.tensor(idx), reps)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # indices outside [0, T) wrap as a floor-mod, as jnp's % does
    t = torch.arange(10.0).reshape(1, 1, 10)
    i = torch.tensor([[[-1, 10, 23]]], dtype=torch.int32)
    np.testing.assert_array_equal(lab.gather_plain(t, i, 2).numpy(),
                                  [[[9.0 + 0.0, 0.0 + 1.0, 3.0 + 4.0]]])


@pytest.mark.parametrize("smem", [True, False])
def test_gather_and_path_on_the_cpu_is_plain(smem):
    # a CPU table, aligned or one float into its buffer, takes the plain
    # version and says so: the card's paths are the C entry's to report
    rng = np.random.default_rng(2)
    flat = torch.tensor(rng.standard_normal(3 * 2 * 8 + 1),
                        dtype=torch.float32)
    idx = torch.tensor(rng.integers(-8, 16, (3, 2, 5)), dtype=torch.int32)
    for table in (flat[:-1].view(3, 2, 8), flat[1:].view(3, 2, 8)):
        out, path = lab.gather_and_path(table, idx, 11, smem)
        assert path == "plain"
        assert torch.equal(out, lab.gather_plain(table, idx, 11))


def _v4_case(N, md, seed, break_contract=False):
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((N, N, N)).astype(np.float32)
    ident = np.stack(np.meshgrid(*[np.arange(N)] * 3, indexing="ij"),
                     -1).astype(np.float32)
    d = rng.uniform(-md, md, ident.shape)
    if break_contract:
        d = d * np.where(rng.uniform(size=d.shape) < 0.2, 2.5, 1.0)
    return vol, (ident + d).astype(np.float32)


def _jax_v4(labs, monkeypatch, vol, grid, md, kernel="v4"):
    """lab2's ``make_kernel_call`` pallas_call of ``_kernel_v4`` (or lab 1's
    ``_kernel_v3`` in float32), interpreted, on lab2's prologue (cubic,
    dct2, tile (8, 8, 128))."""
    from interpol_tpu.ops.pallas_warp import _coef_planes as planes
    L1, L2 = labs["tpu_kernel_lab"], labs["tpu_kernel_lab2"]
    monkeypatch.setattr(L2, "_coef_planes",
                        lambda *a, **k: planes(*a, **k)[0])
    monkeypatch.setattr(L1, "_coef_planes",
                        lambda *a, **k: planes(*a, **k)[0])
    N = vol.shape[0]
    o, b, tile = (3,) * 3, (3,) * 3, (8, 8, 128)
    vpad, g = L2.prologue(jnp.asarray(vol), jnp.asarray(grid), o, b, md,
                          tile)
    ranges = tuple(L2.window_range(3, md) for _ in range(3))
    S = tuple(r[1] - r[0] + 1 for r in ranges)
    box = tuple(-(-(t + s - 1) // a) * a
                for t, s, a in zip(tile, S, (1, 8, 128)))
    shape_a = L2._aligned((N,) * 3, tile)
    kern = L2._kernel_v4 if kernel == "v4" else partial(
        L1._kernel_v3, mul_dtype=jnp.float32)
    gspec = pl.BlockSpec(tile, lambda i, j, k: (i, j, k),
                         memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        partial(kern, orders=o, ranges=ranges, tile=tile, box_shape=box),
        grid=tuple(a // t for a, t in zip(shape_a, tile)),
        in_specs=[gspec] * 3 + [pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=gspec, interpret=True,
        out_shape=jax.ShapeDtypeStruct(shape_a, jnp.float32),
        scratch_shapes=[pltpu.VMEM(box, jnp.float32),
                        pltpu.SemaphoreType.DMA],
    )(g[..., 0], g[..., 1], g[..., 2], vpad)
    return np.asarray(out)[:N, :N, :N]


@pytest.mark.parametrize("break_contract", [False, True])
def test_pull_bf16_matches_jax_v4(labs, monkeypatch, break_contract):
    # _kernel_v4 at N 16 (two tiles along x and y, one along z), cubic,
    # dct2, max_disp 2; with break_contract a fifth of the displacements
    # reach 2.5 max_disp, and both drop those samples' taps
    md = 2.0
    vol, grid = _v4_case(16, md, 6, break_contract)
    ref = _jax_v4(labs, monkeypatch, vol, grid, md)
    opts = ((3, 3, 3), (3, 3, 3), 1, md)
    tv, tg = torch.tensor(vol)[None, None], torch.tensor(grid)[None]
    out = lab.pull_bf16(tv, tg, *opts)[0, 0].numpy()
    _close(out, ref, 1e-5)
    f32 = _pull_impl_torch(tv, tg, *opts)[0, 0].numpy()
    # the same samples read 0 as the float32 pull (kernel 1's window)
    np.testing.assert_array_equal(out == 0, f32 == 0)
    assert np.abs(out - f32).max() > 1e-4   # the bf16 rounding is there
    if not break_contract:
        # and the float32 pull is lab 1's _kernel_v3 (kernel 1a's function)
        ref3 = _jax_v4(labs, monkeypatch, vol, grid, md, kernel="v3")
        _close(f32, ref3, 1e-5)


def test_pull_bf16_other_orders_and_bounds():
    # orders 0-3 and the fold signs (dst2, zero), extrapolate 0: the bf16
    # pull stays within bf16 rounding of the float32 pull
    vol, grid = _v4_case(10, 1.5, 7)
    tv, tg = torch.tensor(vol)[None, None], torch.tensor(grid)[None]
    for orders, bounds, ex in [((0, 1, 2), (5, 0, 6), 0),
                               ((3, 2, 1), (2, 4, 3), 1)]:
        opts = (orders, bounds, ex, 1.5)
        out = lab.pull_bf16(tv, tg, *opts)
        ref = _pull_impl_torch(tv, tg, *opts)
        _close(out.numpy(), ref.numpy(), 2.0 ** -6)
        np.testing.assert_array_equal(out.numpy() == 0, ref.numpy() == 0)


def _pull_bf16_signs_in_weights(inp, grid, orders, bounds, ex, md):
    """The premise of ``lab_pull_bf16``'s design: the plain pull over the
    volume rounded to bf16 first, unsigned, with each tap's fold signs in
    its weights (z: the bf16 weight times s_z; x * y: (w_x s_x) (w_y
    s_y)), in :func:`lab.pull_bf16_plain`'s order of sums."""
    from interpol_tpu_torch.ops.bounds import fold_index, fold_sign
    from interpol_tpu_torch.ops.window import (_coef_fields, _mask,
                                               _shift_ranges, _slice_pad,
                                               _window_geom)
    ishape = tuple(inp.shape[-3:])
    ranges = _shift_ranges(orders, md, None, 3)
    lo, hi = _window_geom(ranges)
    vb = inp.to(torch.bfloat16).float()
    signs = []
    for d in range(3):
        n = ishape[d]
        idx = np.arange(-lo[d], n + hi[d])
        vb = torch.index_select(vb, 2 + d,
                                torch.as_tensor(fold_index(idx, n, bounds[d])))
        s = fold_sign(idx, n, bounds[d], np.float32)
        signs.append(torch.ones(idx.size) if s is None else torch.as_tensor(s))

    def sign(d, s):
        """The fold sign of the tap at p + s along axis d, as a field."""
        shape = [1, 1, 1, 1]
        shape[1 + d] = ishape[d]
        return signs[d][lo[d] + s:lo[d] + s + ishape[d]].reshape(shape)
    cx, cy, cz = _coef_fields(grid, orders, ranges, torch.float32)
    shifts = [range(r[0], r[1] + 1) for r in ranges]
    czs = [(c.to(torch.bfloat16).float() * sign(2, sz))[:, None]
           for c, sz in zip(cz, shifts[2])]
    out = None
    for ky, sy in enumerate(shifts[1]):
        for kx, sx in enumerate(shifts[0]):
            zacc = None
            for kz, sz in enumerate(shifts[2]):
                t = czs[kz] * _slice_pad(vb, (sx, sy, sz), lo, ishape)
                zacc = t if zacc is None else zacc + t
            wxy = (cx[kx] * sign(0, sx)) * (cy[ky] * sign(1, sy))
            term = wxy[:, None] * zacc
            out = term if out is None else out + term
    mask = _mask(grid, ishape, ex, torch.float32, orders, md, None)
    return out if mask is None else out * mask[:, None]


# orders 0-3; bounds zero (0), dct2 (3), dst1 (4, sign -1 and 0), dft (6);
# extrapolation on (1) and off (0, 2); contract-breaking grids
@pytest.mark.parametrize("orders,bounds,ex,brk", [
    ((3, 3, 3), (4, 4, 4), 1, False), ((0, 1, 2), (0, 3, 6), 0, False),
    ((2, 3, 1), (6, 0, 4), 1, True), ((1, 0, 3), (3, 4, 0), 2, True),
    ((3, 2, 3), (0, 6, 3), 0, True)])
def test_pull_bf16_signs_in_weights_same_bits(orders, bounds, ex, brk):
    # round(s v) = s round(v) for a fold sign s in {-1, 0, 1}: the volume
    # rounded to bf16 once, the signs moved into the weights, gives
    # pull_bf16_plain's bits (the tap-then-round form)
    md = 1.5
    vol, grid = _v4_case(11, md, 8, brk)
    tv, tg = torch.tensor(vol)[None, None], torch.tensor(grid)[None]
    # half the samples pushed past the edges, where every fold shows
    tg = tg + torch.tensor(np.where(np.random.default_rng(9).uniform(
        size=grid.shape) < 0.5, 3.0, 0.0), dtype=torch.float32)[None]
    ref = lab.pull_bf16_plain(tv, tg, orders, bounds, ex, md)
    out = _pull_bf16_signs_in_weights(tv, tg, orders, bounds, ex, md)
    assert torch.equal(out, ref)
    assert (ref != 0).float().mean() > 0.05


# every bound (zero, replicate, dct1, dct2, dst1, dst2, dft), rows of 1, 2
# and 7 values (dst1 has no sign on a row of one), margins as the window
# of orders 0 / 1 / 3 at max_disp 2 and 5 gives them
@pytest.mark.parametrize("bound", range(7))
def test_pad_bf16_plain_matches_the_jax_fold(bound):
    # the bf16 pass of the pull: the JAX package's fold index and sign
    # along z (on numpy arrays), the value times its sign rounded to bf16
    # (as _kernel_v4 rounds each folded tap)
    from interpol_tpu.ops.bounds import fold_index, fold_sign
    rng = np.random.default_rng(10 + bound)
    for Z in (1, 2, 7):
        vol = rng.standard_normal((2, 3, Z)).astype(np.float32)
        for order, md in ((0, 2.0), (1, 5.0), (3, 2.0)):
            zlo, zhi = lab.pad_margins(order, md)
            i = np.arange(-zlo, Z + zhi)
            ref = vol[..., fold_index(i, Z, bound, xp=np)]
            sign = fold_sign(i, Z, bound, np.float32, xp=np)
            if sign is not None:
                ref = ref * sign
            ref = ref.astype(jnp.bfloat16).astype(np.float32)
            out = lab.pad_bf16(torch.tensor(vol), bound, zlo, zhi)
            assert out.dtype == torch.bfloat16
            assert out.shape == (2, 3, zlo + Z + zhi)
            np.testing.assert_array_equal(out.float().numpy(), ref)


def test_smooth_grid_matches_lab4(labs):
    L4 = labs["tpu_kernel_lab4"]
    for N, md in [(16, 2.0), (24, 4.0)]:
        np.testing.assert_array_equal(
            lab.smooth_grid(N, md, device="cpu").numpy(),
            np.asarray(L4.smooth_grid(N, md)))


def test_wrappers_on_cpu_launch_nothing_and_check_arguments():
    lab.reset_launches()
    a, b = (torch.tensor(x) for x in _ab((2, 4)))
    lab.fma(a, b, 8, nacc=4)
    lab.gather(a[None], torch.zeros((1, 2, 3), dtype=torch.int32))
    lab.pad_bf16(a, 3, 2, 4)
    assert not any(lab.LAUNCHES_BY_MODE.values())
    with pytest.raises(ValueError):
        lab.fma(a, b, 6, nacc=4)       # reps not a multiple of nacc
    with pytest.raises(ValueError):
        lab.fma(a, b, 6, nacc=3)
    with pytest.raises(ValueError):
        lab.fma(a, b[:1], 8)
    with pytest.raises(TypeError):
        lab.fma(a, b, 8, dtype=torch.float16)
    with pytest.raises(ValueError):
        lab.gather(a, torch.zeros((2, 3), dtype=torch.int32))
    with lab.uncounted():
        lab.LAUNCHES_BY_MODE["lab_fma_f32"] += 1
    assert lab.LAUNCHES_BY_MODE["lab_fma_f32"] == 0


def test_lab_tables_fit_the_card():
    # every shared-memory table fits a block; every variant divides its
    # reps among its chains
    for G, S, T, L, reps, smem in lab.GATHER_TABLES.values():
        assert not smem or S * T * 4 <= lab.SMEM_MAX
        assert max(G, S, T, L) < 2**31
    for shape, reps, nacc, dtype, _ in lab.FMA_VARIANTS.values():
        assert reps % nacc == 0 and nacc in lab.NACCS
        assert dtype == torch.float32 or np.prod(shape) % 2 == 0
    for blk in lab.PULL_BLOCKS:
        assert sum(blk) <= 8 and min(blk) >= 0
