"""The CUDA kernels against their plain PyTorch versions, on the card: the
dense warp's pull value / grad / hess (``csrc/warp.cu``), push and pushgrad
(``csrc/push.cu``), in plain and adaptive (``tile_spread``) mode, the
scattered gather (``csrc/gather.cu``) and splat (``csrc/splat.cu``), the
deterministic plain cores, the autograd Functions (second order included),
the train steps and the pyramid on them, and the prefilter (against the
CPU in float64, with TF32 on) and the label paths on the kernels, the
scattered tier's public functions (``ops/scattered.py``), and the splats'
scale over the kept items (1e30, inf or NaN at a dropped item changes no
bit) and launches past 65535 slices, channels or batches, and the kernel
lab's kernels (``csrc/lab.cu``) over every bound and mask, at element
counts no tile divides, and past 65535 batches and groups.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU
(the kernels have no CPU mode).  The file imports no JAX, so it also runs on
a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import math

import numpy as np
import pytest
import torch

import interpol_tpu_torch as itt
from interpol_tpu_torch import (PyramidModel, SVFModel, WarpModel,
                                grid_grad, grid_pull, grid_push, options,
                                register, svf_mse_loss)
from interpol_tpu_torch.ops import api, cuda_scattered, cuda_warp
from interpol_tpu_torch.ops import coeff as tc
from interpol_tpu_torch.ops import ndkernels as nd
from interpol_tpu_torch.ops import pushpull as tpp
from interpol_tpu_torch.ops import scattered as sc
from interpol_tpu_torch.ops import window as tw

pytestmark = pytest.mark.cuda

# float32 sums of at most 512 non-zero taps taken in another order than the
# plain version's (every kernel sums in a fixed order: two runs are equal)
REL_TOL = 1e-5
# a whole train step, card vs CPU: sums of many such terms
STEP_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def warp_case(device, ish, C=2, disp=1.5, seed=0, break_contract=0.0, B=1):
    rng = np.random.default_rng(seed)
    D = len(ish)
    inp = rng.standard_normal((B, C) + tuple(ish))
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    d = rng.uniform(-1, 1, (B,) + tuple(ish) + (D,)) * np.asarray(disp)
    if break_contract:
        d = d * np.where(rng.uniform(size=d.shape) < 0.2, break_contract,
                         1.0)
    kw = dict(dtype=torch.float32, device=device)
    return torch.as_tensor(inp, **kw), torch.as_tensor(ident + d, **kw)


def assert_close(out, ref, rel=REL_TOL):
    tol = rel * max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


CASES = [
    ((3, 3, 3), (3, 3, 3), 1, (11, 12, 13), 1.5, 0.0),
    ((1, 1, 1), (6, 6, 6), 0, (11, 12, 13), 1.5, 0.0),
    ((3, 2, 1), (0, 4, 5), 2, (19, 24, 37), 1.5, 0.0),
    ((0, 0, 0), (2, 1, 4), 1, (11, 12, 13), 1.5, 0.0),
    ((7, 5, 4), (4, 5, 6), 0, (11, 12, 13), 1.0, 0.0),
    ((3, 3, 3), (3, 3, 3), 1, (11, 12, 13), 1.0, 4.0),    # breaks max_disp
    ((2, 2, 2), (3, 2, 0), 1, (11, 12, 13), (0.5, 1.5, 1.0), 0.0),
    ((3, 1), (3, 0), 2, (30, 17), 1.5, 0.0),                # 2-D
    ((5,), (6,), 1, (40,), 1.5, 0.0),                       # 1-D
]


@pytest.mark.parametrize("orders,bounds,ex,ish,md,brk", CASES)
def test_kernel_matches_plain(cuda_device, orders, bounds, ex, ish, md,
                              brk):
    inp, grid = warp_case(cuda_device, ish, disp=md, break_contract=brk,
                          B=2)
    before = cuda_warp.LAUNCHES
    val, g = cuda_warp.warp_cuda(inp, grid, orders, bounds, ex, md,
                                 value=True, grad=True)
    assert cuda_warp.LAUNCHES == before + 1
    assert_close(val, tw._pull_impl_torch(inp, grid, orders, bounds, ex, md))
    assert_close(g, tw._grad_impl_torch(inp, grid, orders, bounds, ex, md))


@pytest.mark.parametrize("orders,bounds,ex,ish,md,brk", CASES)
def test_second_order_and_push_kernels_match_plain(cuda_device, orders,
                                                   bounds, ex, ish, md,
                                                   brk):
    inp, grid = warp_case(cuda_device, ish, disp=md, break_contract=brk,
                          B=2)
    ct = torch.randn(inp.shape + (len(ish),), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(0))
    opts = (orders, bounds, ex, md)
    before = dict(cuda_warp.LAUNCHES_BY_MODE)
    h = cuda_warp.hess_cuda(inp, grid, *opts)
    p = cuda_warp.push_cuda(inp, grid, *opts)
    pg = cuda_warp.push_cuda(ct, grid, *opts, deriv=True)
    for mode in ("hess", "push", "pushgrad"):
        assert cuda_warp.LAUNCHES_BY_MODE[mode] == before[mode] + 1
    assert torch.equal(h, h.transpose(-1, -2))
    assert_close(h, tw._hess_impl_torch(inp, grid, *opts))
    assert_close(p, tw._push_impl_torch(inp, grid, *opts))
    assert_close(pg, tw._pushgrad_impl_torch(ct, grid, *opts))


def test_adjoint_identities(cuda_device):
    inp, grid = warp_case(cuda_device, (19, 24, 37), C=3, B=2)
    opts = ((3, 2, 1), (0, 4, 5), 2, 1.5)
    v = torch.randn_like(inp)
    U = torch.randn(inp.shape + (3,), device=cuda_device)
    pv, gv = cuda_warp.warp_cuda(v, grid, *opts, value=True, grad=True)
    for a, b in [(cuda_warp.push_cuda(inp, grid, *opts) * v, inp * pv),
                 (cuda_warp.push_cuda(U, grid, *opts, deriv=True) * v,
                  U * gv)]:
        a, b = a.double(), b.double()
        assert abs(a.sum() - b.sum()).item() \
            <= REL_TOL * b.abs().sum().item()


def test_train_steps_card_match_cpu(cuda_device):
    rng = np.random.default_rng(2)
    params = 0.5 * rng.standard_normal((2, 4, 4, 4, 3))
    moving = rng.standard_normal((2, 3, 12, 10, 16))
    out = []
    for device in (cuda_device, "cpu"):
        mv = torch.as_tensor(moving, dtype=torch.float32, device=device)
        warp = WarpModel((12, 10, 16), (4, 4, 4), max_disp=1.0, batch=2,
                         device=device)
        svf = SVFModel((12, 10, 16), (4, 4, 4), max_disp=1.0, steps=3,
                       batch=2, device=device)
        warp.load_jax_params(params)
        svf.load_jax_params(params)
        loss_w = torch.mean((warp(mv) - 0.9 * mv) ** 2)
        loss_s = svf_mse_loss(svf, mv, 0.9 * mv, jac_weight=0.1)
        out.append([t.detach().cpu() for t in (
            loss_w, *torch.autograd.grad(loss_w, [warp.params]),
            loss_s, *torch.autograd.grad(loss_s, [svf.params]))])
    for a, b in zip(*out):
        assert_close(a, b, STEP_TOL)


def test_models_live_on_the_card(cuda_device):
    assert WarpModel((8, 8, 8), (2, 2, 2)).params.is_cuda
    assert SVFModel((8, 8, 8), (2, 2, 2)).params.is_cuda


def test_api_runs_the_kernel(cuda_device):
    inp, grid = warp_case(cuda_device, (9, 10, 11), C=3)
    before = cuda_warp.LAUNCHES
    out = grid_pull(inp[0], grid[0], 3, "dct2", True, max_disp=1.5)
    g = grid_grad(inp[0], grid[0], 3, "dct2", True, max_disp=1.5)
    assert cuda_warp.LAUNCHES == before + 2
    opts = ((3, 3, 3), (3, 3, 3), 1, 1.5)
    assert_close(out, tw._pull_impl_torch(inp, grid, *opts)[0])
    assert_close(g, tw._grad_impl_torch(inp, grid, *opts)[0])


def test_warp_model_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(1)
    params = 0.5 * rng.standard_normal((2, 4, 4, 4, 3))
    moving = rng.standard_normal((2, 3, 12, 10, 16))
    outs = []
    for device in (cuda_device, "cpu"):
        model = WarpModel((12, 10, 16), (4, 4, 4), max_disp=1.0, batch=2,
                          device=device)
        model.load_jax_params(params)
        with torch.no_grad():
            outs.append(model(torch.as_tensor(
                moving, dtype=torch.float32, device=device)).cpu())
    assert_close(outs[0], outs[1])


def test_wrapper_refuses(cuda_device):
    inp, grid = warp_case(cuda_device, (4, 5, 6))
    opts = ((3, 3, 3), (3, 3, 3), 1, 1.5)
    with pytest.raises(TypeError, match="float32"):
        tw.pull_window(inp.double(), grid.double(), *opts)
    for call in (cuda_warp.hess_cuda, cuda_warp.push_cuda):
        with pytest.raises(TypeError, match="float32"):
            call(inp.double(), grid.double(), *opts)
        with pytest.raises(ValueError, match="contiguous"):
            call(inp.transpose(2, 3), grid, *opts)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_warp.warp_cuda(inp.transpose(2, 3), grid, *opts)
    # a direct kernel call would lose the gradient; the Functions do not
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_warp.warp_cuda(inp.clone().requires_grad_(), grid, *opts)
    out = tw.pull_window(inp.clone().requires_grad_(), grid, *opts)
    assert out.requires_grad


# scattered clouds: orders, bounds, extrapolate, ishape, points
SC_CASES = [
    ((3, 3, 3), (3, 3, 3), 1, (21, 22, 23), 5000),
    ((3, 2, 1), (3, 0, 6), 1, (9, 10, 11), 300),
    ((0, 5, 3), (4, 6, 0), 2, (8, 9, 10), 300),
    ((7, 7, 7), (1, 2, 5), 0, (7, 8, 9), 150),
    ((1, 3), (4, 3), 0, (12, 10), 200),                     # 2-D
    ((2,), (6,), 2, (15,), 60),                             # 1-D
]


def sc_case(device, ish, P, B=2, C=2, seed=0):
    """Volume and a cloud uniform over [-2.5, n + 1.5]: outliers on each
    side of every axis."""
    rng = np.random.default_rng(seed)
    kw = dict(dtype=torch.float32, device=device)
    inp = torch.as_tensor(rng.standard_normal((B, C) + tuple(ish)), **kw)
    g = -2.5 + (np.asarray(ish) + 4.0) * rng.uniform(size=(B, P, len(ish)))
    return inp, torch.as_tensor(g, **kw)


@pytest.mark.parametrize("orders,bounds,ex,ish,P", SC_CASES)
def test_scattered_kernels_match_plain(cuda_device, orders, bounds, ex, ish,
                                       P):
    inp, grid = sc_case(cuda_device, ish, P)
    D = len(ish)
    opts = (orders, bounds, ex)
    gen = torch.Generator(cuda_device).manual_seed(1)
    vals = [torch.randn((2, 2, P) + (D,) * k, device=cuda_device,
                        generator=gen) for k in range(3)]
    before = dict(cuda_scattered.LAUNCHES_BY_MODE)
    v, g, _ = cuda_scattered.gather_cuda(inp, grid, *opts, value=True,
                                         grad=True)
    v1 = cuda_scattered.gather_cuda(inp, grid, *opts)[0]
    g1 = cuda_scattered.gather_cuda(inp, grid, *opts, value=False,
                                    grad=True)[1]
    _, g2, h = cuda_scattered.gather_cuda(inp, grid, *opts, value=False,
                                          grad=True, hess=True)
    h1 = cuda_scattered.gather_cuda(inp, grid, *opts, value=False,
                                    hess=True)[2]
    splats = {spec: cuda_scattered.splat_cuda(vals[k], grid, ish, *opts,
                                              spec=spec)
              for k, spec in enumerate(("push", "pushgrad", "pushhess"))}
    for mode in cuda_scattered.LAUNCHES_BY_MODE:
        assert cuda_scattered.LAUNCHES_BY_MODE[mode] == before[mode] + 1
    # the fused modes are the single ones, bit for bit
    assert torch.equal(v, v1) and torch.equal(g, g1) and torch.equal(g, g2)
    assert torch.equal(h, h1) and torch.equal(h, h.transpose(-1, -2))
    assert_close(v, nd.pull_core(inp, grid, *opts))
    assert_close(g, nd.grad_core(inp, grid, *opts))
    assert_close(h, nd.hess_core(inp, grid, *opts))
    for k, (spec, core) in enumerate([("push", nd.push_core),
                                      ("pushgrad", nd.pushgrad_core),
                                      ("pushhess", nd.pushhess_core)]):
        assert_close(splats[spec], core(vals[k], grid, ish, *opts))
        # fixed-point sums: a second run gives the same bits
        again = cuda_scattered.splat_cuda(vals[k], grid, ish, *opts,
                                          spec=spec)
        assert torch.equal(again, splats[spec])


def test_splat_onto_another_shape(cuda_device):
    # the API's cloud layout: grid (B, P, 1, 1, 3), values (B, C, P, 1, 1)
    _, grid = sc_case(cuda_device, (9, 10, 11), 400)
    vals = torch.randn((2, 1, 400), device=cuda_device)
    out = grid_push(vals[..., None, None], grid[:, :, None, None],
                    shape=(13, 7, 12), interpolation=3, bound="dct2",
                    extrapolate=True)
    assert_close(out, nd.push_core(vals, grid, (13, 7, 12), (3,) * 3,
                                   (3,) * 3, 1))


def test_push_kernels_are_deterministic(cuda_device):
    inp, grid = warp_case(cuda_device, (33, 34, 35), C=3, disp=4.0, B=2)
    opts = ((3, 3, 3), (3, 3, 3), 1, 4.0)
    ct = torch.randn(inp.shape + (3,), device=cuda_device)
    for args, kw in [((inp,), {}), ((ct,), dict(deriv=True))]:
        first = cuda_warp.push_cuda(*args, grid, *opts, **kw)
        for _ in range(3):
            assert torch.equal(cuda_warp.push_cuda(*args, grid, *opts, **kw),
                               first)


# the fixed-point splat (csrc/fixed_splat.cuh): orders 0-7 over the bounds,
# B=2, C=3; odd shapes (several 8^3 site tiles), a shape under one tile,
# dft with odd tile counts (3 along y and z), max_disp 0 and 8, adaptive,
# 2-D
DENSE_SPLATS = [
    ((0, 0, 0), (0, 0, 0), 1, (19, 21, 37), 1.5, None),
    ((1, 1, 1), (1, 1, 1), 0, (5, 7, 9), 1.5, None),
    ((2, 2, 2), (2, 2, 2), 2, (19, 21, 37), 0.0, None),
    ((3, 3, 3), (6, 6, 6), 1, (48, 20, 17), 2.0, None),
    ((4, 4, 4), (4, 4, 4), 1, (17, 18, 19), 1.0, None),
    ((5, 5, 5), (5, 5, 5), 0, (20, 9, 33), 1.0, None),
    ((6, 6, 6), (3, 0, 6), 1, (11, 12, 13), 0.5, None),
    ((7, 7, 7), (6, 5, 4), 2, (9, 10, 11), 1.0, None),
    ((3, 3, 3), (3, 3, 3), 1, (20, 18, 24), 8.0, None),
    ((3, 3, 3), (3, 3, 3), 1, (20, 17, 40), 2.0, 0.5),
    ((1, 3, 1), (6, 3, 6), 0, (33, 18, 35), 2.0, (1.0, 0.5, 1.0)),
    ((1, 3), (6, 3), 1, (33, 18), 2.0, None),
]


@pytest.mark.parametrize("orders,bounds,ex,ish,md,sp", DENSE_SPLATS)
def test_dense_splat_matches_plain_and_repeats(cuda_device, orders, bounds,
                                               ex, ish, md, sp):
    # max_disp 0: displacements of 0.5 break it (taps are dropped)
    inp, grid = warp_case(cuda_device, ish, C=3, disp=md or 0.5, B=2)
    if sp is not None:
        grid[0, :8] += 1.0          # tiles with different bases
    ct = torch.randn(inp.shape + (len(ish),), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(4))
    opts = (orders, bounds, ex, md, sp)
    for args, kw, plain in [((inp,), {}, tw._push_impl_torch),
                            ((ct,), dict(deriv=True),
                             tw._pushgrad_impl_torch)]:
        out = cuda_warp.push_cuda(*args, grid, *opts, **kw)
        assert_close(out, plain(*args, grid, *opts))
        assert torch.equal(cuda_warp.push_cuda(*args, grid, *opts, **kw),
                           out)


# orders 0-7 over the bounds, B=2, C=3, points outside both ends of every
# axis (sc_case), boxes of 16^3 and 8^3 (a dense cloud), odd shapes
SCATTERED_SPLATS = [
    ((0, 0, 0), (0, 1, 2), 1, (19, 21, 37), 3000),
    ((1, 1, 1), (3, 4, 5), 0, (5, 7, 9), 400),
    ((2, 2, 2), (6, 0, 1), 2, (17, 18, 19), 9000),
    ((3, 3, 3), (6, 6, 6), 1, (48, 20, 17), 2000),
    ((4, 5, 6), (2, 3, 4), 1, (11, 12, 13), 800),
    ((7, 7, 7), (5, 6, 0), 0, (9, 10, 11), 300),
    ((3, 1), (6, 4), 2, (33, 18), 700),
]


@pytest.mark.parametrize("orders,bounds,ex,ish,P", SCATTERED_SPLATS)
def test_scattered_splat_matches_plain_and_repeats(cuda_device, orders,
                                                   bounds, ex, ish, P):
    _, grid = sc_case(cuda_device, ish, P, C=3, seed=5)
    D = len(ish)
    gen = torch.Generator(cuda_device).manual_seed(6)
    opts = (orders, bounds, ex)
    for k, (spec, core) in enumerate([("push", nd.push_core),
                                      ("pushgrad", nd.pushgrad_core),
                                      ("pushhess", nd.pushhess_core)]):
        vals = torch.randn((2, 3, P) + (D,) * k, device=cuda_device,
                           generator=gen)
        out = cuda_scattered.splat_cuda(vals, grid, ish, *opts, spec=spec)
        assert_close(out, core(vals, grid, ish, *opts))
        assert torch.equal(cuda_scattered.splat_cuda(vals, grid, ish, *opts,
                                                     spec=spec), out)


# the splat designs: ``box`` of cuda_scattered.splat_cuda (False: direct)
SC_DESIGNS = [False, True, (4, 4, 4), (8, 2, 16)]


@pytest.mark.parametrize("orders,bounds,ex,ish,md,sp", DENSE_SPLATS[:4]
                         + DENSE_SPLATS[9:] + DENSE_SPLATS[8:9])
def test_dense_splat_same_bits_under_any_tile(cuda_device, orders, bounds,
                                              ex, ish, md, sp):
    """Integer sums do not depend on their order: the default site tile,
    two others and no patch at all give the same bits."""
    inp, grid = warp_case(cuda_device, ish, C=2, disp=md or 0.5, B=2)
    ct = torch.randn(inp.shape + (len(ish),), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(4))
    opts = (orders, bounds, ex, md, sp)
    for args, kw in [((inp,), {}), ((ct,), dict(deriv=True))]:
        first = cuda_warp.push_cuda(*args, grid, *opts, **kw)
        for tile in ((0, 0, 0), (2, 4, 8), (1, 1, 32)):
            assert torch.equal(cuda_warp.push_cuda(*args, grid, *opts,
                                                   tile=tile, **kw), first)


@pytest.mark.parametrize("orders,bounds,ex,ish,P", SCATTERED_SPLATS)
def test_scattered_splat_same_bits_in_every_design(cuda_device, orders,
                                                   bounds, ex, ish, P):
    """Direct and by box patches (two box shapes), every spec: the same
    bits."""
    _, grid = sc_case(cuda_device, ish, P, C=2, seed=8)
    D = len(ish)
    gen = torch.Generator(cuda_device).manual_seed(9)
    for k, spec in enumerate(("push", "pushgrad", "pushhess")):
        vals = torch.randn((2, 2, P) + (D,) * k, device=cuda_device,
                           generator=gen)
        first = cuda_scattered.splat_cuda(vals, grid, ish, orders, bounds,
                                          ex, spec=spec)
        for box in SC_DESIGNS:
            if isinstance(box, tuple):
                box = box[:D] + (1,) * (3 - D)
            assert torch.equal(cuda_scattered.splat_cuda(
                vals, grid, ish, orders, bounds, ex, spec=spec, box=box),
                first)


@pytest.mark.parametrize("orders", [(1, 1, 1), (3, 3, 3), (2, 0, 5)])
def test_dense_push_is_the_scattered_splat_of_its_sites(cuda_device,
                                                        orders):
    """On a grid that keeps max_disp, the dense push (kernel 2) and the
    scattered splat (kernel 4) of the same sites compute each tap with the
    same helpers (axis_weights, tap_value) at the same scale, so their
    integer sums, and outputs, are equal bit for bit."""
    ish = (20, 17, 24)
    inp, grid = warp_case(cuda_device, ish, C=2, disp=2.0, B=2)
    ct = torch.randn(inp.shape + (3,), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(5))
    for bounds in ((3, 3, 3), (0, 6, 4)):
        opts = (orders, bounds, 1)
        pts = grid.reshape(2, -1, 3)
        assert torch.equal(
            cuda_warp.push_cuda(inp, grid, *opts, 2.0),
            cuda_scattered.splat_cuda(inp.reshape(2, 2, -1), pts, ish,
                                      *opts))
        assert torch.equal(
            cuda_warp.push_cuda(ct, grid, *opts, 2.0, deriv=True),
            cuda_scattered.splat_cuda(ct.reshape(2, 2, -1, 3), pts, ish,
                                      *opts, spec="pushgrad"))


@pytest.mark.parametrize("bound", range(7))
def test_scattered_splat_outliers_extrapolated(cuda_device, bound):
    """extrapolate=True keeps the points outside the volume on every
    bound: every spec within the gate of the plain core, every design the
    same bits."""
    ish = (13, 11, 9)
    _, grid = sc_case(cuda_device, ish, 3000, C=2, seed=bound)
    gen = torch.Generator(cuda_device).manual_seed(bound)
    for k, (spec, core) in enumerate([("push", nd.push_core),
                                      ("pushgrad", nd.pushgrad_core),
                                      ("pushhess", nd.pushhess_core)]):
        vals = torch.randn((2, 2, 3000) + (3,) * k, device=cuda_device,
                           generator=gen)
        opts = ((3, 2, 1), (bound,) * 3, 1)
        out = cuda_scattered.splat_cuda(vals, grid, ish, *opts, spec=spec)
        assert_close(out, core(vals, grid, ish, *opts))
        for box in SC_DESIGNS:
            assert torch.equal(cuda_scattered.splat_cuda(
                vals, grid, ish, *opts, spec=spec, box=box), out)


def test_splat_values_spanning_six_decades(cuda_device):
    """Values of random sign from 1e-3 to 1e3: within the gate of the
    plain versions.  The fixed point's own error is absolute per slice:
    each of the K taps that reach a voxel is rounded by at most half a
    quantum 2^-k < 2 S 2^-62 (S = mass x sum|v| of the slice, mass 1 for
    push), so a voxel is off by at most K S 2^-62 besides the float32
    rounding of the taps (a few ulp of the sum of their magnitudes) and of
    the result; held here against the float64 plain push."""
    rng = np.random.default_rng(11)
    ish = (24, 20, 28)
    P = 20000
    pts = torch.tensor(rng.uniform(-0.4, np.asarray(ish) - 0.6, (1, P, 3)),
                       dtype=torch.float32, device=cuda_device)
    mags = 10.0 ** rng.uniform(-3, 3, (1, 2, P))
    vals = torch.tensor(mags * rng.choice([-1.0, 1.0], (1, 2, P)),
                        dtype=torch.float32, device=cuda_device)
    opts = ((3, 3, 3), (3, 3, 3), 1)
    out = cuda_scattered.splat_cuda(vals, pts, ish, *opts)
    assert_close(out, nd.push_core(vals, pts, ish, *opts))
    ref = nd.push_core(vals.double(), pts.double(), ish, *opts)
    mag = nd.push_core(vals.double().abs(), pts.double(), ish, *opts)
    S = vals.double().abs().sum(-1)[..., None, None, None]
    K = 64 * P
    bound = K * S * 2.0 ** -62 + 2.0 ** -20 * mag + 2.0 ** -23 * ref.abs()
    assert torch.all((out.double() - ref).abs() <= bound)
    dense_inp, dense_grid = warp_case(cuda_device, ish, C=2, disp=1.5)
    dense_inp = dense_inp * torch.tensor(
        10.0 ** rng.uniform(-3, 3, dense_inp.shape), dtype=torch.float32,
        device=cuda_device)
    assert_close(cuda_warp.push_cuda(dense_inp, dense_grid, *opts, 1.5),
                 tw._push_impl_torch(dense_inp, dense_grid, *opts, 1.5))


@pytest.mark.parametrize("spec", ["push", "pushgrad", "pushhess"])
def test_splat_scale_per_slice(cuda_device, spec):
    """The scale kernel's k per slice (b, c) is 62 - ceil(log2(mass x
    sum|v|)), mass 1 / 2 / 4 for push / pushgrad / pushhess (the rule of
    the emulation in test_torch_fixed_splat.py): taps of exactly 1.5 and
    1.25 quanta at that k come out as 2 and 1 quanta (half to even), where
    k + 1 would give 1.5 quanta and k - 1 two of them.  The probes are
    too small to move the float64 sum, so S is a power of two, mass x 1
    or mass x 2^10 in the second channel, and ceil(log2 S) = log2 S."""
    mass, extra = {"push": (1, 0), "pushgrad": (2, 1),
                   "pushhess": (4, 2)}[spec]
    # the slice's sum at (2, 3, 4); the probes on integer coordinates, so
    # each puts its value, times a weight or derivative of 1, on one node
    pts = torch.tensor([[[2.0, 3.0, 4.0], [10.0, 10.0, 10.0],
                         [5.0, 12.0, 3.0]]], device=cuda_device)
    node = [(0, 0, 0), (1, 0, 0), (1, 1, 0)][extra]   # +1: the w' node
    at = (0,) * extra if spec == "pushgrad" else (0, 1)[:extra]
    sums = (1.0, 2.0 ** 10)
    k = [62 - int(math.log2(mass * s)) for s in sums]
    vals = torch.zeros((1, 2, 3) + (3,) * extra, device=cuda_device)
    for c, (s, kc) in enumerate(zip(sums, k)):
        for p, x in enumerate((s, 1.5 * 2.0 ** -kc, 1.25 * 2.0 ** -kc)):
            vals[(0, c, p) + at] = x
    for box in (None, False, True):
        out = cuda_scattered.splat_cuda(vals, pts, (16, 16, 16), (1, 1, 1),
                                        (3, 3, 3), 1, spec=spec, box=box)
        for c, kc in enumerate(k):
            for p, quanta in ((1, 2), (2, 1)):
                ix = tuple(int(pts[0, p, d]) + node[d] for d in range(3))
                assert out[(0, c) + ix].item() == quanta * 2.0 ** -kc


def test_splat_non_finite_values_and_coordinates(cuda_device):
    """What a non-finite input gives, pinned: a NaN or inf value makes its
    whole slice (b, c) NaN (no quantum can hold it), the other slices keep
    their bits; a non-finite coordinate of a kept point makes the slices of
    its batch NaN; a masked point, and a dense site whose coordinate is not
    finite (it fails the window test), add nothing."""
    ish = (9, 10, 11)
    _, grid = sc_case(cuda_device, ish, 400, B=2, C=3, seed=12)
    vals = torch.randn((2, 3, 400), device=cuda_device)
    opts = ((3, 3, 3), (3, 3, 3), 1)
    clean = cuda_scattered.splat_cuda(vals, grid, ish, *opts)
    for bad in (float("nan"), float("inf")):
        v = vals.clone()
        v[1, 2, 17] = bad
        for box in SC_DESIGNS:
            out = cuda_scattered.splat_cuda(v, grid, ish, *opts, box=box)
            assert torch.isnan(out[1, 2]).all()
            keep = torch.ones((2, 3), dtype=torch.bool)
            keep[1, 2] = False
            assert torch.equal(out[keep], clean[keep])
    g = grid.clone()
    g[0, 5, 1] = float("nan")
    out = cuda_scattered.splat_cuda(vals, g, ish, *opts)
    assert torch.isnan(out[0]).all() and torch.equal(out[1], clean[1])
    # masked (extrapolate=0): the non-finite points fail the mask and add
    # nothing, as points far outside do
    masked = ((3, 3, 3), (3, 3, 3), 0)
    g[0, 6, 0] = float("inf")
    far = torch.where(torch.isfinite(g), g, torch.full_like(g, -100.0))
    out = cuda_scattered.splat_cuda(vals, g, ish, *masked)
    assert torch.isfinite(out).all()
    assert torch.equal(out, cuda_scattered.splat_cuda(vals, far, ish,
                                                      *masked))
    inp, dense = warp_case(cuda_device, ish, C=2, disp=1.0)
    dense[0, 3, 4, 5, 0] = float("nan")
    out = cuda_warp.push_cuda(inp, dense, *opts, 1.0)
    assert torch.isfinite(out).all()
    assert_close(out, tw._push_impl_torch(inp, dense, *opts, 1.0))


# the values an item the splat drops may carry: none of them may reach the
# slice's scale (csrc/fixed_splat.cuh), so none changes a bit of the output
DROPPED = [1e30, math.inf, math.nan]


def _dense_kept(grid, orders, ex, md, sp):
    """(B, *ishape) bool: the sites that kernel 2 keeps (site_kept): the
    extrapolation mask and the window test of the node origin's offset
    from the site, in adaptive mode shifted by the site's push-tile base
    (the plain versions' own mask, ``window._mask``)."""
    D = grid.shape[-1]
    ishape = tuple(grid.shape[1:-1])
    m = tw._mask(grid, ishape, ex, torch.float32, orders, md, sp, push=True)
    keep = torch.ones(grid.shape[:-1], dtype=torch.bool, device=grid.device)
    if m is not None:
        keep &= m > 0
    if sp is None:
        for d, mdd in enumerate(tw._md_tuple(md, D)):
            n0 = torch.floor(grid[..., d] - 0.5 * (orders[d] - 1)) \
                if orders[d] else torch.round(grid[..., d])
            shape = [1] * (D + 1)
            shape[1 + d] = ishape[d]
            r = n0 - torch.arange(ishape[d], device=grid.device
                                  ).reshape(shape)
            smin, smax = tw.window_range(orders[d], mdd)
            keep &= (r >= smin) & (r <= smax - orders[d])
    return keep


# dense pushes with dropped sites: spec, orders, bounds, extrapolate,
# ishape, max_disp, tile_spread (adaptive) -- a fifth of the displacements
# x4 (window-dropped) and extrapolate 0 (masked sites at the edges)
DENSE_DROPS = [
    ("push", (3, 3, 3), (3, 3, 3), 0, (19, 21, 37), 1.5, None),
    ("pushgrad", (3, 3, 3), (6, 0, 4), 0, (19, 21, 37), 1.5, None),
    ("push", (1, 1, 1), (3, 3, 3), 1, (17, 18, 19), 1.0, None),
    ("push", (3, 3, 3), (3, 3, 3), 0, (20, 17, 40), 2.0, 0.5),
    ("pushgrad", (3, 3, 3), (3, 3, 3), 1, (20, 17, 40), 2.0, 0.5),
    ("pushgrad", (1, 3), (6, 3), 0, (33, 18), 1.5, None),
]


@pytest.mark.parametrize("bad", DROPPED)
@pytest.mark.parametrize("spec,orders,bounds,ex,ish,md,sp", DENSE_DROPS)
def test_dense_dropped_sites_set_no_scale(cuda_device, spec, orders, bounds,
                                          ex, ish, md, sp, bad):
    """Kernel 2 (2a, 2b, 2c) with 1e30, inf or NaN at every site it drops
    (masked, or outside the window): within the gate of the plain version
    with those values zeroed, and equal bit for bit to its own call with
    them zeroed, with its default site tile and with no patch."""
    inp, grid = warp_case(cuda_device, ish, C=3, disp=md, B=2, seed=3,
                          break_contract=4.0)
    if sp is not None:
        grid[0, :8] += 1.0          # tiles with different bases
    D = len(ish)
    keep = _dense_kept(grid, orders, ex, md, sp)
    assert 0 < int((~keep).sum()) < keep.numel()
    vals = inp if spec == "push" else torch.randn(
        inp.shape + (D,), device=cuda_device,
        generator=torch.Generator(cuda_device).manual_seed(4))
    k = keep[:, None].reshape(keep.shape[:1] + (1,) + keep.shape[1:]
                              + (1,) * (vals.ndim - keep.ndim - 1))
    zero = torch.where(k, vals, 0.0)
    dirty = torch.where(k, vals, bad)
    opts = (orders, bounds, ex, md, sp)
    kw = dict(deriv=spec == "pushgrad")
    plain = tw._push_impl_torch if spec == "push" else \
        tw._pushgrad_impl_torch
    clean = cuda_warp.push_cuda(zero, grid, *opts, **kw)
    assert_close(clean, plain(zero, grid, *opts))
    for tile in (None, (0, 0, 0)):
        out = cuda_warp.push_cuda(dirty, grid, *opts, tile=tile, **kw)
        assert torch.equal(out, clean)


# the last: more than 32 points per output voxel and channel, so the keep
# bits take the workspace's tail, not the output
SC_DROP_CASES = [((3, 3, 3), (3, 3, 3), 0, (19, 21, 37), 3000),
                 ((1, 2), (6, 4), 2, (33, 18), 700),
                 ((1, 1), (3, 3), 0, (4, 3), 3000)]


@pytest.mark.parametrize("bad", DROPPED)
@pytest.mark.parametrize("spec", ["push", "pushgrad", "pushhess"])
@pytest.mark.parametrize("orders,bounds,ex,ish,P", SC_DROP_CASES)
def test_scattered_masked_points_set_no_scale(cuda_device, orders, bounds,
                                              ex, ish, P, spec, bad):
    """Kernel 4, both designs, with 1e30, inf or NaN at every point the
    mask drops: within the gate of the plain core with those values
    zeroed, and equal bit for bit to its own call with them zeroed."""
    _, grid = sc_case(cuda_device, ish, P, B=2, C=3, seed=21)
    D = len(ish)
    keep = nd.inbounds_mask(grid, ish, ex, torch.float32) > 0
    assert 0 < int((~keep).sum()) < keep.numel()
    k = ("push", "pushgrad", "pushhess").index(spec)
    vals = torch.randn((2, 3, P) + (D,) * k, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(k))
    m = keep[:, None].reshape((2, 1, P) + (1,) * k)
    zero = torch.where(m, vals, 0.0)
    dirty = torch.where(m, vals, bad)
    opts = (orders, bounds, ex)
    core = {"push": nd.push_core, "pushgrad": nd.pushgrad_core,
            "pushhess": nd.pushhess_core}[spec]
    clean = cuda_scattered.splat_cuda(zero, grid, ish, *opts, spec=spec)
    assert_close(clean, core(zero, grid, ish, *opts))
    for box in (False, True):
        out = cuda_scattered.splat_cuda(dirty, grid, ish, *opts, spec=spec,
                                        box=box)
        assert torch.equal(out, clean)


# more than 65535 slices (B x C), channels or batches: (B, C)
MANY = [(1, 65536), (70000, 1), (2, 35000)]


@pytest.mark.parametrize("B,C", MANY)
@pytest.mark.parametrize("kind", ["push", "pushgrad", "sc_direct",
                                  "sc_box"])
def test_splats_take_any_slice_count(cuda_device, kind, B, C):
    """Kernels 2 and 4 at B x C = 65536 and 70000 slices of a tiny volume
    (the slices, and the channels of a block, on grid-stride loops):
    within the gate of the plain versions, the same bits on a second run
    and without a patch (dense) or in the other design (scattered)."""
    gen = torch.Generator(cuda_device).manual_seed(B + C)
    ish = (3, 4, 5)
    opts = ((3, 1, 2), (3, 6, 0), 1)
    if kind.startswith("sc"):
        grid = torch.rand((B, 7, 3), device=cuda_device, generator=gen) \
            * torch.tensor(ish, device=cuda_device) - 0.5
        vals = torch.randn((B, C, 7), device=cuda_device, generator=gen)
        box = kind == "sc_box"
        out = cuda_scattered.splat_cuda(vals, grid, ish, *opts, box=box)
        assert_close(out, nd.push_core(vals, grid, ish, *opts))
        assert torch.equal(out, cuda_scattered.splat_cuda(
            vals, grid, ish, *opts, box=not box))
        return
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n, device=cuda_device, dtype=torch.float32)
          for n in ish], indexing="ij"), -1)[None].expand(B, *ish, 3) \
        + torch.rand((B,) + ish + (3,), device=cuda_device, generator=gen) \
        - 0.5
    deriv = kind == "pushgrad"
    vals = torch.randn((B, C) + ish + ((3,) if deriv else ()),
                       device=cuda_device, generator=gen)
    plain = tw._pushgrad_impl_torch if deriv else tw._push_impl_torch
    out = cuda_warp.push_cuda(vals, grid, *opts, 0.5, deriv=deriv)
    assert_close(out, plain(vals, grid, *opts, 0.5))
    for tile in (None, (0, 0, 0)):
        assert torch.equal(out, cuda_warp.push_cuda(
            vals, grid, *opts, 0.5, deriv=deriv, tile=tile))


def test_keep_pass_past_2_31_points_a_batch(cuda_device):
    """A batch of 2^31 + 64 points, all but five masked (at 1e30): the keep
    pass indexes the items of a batch in 64 bits there.  Five kept points,
    two of them past 2^31, give the bits of the splat of those five alone
    (their float64 sum is exact, so S and k are the same), which the plain
    core holds to the gate.  ~35 GB of device memory."""
    P = 2**31 + 64
    ish = (8, 8, 8)
    opts = ((1, 1, 1), (3, 3, 3), 0)
    idx = torch.tensor([0, 12345, 2**31 - 1, 2**31, P - 1],
                       device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(5)
    g5 = torch.rand((1, 5, 3), device=cuda_device, generator=gen) * 7
    v5 = 0.5 + 1.5 * torch.rand((1, 1, 5), device=cuda_device, generator=gen)
    ref = cuda_scattered.splat_cuda(v5, g5, ish, *opts, box=False)
    assert_close(ref, nd.push_core(v5, g5, ish, *opts))
    torch.cuda.empty_cache()
    grid = torch.full((1, P, 3), -1000.0, device=cuda_device)
    grid[0, idx] = g5[0]
    vals = torch.full((1, 1, P), 1e30, device=cuda_device)
    vals[0, 0, idx] = v5[0, 0]
    out = cuda_scattered.splat_cuda(vals, grid, ish, *opts, box=False)
    del grid, vals
    torch.cuda.empty_cache()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("sp", [None, 0.5])
def test_dense_gather_takes_any_batch(cuda_device, sp):
    """Kernel 1's value and grad at B = 65536 batches of a tiny volume (the
    blocks of every tile and batch on one grid axis), full window and
    adaptive: within the gate of the plain versions."""
    inp, grid = warp_case(cuda_device, (3, 4, 5), C=1, disp=0.5, B=65536,
                          seed=2)
    opts = ((3, 3, 3), (3, 3, 3), 1, 0.5, sp)
    val, g = cuda_warp.warp_cuda(inp, grid, *opts, value=True, grad=True)
    assert_close(val, tw._pull_impl_torch(inp, grid, *opts))
    assert_close(g, tw._grad_impl_torch(inp, grid, *opts))


def test_push_peak_memory_256_cubic(cuda_device):
    """The 256^3 cubic max_disp=4 push allocates its output and an int64
    accumulator (twice the output) and nothing else of that order: under 2
    x the output beyond the output itself (the inputs are 3-D and
    contiguous, so the wrapper copies none)."""
    vol = (256, 256, 256)
    gen = torch.Generator(cuda_device).manual_seed(0)
    inp = torch.randn((1, 1) + vol, device=cuda_device, generator=gen)
    ident = torch.stack(torch.meshgrid(
        *[torch.arange(n, device=cuda_device, dtype=torch.float32)
          for n in vol], indexing="ij"), -1)[None]
    grid = ident + torch.rand(ident.shape, device=cuda_device,
                              generator=gen) * 2 - 1
    del ident
    opts = ((3, 3, 3), (3, 3, 3), 1, 4.0)
    for kw, args in [({}, (inp,)), ({"tile": (0, 0, 0)}, (inp,))]:
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = cuda_warp.push_cuda(*args, grid, *opts, **kw)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - live - out.numel() * 4
        assert extra <= 2 * out.numel() * 4 + 2**20
        del out


def _second_order(device, op):
    """Gradient in (inp, grid) of sum(d_inp) + sum(d_grid), the first
    derivatives of sum(op**2) built with create_graph=True."""
    rng = np.random.default_rng(3)
    ish = (9, 10, 11)
    kw = dict(dtype=torch.float32, device=device)
    inp = torch.tensor(rng.standard_normal((2, 2) + ish), requires_grad=True,
                       **kw)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    dense = torch.tensor(ident + rng.uniform(-1, 1, (2,) + ish + (3,)),
                         requires_grad=True, **kw)
    cloud = torch.tensor(rng.uniform(-1.5, 10.5, (2, 40, 3)),
                         requires_grad=True, **kw)
    opts = ((3, 2, 1), (3, 0, 6), 2)
    grid, out = {
        "pull_window": (dense, lambda: tw.pull_window(inp, dense, *opts,
                                                      1.0)),
        "grad_window": (dense, lambda: tw.grad_window(inp, dense, *opts,
                                                      1.0)),
        "pull": (cloud, lambda: tpp.pull(inp, cloud, *opts)),
        "grad": (cloud, lambda: tpp.grad(inp, cloud, *opts)),
    }[op]
    di, dg = torch.autograd.grad(out().square().sum(), [inp, grid],
                                 create_graph=True)
    return [t.detach().cpu() for t in torch.autograd.grad(
        di.sum() + dg.sum(), [inp, grid])]


@pytest.mark.parametrize("op", ["pull_window", "grad_window", "pull",
                                "grad"])
def test_second_order_card_matches_cpu(cuda_device, op):
    for a, b in zip(_second_order(cuda_device, op),
                    _second_order("cpu", op)):
        assert_close(a, b, STEP_TOL)


def test_scattered_wrappers_refuse(cuda_device):
    inp, grid = sc_case(cuda_device, (4, 5, 6), 30)
    opts = ((3, 3, 3), (3, 3, 3), 1)
    with pytest.raises(TypeError, match="float32"):
        cuda_scattered.gather_cuda(inp.double(), grid.double(), *opts)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_scattered.splat_cuda(inp.reshape(2, 2, -1)[..., :30].transpose(
            0, 1).contiguous().transpose(0, 1), grid, (4, 5, 6), *opts)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_scattered.gather_cuda(inp.clone().requires_grad_(), grid,
                                   *opts)
    out = tpp.pull(inp.clone().requires_grad_(), grid, *opts)
    assert out.requires_grad


# adaptive mode: orders, bounds, extrapolate, ishape, max_disp, tile_spread,
# displacement of the grid (far beyond the spread: taps are dropped)
AD_CASES = [
    ((3, 3, 3), (3, 3, 3), 1, (20, 17, 140), 2.0, 0.5, 2.0),
    ((1, 1, 1), (6, 6, 6), 0, (17, 9, 12), 1.5, (0.5, 1.0, 0.2), 1.5),
    ((5, 0, 3), (4, 1, 2), 2, (16, 10, 30), 2.0, 1.0, 2.0),
    ((3, 1), (3, 0), 1, (30, 140), 2.0, 0.5, 2.0),          # 2-D
    ((3,), (6,), 1, (300,), 2.0, 0.5, 2.0),                 # 1-D
    # wide: max_disp 8, a residual window of span 13 (> 12)
    ((3, 3, 3), (3, 3, 3), 1, (20, 18, 24), 8.0, 4.5, 8.0),
]


@pytest.mark.parametrize("orders,bounds,ex,ish,md,sp,disp", AD_CASES)
def test_adaptive_kernels_match_plain(cuda_device, orders, bounds, ex, ish,
                                      md, sp, disp):
    inp, grid = warp_case(cuda_device, ish, disp=disp, B=2)
    grid[0, :8] += 1.0          # tiles with different bases
    ct = torch.randn(inp.shape + (len(ish),), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(0))
    opts = (orders, bounds, ex, md, sp)
    before = dict(cuda_warp.LAUNCHES_BY_MODE)
    val, g = cuda_warp.warp_cuda(inp, grid, *opts, value=True, grad=True)
    v1 = cuda_warp.warp_cuda(inp, grid, *opts, value=True)[0]
    h = cuda_warp.hess_cuda(inp, grid, *opts)
    p = cuda_warp.push_cuda(inp, grid, *opts)
    pg = cuda_warp.push_cuda(ct, grid, *opts, deriv=True)
    for mode in ("value_ad", "value+grad_ad", "hess_ad", "push_ad",
                 "pushgrad_ad"):
        assert cuda_warp.LAUNCHES_BY_MODE[mode] == before[mode] + 1
    assert torch.equal(val, v1)
    assert_close(val, tw._pull_impl_torch(inp, grid, *opts))
    assert_close(g, tw._grad_impl_torch(inp, grid, *opts))
    assert_close(h, tw._hess_impl_torch(inp, grid, *opts))
    assert_close(p, tw._push_impl_torch(inp, grid, *opts))
    assert_close(pg, tw._pushgrad_impl_torch(ct, grid, *opts))
    # the spread is broken: taps were dropped
    full = cuda_warp.warp_cuda(inp, grid, *opts[:4])[0]
    assert (val - full).abs().max() > 1e-3
    # fixed-point sums: the adaptive splats give the same bits on a second
    # run
    assert torch.equal(cuda_warp.push_cuda(inp, grid, *opts), p)
    assert torch.equal(cuda_warp.push_cuda(ct, grid, *opts, deriv=True), pg)


def test_wide_window_one_launch(cuda_device):
    """max_disp=8 at cubic order (span 20, the TPU chunks it): one launch
    of each kernel matches the plain version."""
    inp, grid = warp_case(cuda_device, (21, 20, 26), disp=8.0, B=1)
    opts = ((3, 3, 3), (3, 3, 3), 1, 8.0)
    before = cuda_warp.LAUNCHES
    val, g = cuda_warp.warp_cuda(inp, grid, *opts, value=True, grad=True)
    p = cuda_warp.push_cuda(inp, grid, *opts)
    assert cuda_warp.LAUNCHES == before + 2
    assert_close(val, tw._pull_impl_torch(inp, grid, *opts))
    assert_close(g, tw._grad_impl_torch(inp, grid, *opts))
    assert_close(p, tw._push_impl_torch(inp, grid, *opts))


def test_plain_push_is_deterministic_on_the_card(cuda_device):
    """D = 4 takes the plain cores on every device; many points per voxel
    give the same bits on every run."""
    gen = torch.Generator(cuda_device).manual_seed(2)
    grid = torch.rand((2, 20000, 4), device=cuda_device, generator=gen) \
        * torch.tensor([3.0, 4.0, 2.0, 3.0], device=cuda_device)
    vals = torch.randn((2, 3, 20000), device=cuda_device, generator=gen)
    first = grid_push(vals[..., None, None, None],
                      grid[:, :, None, None, None], shape=(4, 5, 3, 4),
                      interpolation=1, bound="dct2")
    for _ in range(3):
        assert torch.equal(grid_push(vals[..., None, None, None],
                                     grid[:, :, None, None, None],
                                     shape=(4, 5, 3, 4), interpolation=1,
                                     bound="dct2"), first)
    assert_close(first, nd.push_core(vals.cpu(), grid.cpu(), (4, 5, 3, 4),
                                     (1,) * 4, (3,) * 4, 0).to(first))


def test_register_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    vol = (16, 12, 16)
    moving = rng.standard_normal((1, 1) + vol)
    fixed = np.roll(moving, 1, axis=4)
    out = []
    for device in (cuda_device, "cpu"):
        model = PyramidModel(vol, (3, 3, 3), levels=2, interpolation=3,
                             max_disp=2.0, steps_per_level=4,
                             tile_spread="auto", device=device)
        kw = dict(dtype=torch.float32, device=device)
        params, losses = register(model, torch.as_tensor(moving, **kw),
                                  torch.as_tensor(fixed, **kw), lr=1.0)
        out.append((params.cpu(), losses.cpu()))
    for a, b in zip(*out):
        assert_close(a, b, STEP_TOL)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary, so that no (b, c) volume or row is 16-byte aligned."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def _equal_nan(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


# the gathers' tap setup (spline_taps.cuh::tap_axis): interior taps
# unfolded, the rest folded at every face; orders 0-7 over every bound,
# B=2, C=3, shapes that are no multiple of the block tile (and Z % 4 != 0),
# max_disp 0 and 8, grids that break max_disp, the adaptive bases (z tiles
# of 128 and a full-span z), 2-D and 1-D lifts; misaligned (b, c) bases;
# blocks deep inside the volume beside blocks at its faces
DENSE_GATHERS = [
    ((0, 0, 0), (0, 1, 2), 1, (19, 21, 37), 1.5, None, 0.0, False),
    ((1, 1, 1), (3, 4, 5), 0, (5, 7, 9), 1.5, None, 0.0, True),
    ((2, 2, 2), (6, 0, 1), 2, (17, 18, 19), 0.0, None, 0.0, False),
    ((3, 3, 3), (0, 1, 2), 1, (33, 10, 35), 8.0, None, 0.0, False),
    ((4, 5, 6), (3, 4, 5), 1, (11, 12, 13), 2.0, None, 3.0, True),
    ((7, 7, 7), (6, 5, 4), 0, (9, 10, 11), 1.0, None, 0.0, False),
    ((3, 3, 3), (4, 4, 4), 1, (20, 17, 140), 2.0, 0.5, 0.0, False),
    ((1, 1, 1), (1, 1, 1), 2, (16, 24, 30), 1.5, (0.5, 1.0, 0.5), 0.0,
     True),
    ((3, 1), (6, 3), 1, (33, 18), 2.0, None, 2.0, False),
    ((1,), (2,), 1, (300,), 1.5, 0.5, 0.0, False),
    ((3, 3, 3), (3, 3, 3), 1, (20, 24, 70), 1.5, None, 0.0, False),
    ((3, 2, 3), (6, 1, 2), 2, (18, 20, 72), 1.5, (1.0, 0.5, 1.5), 3.0,
     True),
]


@pytest.mark.parametrize("orders,bounds,ex,ish,md,sp,brk,mis",
                         DENSE_GATHERS)
def test_dense_gathers_match_plain_and_repeat(cuda_device, orders, bounds,
                                              ex, ish, md, sp, brk, mis):
    # max_disp 0: displacements of 0.5 break it (taps are dropped)
    inp, grid = warp_case(cuda_device, ish, C=3, disp=md or 0.5, B=2,
                          break_contract=brk, seed=7)
    if sp is not None:
        grid[0, :8] += 1.0          # tiles with different bases
    if mis:
        inp = _misaligned(inp)
    opts = (orders, bounds, ex, md, sp)
    val, g = cuda_warp.warp_cuda(inp, grid, *opts, value=True, grad=True)
    outs = [val, g, cuda_warp.warp_cuda(inp, grid, *opts)[0],
            cuda_warp.warp_cuda(inp, grid, *opts, value=False,
                                grad=True)[1],
            cuda_warp.hess_cuda(inp, grid, *opts)]
    assert torch.equal(outs[2], val) and torch.equal(outs[3], g)
    assert_close(val, tw._pull_impl_torch(inp, grid, *opts))
    assert_close(g, tw._grad_impl_torch(inp, grid, *opts))
    assert_close(outs[4], tw._hess_impl_torch(inp, grid, *opts))
    again = [*cuda_warp.warp_cuda(inp, grid, *opts, value=True, grad=True),
             cuda_warp.hess_cuda(inp, grid, *opts)]
    for a, b in zip(again, outs[:2] + outs[4:]):
        assert torch.equal(a, b)


def test_dense_gathers_nonfinite_coordinates(cuda_device):
    """NaN, +-inf and |g| > 2^30 coordinates fail the window test: no tap,
    0, as in the plain version (every extrapolation mode)."""
    inp, grid = warp_case(cuda_device, (9, 10, 12), C=3, disp=1.0, B=2)
    grid[0, 1, 2, 3] = float("nan")
    grid[0, 2, 2, 3, 1] = float("inf")
    grid[1, 3, 4, 5, 2] = -float("inf")
    grid[1, 4, 4, 4, 0] = 3e9
    grid[1, 5, 5, 5, 2] = -2e30
    for ex in (0, 1, 2):
        opts = ((3, 2, 1), (3, 6, 0), ex, 2.0)
        val, g = cuda_warp.warp_cuda(inp, grid, *opts, value=True,
                                     grad=True)
        h = cuda_warp.hess_cuda(inp, grid, *opts)
        for out in (val, g, h):
            assert torch.isfinite(out).all()
        assert (val[0, :, 1, 2, 3] == 0).all()
        assert (val[1, :, 5, 5, 5] == 0).all()
        assert_close(val, tw._pull_impl_torch(inp, grid, *opts))
        assert_close(g, tw._grad_impl_torch(inp, grid, *opts))
        assert_close(h, tw._hess_impl_torch(inp, grid, *opts))


# scattered: orders 0-7 over every bound, B=2, C=3, points outside both ends
# of every axis (masked on both sides at extrapolate 0 and 2), P no
# multiple of 32, Z % 4 != 0, lifted 2-D and 1-D clouds
SC_GATHERS = [
    ((3, 3, 3), (3, 3, 3), 1, (21, 22, 23), 1000, False),
    ((1, 1, 1), (0, 1, 2), 0, (9, 10, 12), 777, True),
    ((2, 2, 2), (6, 5, 4), 2, (8, 9, 16), 515, False),
    ((0, 4, 7), (1, 2, 3), 1, (7, 8, 9), 333, False),
    ((5, 6, 3), (4, 5, 6), 0, (10, 11, 12), 200, True),
    ((3, 1), (4, 3), 1, (12, 10), 301, False),
    ((1,), (6,), 2, (15,), 97, False),
]


@pytest.mark.parametrize("orders,bounds,ex,ish,P,mis", SC_GATHERS)
def test_scattered_gathers_match_plain_and_repeat(cuda_device, orders,
                                                  bounds, ex, ish, P, mis):
    inp, grid = sc_case(cuda_device, ish, P, C=3, seed=8)
    if mis:
        inp = _misaligned(inp)
    opts = (orders, bounds, ex)
    runs = []
    for _ in range(2):
        v, g, _ = cuda_scattered.gather_cuda(inp, grid, *opts, value=True,
                                             grad=True)
        _, g2, h = cuda_scattered.gather_cuda(inp, grid, *opts,
                                              value=False, grad=True,
                                              hess=True)
        runs.append((v, g, g2, h))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    v, g, g2, h = runs[0]
    assert torch.equal(g, g2)
    assert_close(v, nd.pull_core(inp, grid, *opts))
    assert_close(g, nd.grad_core(inp, grid, *opts))
    assert_close(h, nd.hess_core(inp, grid, *opts))


@pytest.mark.parametrize("ex", [0, 1, 2])
def test_scattered_gathers_nonfinite_coordinates(cuda_device, ex):
    """NaN, +-inf and |g| > 2^30 coordinates read clamped indices: no
    fault, the same result on every run; masked (extrapolate 0, 2) they
    give 0 where the plain version's 0 * NaN gives NaN, and every other
    point matches the plain version."""
    inp, pts = sc_case(cuda_device, (9, 10, 12), 500, C=3)
    bad = [(0, 3), (0, 4), (1, 5), (1, 6), (1, 7)]
    pts[0, 3] = float("nan")
    pts[0, 4, 1] = float("inf")
    pts[1, 5, 2] = -float("inf")
    pts[1, 6, 0] = 3e9
    pts[1, 7] = -2e30
    opts = ((3, 2, 1), (3, 6, 0), ex)
    v = cuda_scattered.gather_cuda(inp, pts, *opts)[0]
    _equal_nan(cuda_scattered.gather_cuda(inp, pts, *opts)[0], v)
    ref = nd.pull_core(inp, pts, *opts)
    good = torch.ones_like(v, dtype=torch.bool)
    for b, p in bad:
        good[b, :, p] = False
        if ex != 1:
            assert (v[b, :, p] == 0).all()
    assert_close(v[good], ref[good])


# ------------------------------------------------ prefilter and labels

@pytest.mark.parametrize("shape,dim,order,bound", [
    ((2, 40, 50, 60), 3, 3, "dct2"),           # matrix path, every axis
    ((3, 70, 30), 2, 5, "dct1"),
    ((2, 2100), 1, 3, "dct1"),                 # blocked-scan path
    ((3, 2600), 1, 7, "dft"),
])
def test_prefilter_card_matches_cpu_float64(cuda_device, shape, dim, order,
                                            bound):
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(shape))
    ref = itt.spline_coeff_nd(x, order, bound, dim=dim)
    out = itt.spline_coeff_nd(x.float().to(cuda_device), order, bound,
                              dim=dim)
    assert out.dtype == torch.float32 and out.is_cuda
    assert_close(out.cpu().double(), ref)
    # and its exact transpose in the backward, against the CPU's
    v = torch.randn(shape, dtype=torch.float64)
    xc = x.clone().requires_grad_()
    (gc,) = torch.autograd.grad(itt.spline_coeff_nd(xc, order, bound,
                                                    dim=dim), xc, v)
    xg = x.float().to(cuda_device).requires_grad_()
    (gg,) = torch.autograd.grad(itt.spline_coeff_nd(xg, order, bound,
                                                    dim=dim), xg,
                                v.float().to(cuda_device))
    assert_close(gg.cpu().double(), gc)


def test_prefilter_exact_with_tf32_on(cuda_device):
    """The prefilter's products do not move when a caller turns TF32 on
    for float32 matmuls."""
    x = torch.randn((1, 1, 64, 72, 80), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    ref = itt.spline_coeff_nd(x, 3, "dct2", dim=3)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        # TF32 reaches a plain float32 product on this card...
        a = torch.randn((512, 512), device=cuda_device)
        tf32 = (a @ a - (a.double() @ a.double()).float()).abs().max()
        out = itt.spline_coeff_nd(x, 3, "dct2", dim=3)
    finally:
        torch.set_float32_matmul_precision(before)
    assert tf32.item() > 1e-3
    # ... but not the prefilter
    assert torch.equal(out, ref)


@pytest.mark.parametrize("order", range(2, 8))
def test_resize_identity_on_the_card(cuda_device, order):
    x = torch.randn((1, 2, 9, 11, 30), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    for bound in ("dct1", "dct2", "dft"):
        y = itt.resize(x, shape=list(x.shape[2:]), anchor="e",
                       interpolation=order, bound=bound, prefilter=True)
        assert_close(y, x)
        # and through the dense-warp kernel at the identity
        g = itt.identity_grid(x.shape[2:], device=cuda_device)[None]
        y = grid_pull(x, g, order, bound, prefilter=True, max_disp=1.0)
        assert_close(y, x)


def _plain_labels(lab, grid, classes, kw):
    """The label pull on the plain versions (each class's soft map pulled
    by the window's plain version or the plain gather core), with the
    strict argmax from (0, label 0); and the margin between each voxel's
    top two values, 0 among them."""
    grid_b, inp, _ = api._preproc(grid, lab)
    orders, bounds, ex = options.normalize_options(
        kw.get("interpolation", 1), kw.get("bound", "zero"),
        kw.get("extrapolate", False), grid.shape[-1])
    softs = [torch.zeros(inp.shape[:2] + grid_b.shape[1:-1],
                         device=lab.device)]
    for c in classes:
        soft = (inp == c).float()
        if kw.get("prefilter"):
            soft = tc.spline_coeff_nd(soft, orders, bounds,
                                      grid.shape[-1])
        if "max_disp" in kw:
            soft = tw._pull_impl_torch(soft, grid_b, orders, bounds, ex,
                                       kw["max_disp"], None)
        else:
            soft = nd.pull_core(soft, grid_b.reshape(grid_b.shape[0], -1,
                                                     grid_b.shape[-1]),
                                orders, bounds, ex).reshape(softs[0].shape)
        softs.append(soft)
    s = torch.stack(softs)
    out = torch.zeros_like(s[0], dtype=lab.dtype)
    pmax = s[0].clone()
    for c, soft in zip(classes, s[1:]):
        out[soft > pmax] = c
        pmax = torch.maximum(pmax, soft)
    top = s.topk(2, dim=0).values
    return out, top[0] - top[1]


def blobs(device, shape, classes, seed):
    """A (1, 1, *shape) label map of ``classes`` smooth blobs: the argmax
    of smoothed noise fields, one per class."""
    gen = torch.Generator(device).manual_seed(seed)
    coarse = torch.randn((classes, 1) + tuple(max(2, s // 4) for s in shape),
                         device=device, generator=gen)
    fields = itt.resize(coarse, shape=list(shape), interpolation=3,
                        prefilter=False)
    return fields.argmax(0, keepdim=True).int()


@pytest.mark.parametrize("kw", [
    dict(interpolation=3, bound="dct2", extrapolate=True, max_disp=2.0),
    dict(interpolation=1, max_disp=2.0),
    dict(interpolation=3, bound="dct1", prefilter=True),
    dict(interpolation=2),
], ids=["window-cubic", "window-linear", "generic-prefilter", "generic"])
def test_label_pull_kernel_matches_plain(cuda_device, kw):
    lab = blobs(cuda_device, (24, 20, 36), 6, 2)
    _, grid = warp_case(cuda_device, (24, 20, 36), disp=2.0, seed=3, B=1)
    classes = torch.unique(lab).tolist()
    before = dict(cuda_warp.LAUNCHES_BY_MODE)
    out = grid_pull(lab, grid, **kw)
    if "max_disp" in kw:
        assert cuda_warp.LAUNCHES_BY_MODE["value"] \
            == before["value"] + len(classes)
    ref, margin = _plain_labels(lab, grid, classes, kw)
    assert out.dtype == torch.int32 and out.shape == ref.shape
    # float32 sums in another order: labels may differ only where the
    # plain top two are within 1e-4 (samples outside the volume, where
    # every soft value is 0, tie too and stay 0)
    sure = margin > 1e-4
    assert sure.float().mean().item() > 0.5
    assert torch.equal(out[sure], ref[sure])


def test_label_resize_and_restrict_on_the_card(cuda_device):
    lab = blobs(cuda_device, (16, 12, 20), 5, 4)
    classes = torch.unique(lab).tolist()
    before = dict(cuda_scattered.LAUNCHES_BY_MODE)
    out = itt.resize(lab, factor=[2, 2, 2], interpolation=3)
    assert cuda_scattered.LAUNCHES_BY_MODE["sc_value"] \
        == before["sc_value"] + len(classes)
    # resize's defaults: centers, bound 'nearest', extrapolate, prefilter
    lines = [torch.linspace(0, n - 1, 2 * n, device=cuda_device)
             for n in lab.shape[2:]]
    grid = torch.stack(torch.meshgrid(*lines, indexing="ij"), -1)
    ref, margin = _plain_labels(lab, grid, classes, dict(
        interpolation=3, bound="nearest", extrapolate=True, prefilter=True))
    assert out.dtype == torch.int32 and out.shape == ref.shape
    sure = margin > 1e-4
    assert sure.float().mean().item() > 0.5
    assert torch.equal(out[sure], ref[sure])
    out = itt.restrict(lab, factor=[2, 2, 2], interpolation=3,
                       prefilter=True)
    assert cuda_scattered.LAUNCHES_BY_MODE["sc_push"] \
        == before["sc_push"] + 1
    ref = itt.restrict(lab.cpu(), factor=[2, 2, 2], interpolation=3,
                       prefilter=True)
    assert out.dtype == torch.float32
    assert_close(out.cpu(), ref)


# ------------------------------------------------------------ kernel lab
# csrc/lab.cu against ops/lab.py's plain versions: the FMA chains and the
# lane gathers to the bit (one rounding per step, the same sums in the same
# order; the float32 gate allows the plain version's rare double rounding),
# the bf16 pull at the float32 gate (the same bf16 operands, exact products)

@pytest.mark.parametrize("nacc,dtype,zero", [
    (1, torch.float32, True), (4, torch.float32, False),
    (8, torch.float32, False), (16, torch.float32, False),
    (8, torch.bfloat16, False), (16, torch.bfloat16, True)])
def test_lab_fma_matches_plain(cuda_device, nacc, dtype, zero):
    from interpol_tpu_torch.ops import lab
    gen = torch.Generator(cuda_device).manual_seed(nacc)
    a = torch.randn((3, 8, 130), generator=gen, device=cuda_device)
    b = torch.randn((3, 8, 130), generator=gen, device=cuda_device)
    lab.reset_launches()
    out = lab.fma(a, b, 64 * nacc, nacc, dtype, zero)
    name = "lab_fma_bf16x2" if dtype == torch.bfloat16 else "lab_fma_f32"
    assert lab.LAUNCHES_BY_MODE[name] == 1
    assert_close(out, lab.fma_plain(a, b, 64 * nacc, nacc, dtype, zero))


# the lane gather's two paths (lab.gather_and_path): in shared memory 16-byte
# copies and reads where T % 4 == 0 and the table is 16-byte aligned, 4-byte
# reads elsewhere and from device memory; runs that wrap past the row's end,
# reps past T, chunks that span rows, indices in [-T, 2T), the shared-memory
# table at its 232448-byte limit
LAB_GATHER_PATH_CASES = [
    (2, 3, 8, 33, 11), (2, 3, 8, 33, 20), (1, 2, 8, 5, 0), (2, 5, 12, 100, 1),
    (2, 5, 12, 100, 4), (1, 4, 16, 300, 4), (1, 3, 40, 2000, 4),
    (1, 2, 64, 1024, 64), (3, 8, 2304, 128, 64), (1, 8, 7264, 33, 5),
    (1, 1, 58112, 1500, 3), (2, 5, 7, 33, 9), (1, 3, 2306, 700, 64),
    (1, 2, 7, 2, 0), (4, 3, 7, 50, 1), (1, 2, 2306, 90, 4)]


def _lab_gather_case(device, G, S, T, L, seed):
    gen = torch.Generator(device).manual_seed(seed)
    table = torch.randn((G, S, T), generator=gen, device=device)
    idx = torch.randint(-T, 2 * T, (G, S, L), generator=gen, device=device,
                        dtype=torch.int32)
    return table, idx


def _lab_gather_counted(table, idx, reps, smem, path):
    # one launch, counted under its mode, on the path the C entry reports;
    # the plain version's bits
    from interpol_tpu_torch.ops import lab
    name = "lab_gather_smem" if smem else "lab_gather_global"
    before = lab.LAUNCHES_BY_MODE[name]
    out, took = lab.gather_and_path(table, idx, reps, smem)
    assert lab.LAUNCHES_BY_MODE[name] == before + 1
    assert took == path
    assert torch.equal(out, lab.gather_plain(table, idx, reps))


LAB_GATHER_CASES = [
    (8, 8, 256, 128, 1, True), (3, 8, 2304, 128, 64, True),
    (3, 8, 2304, 128, 64, False), (1, 8, 2**20, 4096, 4, False),
    (2, 5, 7, 33, 9, True)]


@pytest.mark.parametrize("G,S,T,L,reps,smem", LAB_GATHER_CASES + [
    c + (smem,) for c in LAB_GATHER_PATH_CASES for smem in (True, False)
    if c + (smem,) not in LAB_GATHER_CASES])
def test_lab_gather_matches_plain(cuda_device, G, S, T, L, reps, smem):
    from interpol_tpu_torch.ops import lab
    table, idx = _lab_gather_case(cuda_device, G, S, T, L, T)
    _lab_gather_counted(table, idx, reps, smem,
                        "vector" if smem and T % 4 == 0 else "scalar")


@pytest.mark.parametrize("orders,bounds,ex,md,brk", [
    ((3, 3, 3), (3, 3, 3), 1, 2.0, 0.0), ((3, 3, 3), (3, 3, 3), 1, 2.0, 3.0),
    ((0, 1, 2), (5, 0, 6), 0, 1.5, 0.0), ((3, 2, 1), (2, 4, 3), 2, 1.0, 0.0),
    ((2, 3, 0), (1, 6, 4), 1, 1.0, 4.0)])
def test_lab_pull_bf16_matches_plain(cuda_device, orders, bounds, ex, md,
                                     brk):
    from interpol_tpu_torch.ops import lab
    inp, grid = warp_case(cuda_device, (19, 24, 37), disp=md,
                          break_contract=brk)
    out = lab.pull_bf16(inp, grid, orders, bounds, ex, md)
    ref = lab.pull_bf16_plain(inp, grid, orders, bounds, ex, md)
    assert_close(out, ref)
    assert torch.equal(out == 0, ref == 0)


# every bound (zero, replicate, dct1, dct2, dst1, dst2, dft) under every
# extrapolation mask, the orders 0-3 turning over the axes, on a grid that
# reaches past every edge and breaks max_disp at a fifth of its samples
LAB_BF16_CASES = [(tuple((b + ex + k) % 4 for k in range(3)), (b,) * 3, ex)
                  for b in range(7) for ex in (0, 1, 2)]


@pytest.mark.parametrize("orders,bounds,ex", LAB_BF16_CASES)
def test_lab_pull_bf16_every_bound_and_mask(cuda_device, orders, bounds, ex):
    from interpol_tpu_torch.ops import lab
    inp, grid = warp_case(cuda_device, (13, 10, 37), C=3, disp=2.0,
                          break_contract=2.5)
    grid = grid + 3.0 * (torch.rand(grid.shape, device=cuda_device,
                                    generator=torch.Generator(cuda_device)
                                    .manual_seed(sum(orders) + ex)) < 0.1)
    lab.reset_launches()
    out = lab.pull_bf16(inp, grid, orders, bounds, ex, 2.0)
    # two kernels, each counted under its own name: the bf16 pass, the pull
    assert lab.LAUNCHES_BY_MODE["lab_pad_bf16"] == 1
    assert lab.LAUNCHES_BY_MODE["lab_pull_bf16"] == 1
    ref = lab.pull_bf16_plain(inp, grid, orders, bounds, ex, 2.0)
    assert_close(out, ref, lab.TOL_PULL_BF16)
    assert torch.equal(out == 0, ref == 0)
    # the bf16 pass alone gives its plain version's bits
    margins = lab.pad_margins(orders[2], 2.0)
    assert torch.equal(lab.pad_bf16(inp, bounds[2], *margins),
                       lab.pad_bf16_plain(inp, bounds[2], *margins))


def test_lab_pull_bf16_takes_any_batch(cuda_device):
    # 65536 batches of a 4^3 volume: more batches than a grid's y or z
    # axis holds
    from interpol_tpu_torch.ops import lab
    inp, grid = warp_case(cuda_device, (4, 4, 4), C=1, disp=1.0, B=65536)
    out = lab.pull_bf16(inp, grid, (3, 1, 2), (3, 4, 0), 1, 1.0)
    ref = lab.pull_bf16_plain(inp, grid, (3, 1, 2), (3, 4, 0), 1, 1.0)
    assert_close(out, ref, lab.TOL_PULL_BF16)
    assert torch.equal(out == 0, ref == 0)
    assert torch.equal(out[-1:], lab.pull_bf16(inp[-1:], grid[-1:],
                                               (3, 1, 2), (3, 4, 0), 1, 1.0))


def test_lab_gather_takes_any_group_count(cuda_device):
    # 65537 groups: more than a grid's y axis holds; on the 4-byte (T = 5)
    # and, in shared memory, the 16-byte (T = 8) path
    from interpol_tpu_torch.ops import lab
    gen = torch.Generator(cuda_device).manual_seed(1)
    table = torch.randn((65537, 2, 5), generator=gen, device=cuda_device)
    idx = torch.randint(-5, 10, (65537, 2, 3), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    for smem in (True, False):
        assert torch.equal(lab.gather(table, idx, 3, smem),
                           lab.gather_plain(table, idx, 3))
    table, idx = _lab_gather_case(cuda_device, 65537, 2, 8, 3, 11)
    for smem in (True, False):
        _lab_gather_counted(table, idx, 3, smem,
                            "vector" if smem else "scalar")


@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("T", [7, 8, 2304])
def test_lab_gather_misaligned_tables(cuda_device, T, smem):
    # table[1:]: aligned where S T % 4 == 0 (T = 8, 2304), not at T = 7; a
    # table one float into its buffer is not 16-byte aligned at any T
    from interpol_tpu_torch.ops import lab
    G, S, L = 3, 5, 70
    table, idx = _lab_gather_case(cuda_device, G + 1, S, T, L, T)
    sliced = table[1:]
    assert sliced.is_contiguous()
    _lab_gather_counted(sliced, idx[1:], 9, smem,
                        "vector" if smem and T % 4 == 0 else "scalar")
    flat = torch.randn(G * S * T + 1, device=cuda_device)
    shifted = flat[1:].view(G, S, T)
    assert shifted.data_ptr() % 16 != 0
    _lab_gather_counted(shifted, idx[1:], 9, smem, "scalar")


@pytest.mark.parametrize("nacc,dtype,zero", [
    (1, torch.float32, True), (4, torch.float32, False),
    (16, torch.float32, False), (8, torch.bfloat16, False),
    (1, torch.bfloat16, True)])
def test_lab_fma_counts_no_tile_divides(cuda_device, nacc, dtype, zero):
    # an element count that no tile of 256 x 1 or 4 elements divides, with
    # steps left over after the loop unrolled 16 deep: within the gate of
    # the plain version, and the same bits in a second run
    from interpol_tpu_torch.ops import lab
    gen = torch.Generator(cuda_device).manual_seed(7 + nacc)
    a = torch.randn((5, 7, 131), generator=gen, device=cuda_device)
    b = torch.randn((5, 7, 131), generator=gen, device=cuda_device)
    if dtype == torch.bfloat16:
        a, b = a[..., :130].contiguous(), b[..., :130].contiguous()
    reps = 37 * nacc
    ref = lab.fma_plain(a, b, reps, nacc, dtype, zero)
    out = lab.fma(a, b, reps, nacc, dtype, zero)
    assert_close(out, ref, lab.TOL_BF16 if dtype == torch.bfloat16
                 else lab.TOL_F32)
    assert torch.equal(lab.fma(a, b, reps, nacc, dtype, zero), out)


def test_lab_wrappers_raise(cuda_device):
    from interpol_tpu_torch.ops import lab
    a = torch.ones((4, 4), device=cuda_device)
    with pytest.raises(TypeError):
        lab.fma(a.double(), a.double(), 8)
    with pytest.raises(ValueError):
        lab.fma(a[:, :3], a[:, :3].contiguous(), 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):      # 8 x 8192 floats: 256 KB > 227 KB
        lab.gather(torch.ones((1, 8, 8192), device=cuda_device),
                   torch.zeros((1, 8, 4), dtype=torch.int32,
                               device=cuda_device))
    with pytest.raises(TypeError):
        lab.gather(a[None], torch.zeros((1, 4, 2), device=cuda_device))
    with pytest.raises(ValueError):
        inp, grid = warp_case(cuda_device, (8, 8, 8))
        lab.pull_bf16(inp, grid, (5, 3, 3), (3, 3, 3), 1, 1.0)
    with pytest.raises(ValueError):
        lab.pad_bf16(a, 3, -1, 2)


def test_warp_block_knob(cuda_device):
    # every block shape computes the same sums per voxel
    inp, grid = warp_case(cuda_device, (19, 24, 37), disp=2.0)
    opts = ((3, 3, 3), (3, 3, 3), 1, 2.0)
    ref = cuda_warp.warp_cuda(inp, grid, *opts)[0]
    for blk in [(0, 0, 5), (3, 3, 2), (0, 1, 7), (2, 2, 0)]:
        assert torch.equal(cuda_warp.warp_cuda(inp, grid, *opts,
                                               block=blk)[0], ref)
    with pytest.raises(ValueError):
        cuda_warp.warp_cuda(inp, grid, *opts, block=(3, 3, 3))


# ------------------------------------------------------------ multi-device

def test_parallel_on_a_mesh_of_one_nccl_rank(cuda_device, tmp_path):
    # interpol_tpu_torch.parallel on one NCCL rank: each call through the
    # kernels equals the one-device call
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from interpol_tpu_torch import entry, parallel
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        mx = init_device_mesh("cuda", (1,), mesh_dim_names=("x",))
        md = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        inp, grid = warp_case(cuda_device, (24, 16, 40), disp=2.0)
        opts = ((3, 3, 3), (3, 3, 3), 1)
        kw = dict(mesh=mx, max_disp=2.0)
        # the slab ops sample in the halo frame, x + H in float32: hold
        # them to the one-device ops at those coordinates
        H = parallel.halo_width(opts[0], 2.0)
        frame = grid.clone()
        frame[..., 0] = (grid[..., 0] + H) - H
        cuda_warp.reset_launches()
        for fn, ref in [
                (parallel.pull_sharded, tw.pull_window),
                (parallel.grad_sharded, tw.grad_window)]:
            assert_close(fn(inp, grid, *opts, **kw).to_local(),
                         ref(inp, frame, *opts, 2.0))
        assert_close(parallel.push_sharded(inp, grid, (24, 16, 40), *opts,
                                           **kw).to_local(),
                     tw.push_window(inp, frame, *opts, 2.0))
        counts = cuda_warp.LAUNCHES_BY_MODE
        assert counts["value"] >= 2 and counts["grad"] >= 2 \
            and counts["push"] >= 2
        vol = inp[:, :1]
        pts = grid.reshape(1, -1, 3) * 1.3 - 2.0
        vals = inp[:, :1].reshape(1, 1, -1)
        cuda_scattered.reset_launches()
        assert_close(parallel.pull_points(vol, pts, *opts, mesh=md)
                     .to_local(), tpp.pull(vol, pts, *opts))
        assert_close(parallel.push_points(vals, pts, (24, 16, 40), *opts,
                                          mesh=md).to_local(),
                     tpp.push(vals, pts, (24, 16, 40), *opts))
        assert cuda_scattered.LAUNCHES_BY_MODE["sc_value"] >= 1
        assert cuda_scattered.LAUNCHES_BY_MODE["sc_push"] >= 1
        assert_close(parallel.spline_coeff_nd_sharded(
            inp, (3,) * 3, (3,) * 3, 3, mesh=mx).to_local(),
            tc.spline_coeff_nd(inp, (3,) * 3, (3,) * 3, 3))
        assert np.isfinite(entry.dryrun_multichip(1))
    finally:
        dist.destroy_process_group()


# the scattered tier's public functions (ops/scattered.py): orders 0-7 over
# the bounds, D = 1/2/3, C = 1/2/3, points outside both ends of every axis
PUBLIC_SC = [
    ((0, 1, 2), (0, 1, 2), 1, (9, 10, 11), 400, 3),
    ((3, 3, 3), (3, 3, 3), 1, (21, 22, 23), 3000, 1),
    ((4, 5, 6), (4, 5, 6), 0, (9, 10, 11), 300, 2),
    ((7, 7, 7), (6, 5, 4), 2, (8, 9, 10), 200, 3),
    ((3, 1), (3, 4), 0, (33, 18), 700, 2),
    ((5, 0), (6, 1), 1, (20, 21), 500, 1),
    ((7,), (2,), 1, (40,), 100, 2),
    ((2,), (5,), 2, (40,), 100, 3),
]
SC_FUNCS = ("pull_scattered", "grad_scattered", "hess_scattered")


def _public_sc(inp, grid, vals, ct, ish, opts, **kw):
    spl = {k: v for k, v in kw.items() if k != "pre"}
    return [getattr(sc, f)(inp, grid, *opts, **kw) for f in SC_FUNCS] + [
        sc.push_scattered(vals, grid, ish, *opts, **spl),
        sc.pushgrad_scattered(ct, grid, ish, *opts, **spl),
        sc.count_scattered(grid, ish, *opts, **spl)]


@pytest.mark.parametrize("orders,bounds,ex,ish,P,C", PUBLIC_SC)
def test_public_scattered_functions_match_plain(cuda_device, orders, bounds,
                                                ex, ish, P, C):
    inp, grid = sc_case(cuda_device, ish, P, B=1, C=C, seed=7)
    inp, grid = inp[0], grid[0]
    D = len(ish)
    gen = torch.Generator(cuda_device).manual_seed(8)
    vals = torch.randn((C, P), device=cuda_device, generator=gen)
    ct = torch.randn((C, P, D), device=cuda_device, generator=gen)
    opts = (orders, bounds, ex)
    before = dict(cuda_scattered.LAUNCHES_BY_MODE)
    outs = _public_sc(inp, grid, vals, ct, ish, opts)
    launched = {m: cuda_scattered.LAUNCHES_BY_MODE[m] - before[m]
                for m in before}
    assert launched == {"sc_value": 1, "sc_grad": 1, "sc_hess": 1,
                        "sc_value+grad": 0, "sc_grad+hess": 0, "sc_push": 2,
                        "sc_pushgrad": 1, "sc_pushhess": 0}
    i, g = inp[None], grid[None]
    refs = [nd.pull_core(i, g, *opts), nd.grad_core(i, g, *opts),
            nd.hess_core(i, g, *opts),
            nd.push_core(vals[None], g, ish, *opts),
            nd.pushgrad_core(ct[None], g, ish, *opts),
            nd.count_core(g, ish, *opts)]
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape[1:]
        assert_close(out, ref[0])
    assert torch.equal(outs[2], outs[2].transpose(-1, -2))
    # pre= reads the same values; the splats repeat bit for bit; any box
    box = sc.auto_box(ish, P)
    pre = sc.precompute_tables(inp, orders, bounds, box)
    for kw in (dict(box=box, pre=pre), {}, dict(box=(2,) * D)):
        for a, b in zip(_public_sc(inp, grid, vals, ct, ish, opts, **kw),
                        outs):
            assert torch.equal(a, b)
    # the card has no plain path to interpret with
    for f in SC_FUNCS:
        with pytest.raises(ValueError, match="interpret"):
            getattr(sc, f)(inp, grid, *opts, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        sc.push_scattered(vals, grid, ish, *opts, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        sc.count_scattered(grid, ish, *opts, interpret=True)


def _public_sc_grads(device, D):
    """Volume and point gradients of sum(pull**2) + sum(grad**2) through
    pre= (from the volume), and the second order in the points."""
    inp, grid = sc_case("cpu", (13, 14, 15)[:D], 600, B=1, C=2, seed=9)
    opts = ((3, 2, 5)[:D], (3, 6, 1)[:D], 1)
    box = (8,) * D
    vr = inp[0].to(device).requires_grad_()
    pr = grid[0].to(device).requires_grad_()
    pre = sc.precompute_tables(vr, *opts[:2], box)
    loss = (sc.pull_scattered(vr, pr, *opts, box=box, pre=pre) ** 2).sum() \
        + (sc.grad_scattered(vr, pr, *opts, box=box, pre=pre) ** 2).sum()
    dv, dp = torch.autograd.grad(loss, [vr, pr], create_graph=True)
    dv2, dp2 = torch.autograd.grad(dp.square().sum(), [vr, pr])
    return [t.detach().cpu() for t in (dv, dp, dv2, dp2)]


@pytest.mark.parametrize("D", [1, 2, 3])
def test_public_scattered_autograd_card_matches_cpu(cuda_device, D):
    for a, b in zip(_public_sc_grads(cuda_device, D),
                    _public_sc_grads("cpu", D)):
        assert_close(a, b, STEP_TOL)


def test_pre_from_another_volume_on_the_card(cuda_device):
    inp, grid = sc_case(cuda_device, (11, 12, 13), 800, B=1, C=2, seed=10)
    other, _ = sc_case(cuda_device, (11, 12, 13), 1, B=1, C=2, seed=11)
    opts = ((3, 3, 3), (3, 3, 3), 1)
    box = (4, 4, 4)
    ct = torch.randn((2, 800), device=cuda_device)
    vr = inp[0].clone().requires_grad_()
    pre = sc.precompute_tables(other[0], *opts[:2], box)
    out = sc.pull_scattered(vr, grid[0], *opts, box=box, pre=pre)
    assert torch.equal(out, sc.pull_scattered(other[0], grid[0], *opts))
    (dv,) = torch.autograd.grad(out, [vr], ct)
    assert torch.equal(dv, sc.push_scattered(ct, grid[0], (11, 12, 13),
                                             *opts))
