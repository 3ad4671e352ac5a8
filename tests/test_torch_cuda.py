"""The CUDA kernels against their plain PyTorch versions, on the card: the
dense warp's pull value / grad / hess (``csrc/warp.cu``), push and pushgrad
(``csrc/push.cu``), in plain and adaptive (``tile_spread``) mode, the
scattered gather (``csrc/gather.cu``) and splat (``csrc/splat.cu``), the
deterministic plain cores, the autograd Functions (second order included)
and the train steps and the pyramid on them.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU
(the kernels have no CPU mode).  The file imports no JAX, so it also runs on
a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from interpol_tpu_torch import (PyramidModel, SVFModel, WarpModel,
                                grid_grad, grid_pull, grid_push, register,
                                svf_mse_loss)
from interpol_tpu_torch.ops import cuda_scattered, cuda_warp
from interpol_tpu_torch.ops import ndkernels as nd
from interpol_tpu_torch.ops import pushpull as tpp
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
        # race-free: a second run gives the same bits
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


# the race-free splat (csrc/patch_splat.cuh): orders 0-7 over the bounds,
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
    # race-free: the adaptive splats give the same bits on a second run
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
