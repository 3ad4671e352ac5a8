"""The frozen reference against the program's plain path (CPU, float64,
tiny shapes).  This test imports the program; the reference does not."""
import pytest
import torch

import interpol_tpu_torch as itt
from interpol_tpu_torch.ops import window as W
from benchmark.reference import models as rm
from benchmark.reference import ops as ro

DT = torch.float64
DCT2 = 3   # BoundType.dct2


def _grid(shape, amp, gen):
    """A grid whose displacements keep within ``max_disp`` (4), where the
    window's pull and the direct gather agree."""
    return ro.identity(shape, DT, "cpu") + (amp * torch.randn(
        shape + (3,), dtype=DT, generator=gen)).clamp(-3.5, 3.5)


@pytest.mark.parametrize("order", [1, 3])
def test_pull_grad_push_match_the_window_plain_versions(order):
    gen = torch.Generator().manual_seed(order)
    shape = (5, 6, 7)
    inp = torch.randn((2,) + shape, dtype=DT, generator=gen)
    grid = _grid(shape, 1.5, gen)
    opts = ((order,) * 3, (DCT2,) * 3, 1, 4.0)
    want = W._pull_impl_torch(inp[None], grid[None], *opts)[0]
    assert torch.allclose(ro.pull_value(inp, grid, order), want,
                          rtol=1e-12, atol=1e-12)
    want = W._grad_impl_torch(inp[None], grid[None], *opts)[0]
    assert torch.allclose(ro.spatial_grad(inp, grid, order), want,
                          rtol=1e-12, atol=1e-12)
    want = W._push_impl_torch(inp[None], grid[None], *opts)[0]
    assert torch.allclose(ro.push(inp, grid, order, shape), want,
                          rtol=1e-12, atol=1e-12)


def test_pull_backward_is_exact():
    gen = torch.Generator().manual_seed(0)
    inp = torch.randn((2, 4, 5, 6), dtype=DT, generator=gen,
                      requires_grad=True)
    grid = _grid((4, 5, 6), 1.0, gen).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: ro.pull(a, b, 3),
                                     (inp, grid))


def test_resize_exp_and_jacobian_match_the_program():
    gen = torch.Generator().manual_seed(1)
    v = torch.randn((1, 3, 4, 5, 6), dtype=DT, generator=gen)
    want = itt.resize(v, shape=[8, 10, 12], anchor=["e"] * 3,
                      interpolation=3, bound="dct2", prefilter=False)
    assert torch.allclose(ro.resize(v[0], (8, 10, 12), 3), want[0],
                          rtol=1e-12, atol=1e-12)
    vel = 0.8 * torch.randn((3, 6, 7, 8), dtype=DT, generator=gen)
    want = itt.exp_disp(torch.movedim(vel, 0, -1)[None], steps=5,
                        interpolation=1, bound="dct2", max_disp=4.0)[0]
    got = torch.movedim(ro.exp_disp(vel, 5), 0, -1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    want = itt.jacobian_det(want[None])[0]
    assert torch.allclose(ro.jacobian_det(torch.movedim(got, -1, 0)),
                          want, rtol=1e-12, atol=1e-12)


def test_label_rule_matches_the_program():
    gen = torch.Generator().manual_seed(2)
    lab = torch.randint(0, 5, (6, 7, 8), dtype=torch.uint8, generator=gen)
    grid = _grid((6, 7, 8), 1.2, gen)
    want = itt.grid_pull(lab[None, None], grid[None], interpolation=1,
                         bound="dct2", extrapolate=True,
                         classes=list(range(5)), max_disp=4.0)[0, 0]
    got = ro.label_pull(lab, grid, list(range(5)), 1, chunk=2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["svf", "ffd"])
def test_losses_and_gradients_match_the_models(kind):
    gen = torch.Generator().manual_seed(3)
    vol, coarse = (8, 9, 10), ((4, 5, 5) if kind == "svf" else (3, 3, 4))
    cfg = dict(vol_shape=vol, coarse_shape=coarse, interpolation=3,
               max_disp=4.0, steps=4, jac_weight=0.1 if kind == "svf"
               else 0.0)
    p0 = 0.3 * torch.randn((2,) + coarse + (3,), dtype=DT, generator=gen)
    mov = torch.rand((2, 1) + vol, dtype=DT, generator=gen)
    fix = torch.rand((2, 1) + vol, dtype=DT, generator=gen)
    if kind == "svf":
        model = itt.SVFModel(vol, coarse, 3, "dct2", 4.0, 4, batch=2,
                             device="cpu", dtype=DT)
    else:
        model = itt.WarpModel(vol, coarse, 3, "dct2", 4.0, batch=2,
                              device="cpu", dtype=DT)
    with torch.no_grad():
        model.params.copy_(p0)
    steps = []
    for _ in range(2):
        if kind == "svf":
            steps.append(float(itt.svf_train_step(model, mov, fix, 0.5,
                                                  0.1)))
        else:
            steps.append(float(itt.train_step(model, mov, fix, 0.5)))
    losses, g1, dp = rm.train_steps(kind, cfg, p0, [(mov, fix)] * 2, 0.5,
                                    2, DT)
    assert torch.allclose(losses, torch.tensor(steps, dtype=DT),
                          rtol=1e-12)
    assert torch.allclose(p0 + dp, model.params.detach(), rtol=1e-10,
                          atol=1e-14)
