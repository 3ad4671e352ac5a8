"""The dense-warp CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips where there is no NVIDIA GPU
(the kernel has no CPU mode).  The file imports no JAX, so it also runs on
a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from interpol_tpu_torch import WarpModel, grid_grad, grid_pull
from interpol_tpu_torch.ops import cuda_warp
from interpol_tpu_torch.ops import window as tw

pytestmark = pytest.mark.cuda

# float32 sums of at most 512 non-zero taps taken in another order
REL_TOL = 1e-5


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


def assert_close(out, ref):
    tol = REL_TOL * max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("orders,bounds,ex,ish,md,brk", [
    ((3, 3, 3), (3, 3, 3), 1, (11, 12, 13), 1.5, 0.0),
    ((1, 1, 1), (6, 6, 6), 0, (11, 12, 13), 1.5, 0.0),
    ((3, 2, 1), (0, 4, 5), 2, (19, 24, 37), 1.5, 0.0),
    ((0, 0, 0), (2, 1, 4), 1, (11, 12, 13), 1.5, 0.0),
    ((7, 5, 4), (4, 5, 6), 0, (11, 12, 13), 1.0, 0.0),
    ((3, 3, 3), (3, 3, 3), 1, (11, 12, 13), 1.0, 4.0),    # breaks max_disp
    ((2, 2, 2), (3, 2, 0), 1, (11, 12, 13), (0.5, 1.5, 1.0), 0.0),
    ((3, 1), (3, 0), 2, (30, 17), 1.5, 0.0),                # 2-D
    ((5,), (6,), 1, (40,), 1.5, 0.0),                       # 1-D
])
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
    with pytest.raises(ValueError, match="contiguous"):
        cuda_warp.warp_cuda(inp.transpose(2, 3), grid, *opts)
    with pytest.raises(NotImplementedError, match="requires grad"):
        tw.pull_window(inp.requires_grad_(), grid, *opts)
