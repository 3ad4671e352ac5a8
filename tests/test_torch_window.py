"""Dense-warp window tier of the PyTorch port against the JAX package.

The plain (CPU) ``pull_window`` / ``grad_window`` are held to
``interpol_tpu.ops.window._pull_impl`` / ``_grad_impl`` on the CPU XLA
tier, and once to the Pallas kernel in interpret mode, in float64 at
``atol=1e-10``.  The CUDA kernel is held to the plain version in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interpol_tpu.ops import pallas_warp
from interpol_tpu.ops import window as jw
from interpol_tpu_torch.ops import cuda_warp
from interpol_tpu_torch.ops import window as tw

ATOL = 1e-10   # float64 on both sides; only the summation order differs


def warp_case(ish, C=2, disp=1.5, seed=0, break_contract=0.0, B=1):
    """Volume (B, C, *ish) and grid identity + uniform(-disp, disp); with
    ``break_contract`` a fifth of the displacements are scaled by it."""
    rng = np.random.default_rng(seed)
    D = len(ish)
    inp = rng.standard_normal((B, C) + tuple(ish))
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1)
    d = rng.uniform(-1, 1, (B,) + tuple(ish) + (D,)) * np.asarray(disp)
    if break_contract:
        d = d * np.where(rng.uniform(size=d.shape) < 0.2, break_contract,
                         1.0)
    return inp, ident + d


CASES = [
    # orders, bounds, extrapolate, ishape, max_disp, break_contract
    ((3, 3, 3), (3, 3, 3), 1, (6, 7, 9), 1.5, 0.0),
    ((1, 1, 1), (6, 6, 6), 0, (6, 7, 9), 1.5, 0.0),
    ((3, 2, 1), (0, 4, 5), 2, (6, 7, 9), 1.5, 0.0),
    ((0, 0, 0), (2, 1, 4), 1, (6, 7, 9), 1.5, 0.0),
    ((3, 3, 3), (4, 5, 6), 0, (6, 7, 9), 1.0, 0.0),
    ((3, 3, 3), (3, 3, 3), 1, (6, 7, 9), 1.0, 4.0),      # breaks max_disp
    ((2, 2, 2), (3, 2, 0), 1, (6, 7, 9), (0.5, 1.5, 1.0), 0.0),
    ((3, 1), (3, 0), 2, (12, 16), 1.5, 0.0),              # 2-D
]


@pytest.mark.parametrize("orders,bounds,ex,ish,md,brk", CASES)
def test_window_matches_jax(orders, bounds, ex, ish, md, brk):
    inp, grid = warp_case(ish, disp=md, break_contract=brk)
    ref_v = jw._pull_impl(jnp.asarray(inp[0]), jnp.asarray(grid[0]),
                          orders, bounds, ex, md)
    ref_g = jw._grad_impl(jnp.asarray(inp[0]), jnp.asarray(grid[0]),
                          orders, bounds, ex, md)
    ti, tg = torch.as_tensor(inp), torch.as_tensor(grid)
    out_v = tw.pull_window(ti, tg, orders, bounds, ex, md)
    out_g = tw.grad_window(ti, tg, orders, bounds, ex, md)
    np.testing.assert_allclose(out_v[0].numpy(), np.asarray(ref_v),
                               atol=ATOL)
    np.testing.assert_allclose(out_g[0].numpy(), np.asarray(ref_g),
                               atol=ATOL)


def test_window_batched_matches_per_item():
    inp, grid = warp_case((5, 6, 7), B=3, seed=1)
    ti, tg = torch.as_tensor(inp), torch.as_tensor(grid)
    out = tw.pull_window(ti, tg, (3, 3, 3), (3, 3, 3), 1, 1.5)
    for b in range(3):
        one = tw.pull_window(ti[b:b + 1], tg[b:b + 1], (3, 3, 3),
                             (3, 3, 3), 1, 1.5)
        torch.testing.assert_close(out[b:b + 1], one, rtol=0, atol=0)


def test_window_matches_pallas_interpret():
    inp, grid = warp_case((8, 8, 64), seed=2)
    val, g = pallas_warp.warp_pallas(
        jnp.asarray(inp[0]), jnp.asarray(grid[0]), (3, 3, 3), (3, 3, 3),
        0, 1.5, value=True, grad=True, tile=(8, 8, 64), interpret=True)
    ti, tg = torch.as_tensor(inp), torch.as_tensor(grid)
    out_v = tw.pull_window(ti, tg, (3, 3, 3), (3, 3, 3), 0, 1.5)
    out_g = tw.grad_window(ti, tg, (3, 3, 3), (3, 3, 3), 0, 1.5)
    np.testing.assert_allclose(out_v[0].numpy(), np.asarray(val),
                               atol=ATOL)
    np.testing.assert_allclose(out_g[0].numpy(), np.asarray(g), atol=ATOL)


@pytest.mark.parametrize("order,max_disp,expect", [
    (0, 0.5, (-1, 1)), (0, 1.5, (-2, 2)), (1, 1.0, (-1, 2)),
    (3, 1.0, (-2, 3)), (3, 4.0, (-5, 6)), (7, 1.5, (-5, 5))])
def test_window_range(order, max_disp, expect):
    assert tw.window_range(order, max_disp) == expect \
        == jw.window_range(order, max_disp)


def test_cuda_wrapper_refuses_cpu_tensors():
    inp, grid = warp_case((4, 5, 6))
    ti = torch.as_tensor(inp, dtype=torch.float32)
    tg = torch.as_tensor(grid, dtype=torch.float32)
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_warp.warp_cuda(ti, tg, (3, 3, 3), (3, 3, 3), 1, 1.5)
