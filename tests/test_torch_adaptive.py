"""The adaptive per-tile windows (``tile_spread``) of the PyTorch port
against the JAX package.

- the tile geometry (``ops/tiles.py``) and ``required_tile_spread``:
  exactly JAX's (``pallas_warp.default_tile`` / ``_tile_bases``,
  ``api.required_tile_spread``);
- ``check_spread=True``: raises ``RuntimeError`` with JAX's messages where
  JAX raises, and passes on a smooth field;
- the five adaptive plain versions (pull, grad, hess, push, pushgrad): on a
  field that honours the declared spread, equal to JAX's full window (the
  XLA tier, which ignores ``spread``); on a field that breaks it, the
  adaptive pull and push equal the JAX Pallas kernels' adaptive mode in
  interpret mode, at the smallest shape with several tiles;
- the spread-aware adjoints: the port's VJPs equal ``jax.grad`` through the
  JAX pull, and the Functions' backward rules are the derivatives of their
  forwards (``gradcheck``) on a field that breaks the spread.

Float64 on both sides at ``atol=1e-10``: the same taps summed in another
order.  The CUDA kernels' adaptive modes are held to these plain versions
in ``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import interpol_tpu as itp
from interpol_tpu.ops import pallas_warp
from interpol_tpu.ops import window as jw
import interpol_tpu_torch as itt
from interpol_tpu_torch.ops import tiles
from interpol_tpu_torch.ops import window as tw

ATOL = 1e-10
CUBIC = ((3, 3, 3), (3, 3, 3))


def dense_grid(ish, disp, seed, B=1):
    """identity + uniform(-disp, disp), (B, *ish, D)."""
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in ish],
                                 indexing="ij"), -1).astype(np.float64)
    return ident + rng.uniform(-1, 1, (B,) + tuple(ish) + (len(ish),)) \
        * np.asarray(disp)


def smooth_case(N=16, md=2.5, seed=9):
    """The tile-smooth warp of ``tests/test_pallas_warp.py::_smooth_case``:
    displacement constant along z, slowly varying along x / y, so it
    honours a small tile_spread at a large max_disp.  (1, N, N, N)
    volume, (N, N, N, 3) grid."""
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(N)] * 3, indexing="ij"),
                     -1).astype(np.float64)
    x = np.linspace(0, np.pi / 2, N)
    d = np.zeros((N, N, N, 3))
    d[..., 0] = (md * 0.9 * np.sin(x)).reshape(N, 1, 1)
    d[..., 1] = (md * 0.9 * np.cos(x)).reshape(1, N, 1)
    d[..., 2] = (md * 0.9 * np.sin(x + 1)).reshape(N, 1, 1)
    return rng.standard_normal((1, N, N, N)), ident + d


def test_default_tile_and_bases_match_jax():
    for ish in [(16, 8, 12), (8, 8, 128), (9, 17, 400), (4, 4, 200)]:
        for push in (False, True):
            assert tiles.default_tile(ish, push) == \
                pallas_warp.default_tile(ish, push)
    assert tiles.default_tile((8, 8)) is None
    grid = dense_grid((19, 12, 20), (2.5, 1.0, 4.0), 3)[0]
    grid[..., 2] += np.linspace(-3, 3, 19).reshape(19, 1, 1)
    md = (2.0, 1.0, 2.5)
    for push in (False, True):
        tile = tiles.default_tile(grid.shape[:-1], push)
        out = tiles.tile_bases(torch.as_tensor(grid)[None], md, tile)
        ish_a = pallas_warp._aligned(grid.shape[:-1], tile)
        disp, _ = pallas_warp._adaptive_disp(jnp.asarray(grid),
                                             grid.shape[:-1], ish_a,
                                             jnp.float64)
        ntiles = tuple(a // t for a, t in zip(ish_a, tile))
        ref = pallas_warp._tile_bases(disp, md, ntiles, tile)
        assert out.dtype == torch.int32
        for d in range(3):
            np.testing.assert_array_equal(out[0, ..., d].reshape(-1).numpy(),
                                          np.asarray(ref[d]))
        assert out.abs().max() > 0


def test_required_tile_spread_matches_jax():
    for ish, tile in [((19, 12, 20), (8, 8, 128)), ((30, 17), (8, 128)),
                      ((19, 12, 20), (4, 4, 8))]:
        grid = dense_grid(ish, 1.7, 4, B=2)
        assert itt.required_tile_spread(torch.as_tensor(grid), tile) == \
            itp.required_tile_spread(jnp.asarray(grid), tile)


def test_check_spread_raises_where_jax_raises():
    _, smooth = smooth_case(N=16, md=2.5)
    img = np.random.default_rng(5).standard_normal((1, 16, 16, 16))
    broken = dense_grid((16, 16, 16), 1.5, 6)[0]
    cases = [  # grid, max_disp, tile_spread, message or None
        (smooth, 2.5, (1.5, 1.5, 1.5), None),
        (smooth, 1.0, None, "windowed-contract VIOLATED"),
        (broken, 2.0, 0.5, "adaptive-window contract VIOLATED")]
    for grid, md, sp, msg in cases:
        for lib, arr in ((itt, torch.as_tensor), (itp, jnp.asarray)):
            call = lambda: lib.grid_pull(arr(img), arr(grid), 3, "dct2",
                                         max_disp=md, tile_spread=sp,
                                         check_spread=True)
            if msg is None:
                call()
            else:
                with pytest.raises(Exception, match=msg) as err:
                    np.asarray(call())
                if lib is itt:
                    assert err.type is RuntimeError
    with pytest.raises(RuntimeError, match="adaptive-window"):
        itt.grid_push(torch.as_tensor(img), torch.as_tensor(broken),
                      max_disp=2.0, tile_spread=0.5, check_spread=True)
    with pytest.raises(RuntimeError, match="windowed-contract"):
        itt.grid_grad(torch.as_tensor(img), torch.as_tensor(broken),
                      max_disp=1.0, check_spread=True)


def test_api_forwards_tile_spread():
    """grid_pull / grid_grad / grid_push / grid_count pass tile_spread to
    the window functions (a 2-D field that breaks it: taps are dropped)."""
    grid = torch.as_tensor(dense_grid((12, 10), 1.6, 16))
    img = torch.as_tensor(np.random.default_rng(17).standard_normal(
        (1, 2, 12, 10)))
    opts = ((3, 3), (3, 3), 1, 2.0, 0.5)
    kw = dict(interpolation=3, bound="dct2", extrapolate=True, max_disp=2.0,
              tile_spread=0.5)
    for api_fn, win_fn, arg in [(itt.grid_pull, tw.pull_window, img),
                                (itt.grid_grad, tw.grad_window, img),
                                (itt.grid_push, tw.push_window, img)]:
        out = api_fn(arg, grid, **kw)
        torch.testing.assert_close(out, win_fn(arg, grid, *opts), rtol=0,
                                   atol=0)
        assert not torch.equal(out, win_fn(arg, grid, *opts[:4]))
    ones = torch.ones((1, 1, 12, 10), dtype=torch.float64)
    torch.testing.assert_close(itt.grid_count(grid, **kw),
                               tw.push_window(ones, grid, *opts), rtol=0,
                               atol=0)


@pytest.mark.parametrize("name", ["pull", "grad", "hess", "push",
                                  "pushgrad"])
def test_adaptive_plain_versions_equal_full_window(name):
    md, sp = 2.5, (1.5, 1.5, 1.5)
    inp, grid = smooth_case(N=12, md=md)
    assert max(itt.required_tile_spread(torch.as_tensor(grid))) <= 1.5
    if name == "pushgrad":
        inp = np.random.default_rng(10).standard_normal(inp.shape + (3,))
    opts = CUBIC + (1, md)
    out = getattr(tw, f"_{name}_impl_torch")(
        torch.as_tensor(inp)[None], torch.as_tensor(grid)[None], *opts, sp)
    ref = getattr(jw, f"_{name}_impl")(jnp.asarray(inp), jnp.asarray(grid),
                                       *opts)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=ATOL)


def test_adaptive_matches_pallas_on_a_breaking_grid():
    """A field that breaks the declared spread: the port drops the taps the
    JAX kernels drop (in interpret mode), pull and push, two tiles."""
    ish, md, sp = (16, 8, 12), 2.0, 0.5
    rng = np.random.default_rng(11)
    inp = rng.standard_normal((2,) + ish)
    grid = dense_grid(ish, 2.0, 12)[0]
    grid[:8, ..., 0] += 1.0     # the two tiles get different bases
    ji, jg = jnp.asarray(inp), jnp.asarray(grid)
    ti, tg = torch.as_tensor(inp)[None], torch.as_tensor(grid)[None]
    val, _ = pallas_warp.warp_pallas(ji, jg, *CUBIC, 1, md, spread=sp,
                                     interpret=True)
    out = tw.pull_window(ti, tg, *CUBIC, 1, md, spread=sp)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(val), atol=ATOL)
    full = tw.pull_window(ti, tg, *CUBIC, 1, md)
    assert (out - full).abs().max() > 1e-3        # taps were dropped
    ref = pallas_warp.push_window_pallas(ji, jg, *CUBIC, 1, md, spread=sp,
                                         interpret=True)
    out = tw.push_window(ti, tg, *CUBIC, 1, md, spread=sp)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref), atol=ATOL)


def test_adaptive_vjp_matches_jax():
    """The gradients in volume and grid of <pull(v, g), w> with ``spread``
    (a field that honours it) equal jax.grad through the JAX pull."""
    md, sp = 2.5, (1.5, 1.5, 1.5)
    inp, grid = smooth_case(N=12, md=md)
    w = np.random.default_rng(13).standard_normal(inp.shape)
    opts = CUBIC + (1, md, sp)
    ref = jax.grad(lambda v, g: (jw.pull_window(v, g, *opts) * w).sum(),
                   argnums=(0, 1))(jnp.asarray(inp), jnp.asarray(grid))
    v = torch.as_tensor(inp)[None].requires_grad_()
    g = torch.as_tensor(grid)[None].requires_grad_()
    loss = (tw.pull_window(v, g, *opts) * torch.as_tensor(w)[None]).sum()
    dv, dg = torch.autograd.grad(loss, [v, g])
    np.testing.assert_allclose(dv[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(dg[0].numpy(), np.asarray(ref[1]), atol=ATOL)


@pytest.mark.parametrize("fn", ["pull_window", "push_window", "grad_window",
                                "pushgrad_window"])
def test_adaptive_functions_gradcheck(fn):
    """On a 2-D field that breaks the spread (pull and push share the
    lifted (8, 128) tile there), each Function's backward is the
    derivative of its forward, first and second order."""
    ish = (10, 9)
    rng = np.random.default_rng(14)
    grid = torch.as_tensor(dense_grid(ish, 1.6, 15))
    inp = rng.standard_normal((1, 1) + ish + ((2,) if fn == "pushgrad_window"
                                              else ()))
    inp = torch.as_tensor(inp).requires_grad_()
    grid.requires_grad_()
    opts = ((3, 2), (3, 1), 1, 2.0, 0.5)
    f = getattr(tw, fn)
    assert not torch.equal(f(inp, grid, *opts), f(inp, grid, *opts[:4]))
    assert torch.autograd.gradcheck(lambda v, g: f(v, g, *opts),
                                    (inp, grid), fast_mode=True)
    assert torch.autograd.gradgradcheck(lambda v: f(v, grid, *opts),
                                        (inp,), fast_mode=True)
