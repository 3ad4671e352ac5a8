"""Deformable image registration on the PyTorch/CUDA port: learn a smooth
dense deformation that warps a moving volume onto a fixed one.

  * coarse displacement control points, upsampled to a dense flow with the
    separable ``resize``;
  * ``grid_pull`` warping on the bounded-displacement path (``max_disp``):
    on the card the dense-warp kernel, with hand-wired adjoints
    (``torch.autograd.Function``s) in the backward;
  * adaptive per-tile windows (``tile_spread="auto"``), the coarse-to-fine
    pyramid (``register``), the diffeomorphic ``SVFModel`` and a
    Jacobian-determinant regulariser differentiated through ``grid_grad``.

Run:  python examples/torch_registration.py [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

import interpol_tpu_torch as itt
from interpol_tpu_torch import (PyramidModel, SVFModel, WarpModel, register,
                                svf_train_step, train_step)


def make_pair(rng, shape, model, device):
    """A synthetic (moving, fixed) pair with a known smooth warp."""
    f32 = dict(dtype=torch.float32, device=device)
    moving = torch.as_tensor(rng.standard_normal((1, 1) + shape), **f32)
    # smooth it a little so the MSE landscape is informative
    moving = itt.resize(itt.restrict(moving, factor=2, interpolation=1),
                        shape=list(shape), interpolation=3)
    true_params = torch.as_tensor(
        rng.uniform(-2.0, 2.0, (1,) + model.coarse_shape + (len(shape),)),
        **f32)
    with torch.no_grad():
        fixed = model.warp(moving, true_params)
    return moving, fixed


def main(device):
    rng = np.random.default_rng(0)
    shape = (16, 16, 32)
    model = WarpModel(vol_shape=shape, coarse_shape=(4, 4, 4),
                      interpolation=3, bound="dct2", max_disp=3.0,
                      device=device)
    moving, fixed = make_pair(rng, shape, model, device)

    for step in range(8):
        loss = train_step(model, moving, fixed, lr=2.0)
        if step % 3 == 0 or step == 7:
            print(f"step {step:2d}  mse {loss.item():.6f}")

    with torch.no_grad():
        err = torch.mean((model.warp(moving) - fixed) ** 2).item()
    base = torch.mean((moving - fixed) ** 2).item()
    print(f"final alignment mse {err:.6f} (unregistered: {base:.6f})")

    # adaptive per-tile windows: the bound from the coarse geometry (the
    # flow is tile-smooth: upsampled from clamped coarse control points)
    model_ad = WarpModel(vol_shape=shape, coarse_shape=(4, 4, 4),
                         interpolation=3, bound="dct2", max_disp=8.0,
                         tile_spread="auto", coarse_clamp=True,
                         device=device)
    print("adaptive-window bound from the coarse geometry:",
          tuple(round(s, 2) for s in model_ad.auto_tile_spread()))
    if torch.device(device).type == "cuda":
        # on the CPU the plain version sums the whole max_disp=8 window;
        # on the card it is one kernel launch
        loss0 = train_step(model_ad, moving, fixed, lr=2.0)
        print(f"adaptive-window model (max_disp=8): first-step mse "
              f"{loss0.item():.6f}")

    # --- coarse-to-fine pyramid -------------------------------------
    pyr = PyramidModel(vol_shape=shape, coarse_shape=(4, 4, 4), levels=2,
                       interpolation=3, bound="dct2", max_disp=3.0,
                       steps_per_level=8, device=device)
    params_pyr, losses = register(pyr, moving, fixed, lr=2.0)
    for lev in range(pyr.levels):
        print(f"pyramid level {lev} ({pyr.level_shapes()[lev]}): "
              f"mse {losses[lev, 0].item():.6f} -> "
              f"{losses[lev, -1].item():.6f}")
    with torch.no_grad():
        err = torch.mean((pyr.finest().warp(moving, params_pyr)
                          - fixed) ** 2).item()
    print(f"pyramid final alignment mse {err:.6f}")

    # --- diffeomorphic (SVF) registration ----------------------------
    svf = SVFModel(vol_shape=shape, coarse_shape=(4, 4, 4), interpolation=3,
                   max_disp=3.0, steps=6, device=device)
    for _ in range(10):
        loss = svf_train_step(svf, moving, fixed, lr=2.0)
    with torch.no_grad():
        det = itt.jacobian_det(svf.flow())
        back = svf.warp(svf.warp(moving), inverse=True)
    m = [max(1, n // 4) for n in shape]       # interior (skip edge taps)
    inv_err = (back - moving)[:, :, m[0]:-m[0], m[1]:-m[1],
                              m[2]:-m[2]].abs().max().item()
    print(f"svf: mse {loss.item():.6f}, det J in "
          f"[{det.min().item():.3f}, {det.max().item():.3f}], "
          f"inverse-consistency {inv_err:.4f}")

    # --- Jacobian-determinant regularisation (second order) -----------
    u0 = 0.5 * torch.tanh(torch.as_tensor(
        np.random.default_rng(7).standard_normal(shape + (3,)),
        dtype=torch.float32, device=device))

    def reg_loss(u):
        return torch.mean((itt.jacobian_det(u[None]) - 1.0) ** 2)

    u = u0.clone().requires_grad_()
    (g,) = torch.autograd.grad(reg_loss(u), [u])
    with torch.no_grad():
        print(f"jacdet regularizer: loss {reg_loss(u0).item():.5f} -> "
              f"{reg_loss(u0 - 5.0 * g).item():.5f} after one step "
              f"(|dL/du|_max {g.abs().max().item():.4f})")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
