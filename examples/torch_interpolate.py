"""Random smooth deformation warp on the PyTorch/CUDA port: draw a coarse
random displacement, upsample it with cubic splines, warp an image along
it, and learn the displacement back with the registration model.

Run:  python examples/torch_interpolate.py [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

import interpol_tpu_torch as itt
from interpol_tpu_torch import WarpModel, train_step


def main(device):
    rng = np.random.default_rng(0)
    H = W = 64
    f32 = dict(dtype=torch.float32, device=device)

    # smooth random deformation: coarse control points -> dense field
    coarse = torch.as_tensor(rng.standard_normal((8, 8, 2)) * 2.0, **f32)
    disp = itt.resize(torch.movedim(coarse, -1, 0), shape=[H, W],
                      interpolation=3, prefilter=False)
    grid = itt.add_identity_grid(torch.movedim(disp, 0, -1))

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    image = torch.as_tensor(
        np.exp(-(((yy - 24) / 9.) ** 2 + ((xx - 32) / 5.) ** 2)), **f32)
    warped = itt.grid_pull(image, grid, interpolation=3, bound="dct2",
                           extrapolate=True, prefilter=True)
    print("warped:", tuple(warped.shape), "max", warped.max().item())

    # inverse problem: recover a warp registering image -> warped
    model = WarpModel(vol_shape=(H, W), coarse_shape=(8, 8),
                      interpolation=1, max_disp=4.0, device=device)
    moving, fixed = image[None, None], warped[None, None]
    for step in range(20):
        loss = train_step(model, moving, fixed, lr=2.0)
        if step % 5 == 0:
            print(f"step {step:3d}  loss {loss.item():.6f}")
    print(f"final loss {loss.item():.6f}")

    # adaptive per-tile windows: measure the field's residual bound over
    # the kernel's tiles, then declare it
    sp = itt.required_tile_spread(grid[None])
    print("required_tile_spread:", tuple(round(s, 2) for s in sp))
    warped_ad = itt.grid_pull(image, grid, interpolation=3, bound="dct2",
                              extrapolate=True, prefilter=True,
                              max_disp=4.0,
                              tile_spread=tuple(s + 0.25 for s in sp))
    err = (warped_ad - warped).abs().max().item()
    print(f"adaptive-window warp matches: maxerr {err:.2e}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
