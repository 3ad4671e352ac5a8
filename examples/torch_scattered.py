"""Scattered-grid sampling on the PyTorch/CUDA port: probe a volume at an
arbitrary point cloud (landmark tracking, surface sampling, sparse loss
evaluation).

A point cloud takes the generic path: on the card, the scattered gather
(kernel 3, ``csrc/gather.cu``) and splat (kernel 4, ``csrc/splat.cu``),
for every number of points; on the CPU, the plain cores.  Repeated
sampling of one volume can pass ``precompute_tables`` as ``pre=``.

Run:  python examples/torch_scattered.py [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

import interpol_tpu_torch as itt
from interpol_tpu_torch.ops import scattered as sc


def main(device):
    rng = np.random.default_rng(0)
    shape = (48, 48, 64)
    f32 = dict(dtype=torch.float32, device=device)
    vol = torch.as_tensor(rng.standard_normal((1, 1) + shape)
                          .astype(np.float32), **f32)

    # a point cloud in voxel coordinates: grid_pull accepts any grid
    # shape (..., *points_shape, 3), a (P, 3) list is a "1-D image of
    # samples"
    pts = torch.as_tensor((rng.random((20000, 3))
                           * (np.asarray(shape) - 1)).astype(np.float32),
                          **f32)
    vals = itt.grid_pull(vol, pts[None], interpolation=3, bound="dct2",
                         extrapolate=True, prefilter=True)
    print("sampled:", tuple(vals.shape), "mean", vals.mean().item())

    # gradients w.r.t. the point positions (landmark registration: move
    # the points to brighten the samples)
    p = pts.clone().requires_grad_()
    brightness = itt.grid_pull(vol, p[None], interpolation=3, bound="dct2",
                               extrapolate=True).sum()
    (g,) = torch.autograd.grad(brightness, [p])
    print("d(sum)/d(points):", tuple(g.shape), "|g| mean",
          g.abs().mean().item())

    # expert path: sampling the same volume again and again (iterative
    # landmark tracking), with the tables built once.  On the card the
    # whole cloud and auto_box; on the CPU the small cloud and box of the
    # JAX example's interpret-mode run
    on_card = vol.device.type == "cuda"
    orders, bounds = (3, 3, 3), (3, 3, 3)          # cubic, dct2
    track = pts if on_card else pts[:512]
    box = sc.auto_box(shape, track.shape[0]) if on_card else (4, 4, 8)
    inp = vol[0, 0][None]
    pre = sc.precompute_tables(inp, orders, bounds, box)
    moved = track
    for it in range(3):
        v = sc.pull_scattered(inp, moved, orders, bounds, 1, box=box,
                              pre=pre)
        dv = sc.grad_scattered(inp, moved, orders, bounds, 1, box=box,
                               pre=pre)
        moved = moved + 0.5 * dv[0]                # gradient ascent
        print(f"iter {it}: mean value {v.mean().item():.4f}")
    return moved


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
