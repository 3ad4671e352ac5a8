"""Affine rotation via ``affine_grid`` + ``grid_pull`` on the PyTorch/CUDA
port: a rotation about the image centre, resampled with interpolating
cubic splines.

Run:  python examples/torch_rotation.py [--device cuda|cpu]
"""
import argparse
import math

import numpy as np
import torch

import interpol_tpu_torch as itt


def rotation_matrix_2d(theta, center):
    c, s = math.cos(theta), math.sin(theta)
    A = np.eye(3)
    A[:2, :2] = [[c, -s], [s, c]]
    A[:2, 2] = center - A[:2, :2] @ center
    return A


def main(device):
    H = W = 192
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    image = np.exp(-(((yy - 70) / 25.) ** 2 + ((xx - 96) / 14.) ** 2))
    image = torch.as_tensor(image, dtype=torch.float32, device=device)

    A = rotation_matrix_2d(math.radians(30),
                           np.array([(H - 1) / 2, (W - 1) / 2]))
    grid = itt.affine_grid(torch.as_tensor(A, dtype=torch.float32,
                                           device=device), (H, W))
    rotated = itt.grid_pull(image, grid, interpolation=3, bound="dct2",
                            extrapolate=True, prefilter=True)
    print("input mass ", image.sum().item())
    print("output mass", rotated.sum().item())
    print("shape", tuple(rotated.shape))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
