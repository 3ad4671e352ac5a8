"""Multi-order upsampling on the PyTorch/CUDA port: resize the same image
with orders 0..7 and report the interpolation error at the original
sample sites.

Run:  python examples/torch_resize.py [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

import interpol_tpu_torch as itt


def main(device):
    rng = np.random.default_rng(0)
    image = torch.as_tensor(rng.standard_normal((1, 1, 32, 32)),
                            dtype=torch.float32, device=device)

    for order in range(8):
        # anchor='first': output position k samples input at k/4, so the
        # ::4 subgrid hits the original sample sites exactly; with
        # prefilter=True the resize interpolates and recovers them.
        # bound='dct2' so that the evaluation folds as the prefilter does
        # (the default 'nearest' aliases to dct2 in the filter only).
        up = itt.resize(image, factor=[4, 4], anchor="first",
                        interpolation=order, bound="dct2", prefilter=True)
        err = (up[..., ::4, ::4] - image).abs().max().item()
        print(f"order {order}: upsampled {tuple(up.shape)}, "
              f"interpolation error at original sites {err:.2e}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
