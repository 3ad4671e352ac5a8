"""Required work of one ``train_step`` of the FFD model on a batch: per
pair, the control points' resize and its adjoint, and the cubic warp of
the image (value, and grad for the grid cotangent).  Kernel 1
(``warp``) carries the warp; PyTorch the resize."""
from __future__ import annotations

from . import counts


def required(cfg, traffic):
    B, vol, coarse = traffic["batch"], cfg["vol_shape"], cfg["coarse_shape"]
    o = cfg["interpolation"]
    return [("resize", *counts.resize(o, 3 * B, coarse, vol), None),
            ("resize.adjoint", *counts.resize(o, 3 * B, vol, coarse), None),
            ("warp.value", *counts.warp("value", (o,) * 3, B, 1, vol),
             "warp"),
            ("warp.grad", *counts.warp("grad", (o,) * 3, B, 1, vol),
             "warp")]
