"""Required work of one ``svf_train_step`` on a batch: per pair, the
velocity's resize and its adjoint; per squaring, the linear pull of the
3 displacement channels (value), its grid cotangent (grad) and its image
cotangent (push); the cubic warp of the image (value, grad; the moving
image needs no cotangent); the Jacobian's spline gradient and its
adjoint.  The flow counts once (the program evaluates it twice).
Kernel 1 (``warp``) carries the pulls, their grid cotangents and the
spline gradient; kernel 2 (``push``) the image cotangents and the
gradient's adjoint; PyTorch the resize."""
from __future__ import annotations

from . import counts


def required(cfg, traffic):
    B, vol, coarse = traffic["batch"], cfg["vol_shape"], cfg["coarse_shape"]
    o = cfg["interpolation"]
    ops = [("resize", *counts.resize(o, 3 * B, coarse, vol), None),
           ("resize.adjoint", *counts.resize(o, 3 * B, vol, coarse), None)]
    for mode, source in (("value", "warp"), ("grad", "warp"),
                         ("push", "push")):
        b, f = counts.warp(mode, (1, 1, 1), B, 3, vol)
        ops.append((f"exp.{mode}", cfg["steps"] * b, cfg["steps"] * f,
                    source))
    for mode in ("value", "grad"):
        ops.append((f"warp.{mode}", *counts.warp(mode, (o,) * 3, B, 1, vol),
                    "warp"))
    if cfg.get("jac_weight"):
        b, f = counts.spline_grad_identity(3, 3 * B, vol)
        ops += [("jacobian", b, f, "warp"), ("jacobian.adjoint", b, f,
                                             "push")]
    return ops
