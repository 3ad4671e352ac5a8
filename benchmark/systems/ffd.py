"""``WarpModel`` / ``train_step`` of ``interpol_tpu_torch`` (B-spline
free-form deformation)."""
from __future__ import annotations

import interpol_tpu_torch as itt

KIND = "ffd"


def build(cfg, batch, device):
    return itt.WarpModel(cfg["vol_shape"], cfg["coarse_shape"],
                         interpolation=cfg["interpolation"],
                         bound=cfg["bound"], max_disp=cfg["max_disp"],
                         batch=batch, device=device)


def train_step(model, moving, fixed, cfg, traffic):
    return itt.train_step(model, moving, fixed, lr=traffic["lr"])
