"""``SVFModel`` / ``svf_train_step`` of ``interpol_tpu_torch``."""
from __future__ import annotations

import interpol_tpu_torch as itt

KIND = "svf"


def build(cfg, batch, device):
    return itt.SVFModel(cfg["vol_shape"], cfg["coarse_shape"],
                        interpolation=cfg["interpolation"],
                        bound=cfg["bound"], max_disp=cfg["max_disp"],
                        steps=cfg["steps"], batch=batch, device=device)


def train_step(model, moving, fixed, cfg, traffic):
    return itt.svf_train_step(model, moving, fixed, lr=traffic["lr"],
                              jac_weight=cfg["jac_weight"])


def apply(model, params, t1, labels, cfg, traffic, classes):
    """One request: integrate ``params`` (1, *coarse, 3), warp the image
    (``SVFModel.warp``'s pull) and the label map (the label path) along
    the one flow."""
    grid = itt.add_identity_grid(model.flow(params))
    img = itt.grid_pull(t1, grid, interpolation=cfg["interpolation"],
                        bound=cfg["bound"], extrapolate=True,
                        max_disp=cfg["max_disp"])
    lab = itt.grid_pull(labels, grid, interpolation=traffic["label_order"],
                        bound=cfg["bound"], extrapolate=True,
                        classes=classes, max_disp=cfg["max_disp"])
    return img, lab
