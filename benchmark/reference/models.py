"""The registration models of the configurations, written plainly: one
pair at a time, float64 (or the precision the caller asks for), autograd
for the gradients.

``svf_loss`` follows ``interpol_tpu_torch/models/svf.py`` (``velocity``:
tanh clamp at the coarse nodes, cubic resize; ``flow``: scaling and
squaring with linear pulls; ``svf_mse_loss``: image MSE plus
``jac_weight`` x mean log|J|^2); ``ffd_loss`` follows
``models/warp.py`` (cubic resize, per-axis scale, tanh clamp; MSE).  The
flow is computed once where the program computes it twice: the same
function of the parameters.  A batch's loss is the mean of its pairs'
losses (every pair has as many voxels), so slot ``b`` of a batch of B
gets ``grad(loss_b) / B``.
"""
from __future__ import annotations

import torch

from .ops import (exp_disp, identity, jacobian_det, label_pull, pull,
                  resize)


def _scale(cfg):
    return [v / c for v, c in zip(cfg["vol_shape"], cfg["coarse_shape"])]


def svf_flow(p, cfg):
    """Displacement exp(v) (3, *vol) of control points p (*coarse, 3)."""
    md = cfg["max_disp"]
    sc = torch.tensor(_scale(cfg), dtype=p.dtype,
                      device=p.device).reshape(3, 1, 1, 1)
    vel = md * torch.tanh(torch.movedim(p, -1, 0) * sc / md)
    vel = resize(vel, cfg["vol_shape"], cfg["interpolation"])
    return exp_disp(vel, cfg["steps"])


def svf_loss(p, moving, fixed, cfg):
    """One pair's loss: moving, fixed (*vol)."""
    flow = svf_flow(p, cfg)
    grid = identity(tuple(cfg["vol_shape"]), p.dtype, p.device) \
        + torch.movedim(flow, 0, -1)
    warped = pull(moving[None], grid, cfg["interpolation"])[0]
    loss = torch.mean((warped - fixed) ** 2)
    if cfg.get("jac_weight"):
        logj = torch.log(jacobian_det(flow))
        loss = loss + cfg["jac_weight"] * torch.mean(logj ** 2)
    return loss


def ffd_loss(p, moving, fixed, cfg):
    """One pair's loss of the B-spline FFD model."""
    md = cfg["max_disp"]
    sc = torch.tensor(_scale(cfg), dtype=p.dtype,
                      device=p.device).reshape(3, 1, 1, 1)
    disp = resize(torch.movedim(p, -1, 0), cfg["vol_shape"],
                  cfg["interpolation"]) * sc
    disp = md * torch.tanh(disp / md)
    grid = identity(tuple(cfg["vol_shape"]), p.dtype, p.device) \
        + torch.movedim(disp, 0, -1)
    warped = pull(moving[None], grid, cfg["interpolation"])[0]
    return torch.mean((warped - fixed) ** 2)


LOSSES = {"svf": svf_loss, "ffd": ffd_loss}


def train_steps(kind, cfg, p0, batches, lr, batch, dtype):
    """SGD on the mean loss of each batch, slot by slot.

    ``p0`` (B, *coarse, 3); ``batches``: a list of (moving, fixed) pairs
    of (B, 1, *vol) tensors, one a step; the model's slot b meets pair b
    of every batch.  Returns ``(losses, g1, dp)``: the batch loss of each
    step, the first step's gradient (B, *coarse, 3) and the parameters'
    change after the last step, all in ``dtype``."""
    loss_fn = LOSSES[kind]
    n = len(batches)
    losses = torch.zeros(n, dtype=dtype)
    g1 = torch.zeros(p0.shape, dtype=dtype, device=p0.device)
    dp = torch.zeros(p0.shape, dtype=dtype, device=p0.device)
    for b in range(batch):
        p = p0[b].to(dtype)
        for k, (mov, fix) in enumerate(batches):
            q = p.detach().requires_grad_(True)
            loss = loss_fn(q, mov[b, 0].to(dtype), fix[b, 0].to(dtype), cfg)
            (g,) = torch.autograd.grad(loss, [q])
            g = g / batch
            losses[k] += loss.detach().cpu() / batch
            if k == 0:
                g1[b] = g
            p = p.detach() - lr * g
        dp[b] = p - p0[b].to(dtype)
    return losses, g1, dp


def svf_apply(p, t1, labels, cfg, classes, label_order, dtype):
    """One request: the warped image and label map of one subject.
    ``p`` (*coarse, 3), ``t1`` (*vol) float, ``labels`` (*vol) integer."""
    with torch.no_grad():
        flow = svf_flow(p.to(dtype), cfg)
        grid = identity(tuple(cfg["vol_shape"]), dtype, p.device) \
            + torch.movedim(flow, 0, -1)
        img = pull(t1[None].to(dtype), grid, cfg["interpolation"])[0]
        lab = label_pull(labels, grid, classes, label_order)
    return img, lab
