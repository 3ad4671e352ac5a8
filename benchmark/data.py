"""Inputs made from the seed, on the device, in a few large calls.

A subject is a synthetic T1 head: an ellipsoid head whose brain is cut
into 35 labelled cells (the Voronoi cells of 35 random centres, one
intensity each), under a smooth bias field and a little noise.  A moving
image is its subject under a smooth random warp (``grid_sample``,
trilinear).  Control points are smooth random fields.  Everything comes
from one ``torch.Generator`` on the device seeded with ``--seed``, drawn
in a fixed order, so a seed gives the same inputs on every run.  No
download, no weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def smooth(gen, n, channels, lo, hi, device):
    """(n, channels, *hi) fields: N(0, 1) on the coarse grid ``lo``,
    trilinear up to ``hi``."""
    z = torch.randn((n, channels) + tuple(lo), generator=gen, device=device)
    return F.interpolate(z, size=tuple(hi), mode="trilinear",
                         align_corners=True)


def _coords(shape, device):
    return [torch.linspace(-1, 1, s, device=device).reshape(
        [s if a == d else 1 for a in range(3)]) for d, s in enumerate(shape)]


def subjects(gen, n, shape, labels, device):
    """``(t1, lab)``: (n, 1, *shape) float32 and uint8 label maps with
    classes 0 (background) to ``labels``."""
    x = _coords(shape, device)
    radii = 0.86 * (1 + 0.04 * torch.randn((n, 3), generator=gen,
                                           device=device))
    wobble = 0.08 * smooth(gen, n, 1, (4, 5, 5), shape, device)[:, 0]
    q = sum((x[d][None] / radii[:, d].reshape(n, 1, 1, 1)) ** 2
            for d in range(3)) + wobble
    # cell centres uniform in a ball inside the brain
    direc = torch.randn((n, labels, 3), generator=gen, device=device)
    direc = direc / direc.norm(dim=-1, keepdim=True)
    rho = 0.75 * torch.rand((n, labels, 1), generator=gen,
                            device=device) ** (1 / 3)
    centres = direc * rho * radii[:, None, :]
    tissue = 0.2 + 0.8 * torch.rand((n, labels + 1), generator=gen,
                                    device=device)
    best = torch.full((n,) + tuple(shape), float("inf"), device=device)
    lab = torch.zeros((n,) + tuple(shape), dtype=torch.uint8, device=device)
    for k in range(labels):
        c = centres[:, k]
        dist = sum((x[d][None] - c[:, d].reshape(n, 1, 1, 1)) ** 2
                   for d in range(3))
        closer = dist < best
        lab.masked_fill_(closer, k + 1)
        torch.minimum(best, dist, out=best)
    brain = q < 0.72
    lab.masked_fill_(~brain, 0)
    t1 = torch.gather(tissue, 1, lab.reshape(n, -1).long()).reshape(lab.shape)
    t1 = torch.where(brain, t1, torch.where(q < 1.0, 0.15, 0.0))
    bias = 1 + 0.1 * smooth(gen, n, 1, (3, 3, 3), shape, device)[:, 0]
    noise = 0.01 * torch.randn(lab.shape, generator=gen, device=device)
    t1 = t1 * bias + noise
    return t1[:, None].contiguous(), lab[:, None].contiguous()


def warped(gen, img, amplitude, device):
    """``img`` (n, 1, *shape) under a smooth random displacement of about
    ``amplitude`` voxels (trilinear, border), float32."""
    n, shape = img.shape[0], tuple(img.shape[2:])
    disp = amplitude * smooth(gen, n, 3, (5, 6, 7), shape, device)
    ident = torch.stack(torch.meshgrid(
        *[torch.linspace(-1, 1, s, device=device) for s in shape],
        indexing="ij"), 0)
    scale = torch.tensor([2.0 / (s - 1) for s in shape],
                         device=device).reshape(1, 3, 1, 1, 1)
    grid = ident[None] + disp * scale
    # grid_sample reads (x, y, z) = (last, middle, first) spatial axes
    grid = torch.movedim(grid.flip(1), 1, -1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def control_points(gen, n, coarse, sigma, device):
    """(n, *coarse, 3) smooth random control points of std ~``sigma``."""
    lo = tuple(max(2, s // 8) for s in coarse)
    return sigma * torch.movedim(smooth(gen, n, 3, lo, coarse, device), 1,
                                 -1).contiguous()


CHUNK = 8   # subjects made at a time (bounds the set-up's memory)


def pairs(gen, n, shape, labels, amplitude, device):
    """``(moving, fixed)``: (n, 1, *shape) float32 pairs, made
    :data:`CHUNK` subjects at a time."""
    mov, fix = [], []
    for k in range(0, n, CHUNK):
        m = min(CHUNK, n - k)
        t1, _ = subjects(gen, m, shape, labels, device)
        fix.append(t1)
        mov.append(warped(gen, t1, amplitude, device))
    return torch.cat(mov), torch.cat(fix)
