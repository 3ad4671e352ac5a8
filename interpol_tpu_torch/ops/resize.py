"""Resize (scipy-zoom-like) and restrict (its adjoint) on the separable
route.

PyTorch port of ``interpol_tpu/ops/resize.py:42-191``, with the four anchor
modes (centers, edges, first, last) and the same defaults
(``bound='nearest'``, ``extrapolate=True``; ``restrict`` divides by the
accumulated scale unless ``reduce_sum=True``).  Only the separable route
is ported: the sampling grid is an outer product of per-axis lines, so the
resample is D matmuls (``ops/separable.py``).  ``prefilter=True`` (the
default of ``resize``, as in the JAX package) raises until
``ops/coeff.py`` is ported; integer label maps raise until the label path
is ported.
"""
from __future__ import annotations

import torch

from ..options import normalize_options
from ..utils.shapes import make_list
from .separable import separable_pull, separable_push

__all__ = ["resize", "restrict"]


def _resolve_geometry(inshape, factor, shape, ndim, for_restrict=False):
    """factor/shape resolution (the JAX package's ``_resolve_geometry``)."""
    factor = make_list(factor) if factor else []
    shape = make_list(shape) if shape else []
    if factor:
        factor = make_list(factor, ndim)
    elif not shape:
        raise ValueError("One of `factor` or `shape` must be provided")
    if shape:
        shape = make_list(shape, ndim)
    elif for_restrict:
        shape = [int(i / f) for i, f in zip(inshape, factor)]
    else:
        shape = [int(i * f) for i, f in zip(inshape, factor)]
    if not factor:
        if for_restrict:
            factor = [i / o for i, o in zip(inshape, shape)]
        else:
            factor = [o / i for o, i in zip(shape, inshape)]
    return factor, shape


def _ndim_anchors(image, factor, shape, anchor):
    anchor_list = make_list(anchor)
    ndim = max(len(make_list(factor) if factor else []),
               len(make_list(shape) if shape else []),
               len(anchor_list)) or (image.ndim - 2)
    return ndim, [a[0].lower() for a in make_list(anchor_list, ndim)]


def _check_ported(image, prefilter, name):
    if prefilter:
        raise NotImplementedError(
            f"{name}(prefilter=True) needs the spline prefilter "
            f"(ops/coeff.py), which is not ported yet (ROADMAP queue 1, "
            f"Prefilter)")
    if not torch.is_floating_point(image):
        raise NotImplementedError(
            f"{name} of label maps is not ported yet (ROADMAP queue 1, "
            f"Label maps)")


def resize(image, factor=None, shape=None, anchor="c",
           interpolation=1, prefilter=True, **kwargs):
    """Resize an image by a factor or to a target shape.

    Parameters
    ----------
    image : (batch, channel, *inshape) tensor
    factor : float or per-dim list — >1 upsamples.  A scalar resizes only
        the last spatial dim (``ndim = max(len(factor), len(shape),
        len(anchor))``); pass a list to resize all dims.
    shape : target spatial shape
    anchor : {'centers','edges','first','last'} or per-dim list
    interpolation : spline order(s), default=1
    prefilter : must be False until the prefilter is ported
    kwargs : ``bound`` (default 'nearest'), ``extrapolate`` (default True)
    """
    image = torch.as_tensor(image)
    ndim, anchors = _ndim_anchors(image, factor, shape, anchor)
    inshape = image.shape[-ndim:]
    factor, shape = _resolve_geometry(inshape, factor, shape, ndim)

    kwargs.setdefault("bound", "nearest")
    kwargs.setdefault("extrapolate", True)
    kwargs.setdefault("interpolation", interpolation)
    kwargs.setdefault("prefilter", prefilter)
    _check_ported(image, kwargs["prefilter"], "resize")

    kw = dict(dtype=image.dtype, device=image.device)
    lines = []
    for anch, f, insz, outsz in zip(anchors, factor, inshape, shape):
        if anch == "c":      # centers: endpoints map to endpoints
            lines.append(torch.linspace(0, insz - 1, outsz, **kw))
        elif anch == "e":    # edges: voxel-edge-aligned affine map
            scale = insz / outsz
            shift = 0.5 * (scale - 1)
            lines.append(torch.arange(outsz, **kw) * scale + shift)
        elif anch == "f":    # first voxel anchored, voxel size = 1/f
            lines.append(torch.arange(outsz, **kw) / f)
        elif anch == "l":    # last voxel anchored
            shift = (insz - 1) - (outsz - 1) / f
            lines.append(torch.arange(outsz, **kw) / f + shift)
        else:
            raise ValueError(f"Unknown anchor {anch}")

    orders, bounds, ex = normalize_options(
        kwargs["interpolation"], kwargs["bound"], kwargs["extrapolate"],
        ndim)
    return separable_pull(image, lines, orders, bounds, ex)


def restrict(image, factor=None, shape=None, anchor="c",
             interpolation=1, reduce_sum=False, **kwargs):
    """Restrict (the adjoint of resize) an image by a factor or to a
    target shape.

    The sampling grid lives in the *output* space; the image is splatted
    by the transposed separable sampling matrices and divided by the
    accumulated scale unless ``reduce_sum``.  Arguments as :func:`resize`
    (``prefilter`` defaults to False and must stay so until the
    prefilter is ported).
    """
    image = torch.as_tensor(image)
    ndim, anchors = _ndim_anchors(image, factor, shape, anchor)
    inshape = image.shape[-ndim:]
    factor, shape = _resolve_geometry(inshape, factor, shape, ndim,
                                      for_restrict=True)

    kw = dict(dtype=image.dtype, device=image.device)
    lines = []
    fullscale = 1.0
    for anch, f, insz, outsz in zip(anchors, factor, inshape, shape):
        if anch == "c":
            lines.append(torch.linspace(0, outsz - 1, insz, **kw))
            fullscale *= (insz - 1) / (outsz - 1)
        elif anch == "e":
            scale = outsz / insz
            shift = 0.5 * (scale - 1)
            fullscale *= scale
            lines.append(torch.arange(insz, **kw) * scale + shift)
        elif anch == "f":
            fullscale *= 1 / f
            lines.append(torch.arange(insz, **kw) / f)
        elif anch == "l":
            shift = (outsz - 1) - (insz - 1) / f
            fullscale *= 1 / f
            lines.append(torch.arange(insz, **kw) / f + shift)
        else:
            raise ValueError(f"Unknown anchor {anch}")

    kwargs.setdefault("bound", "nearest")
    kwargs.setdefault("extrapolate", True)
    kwargs.setdefault("interpolation", interpolation)
    kwargs.setdefault("prefilter", False)
    _check_ported(image, kwargs["prefilter"], "restrict")
    orders, bounds, ex = normalize_options(
        kwargs["interpolation"], kwargs["bound"], kwargs["extrapolate"],
        ndim)
    out = separable_push(image, lines, tuple(shape), orders, bounds, ex)
    if not reduce_sum:
        out = out / fullscale
    return out
