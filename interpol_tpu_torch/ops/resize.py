"""Resize (scipy-zoom-like) and restrict (its adjoint).

PyTorch port of ``interpol_tpu/ops/resize.py:42-191``, with the four anchor
modes (centers, edges, first, last) and the same defaults
(``bound='nearest'``, ``extrapolate=True``; ``restrict`` divides by the
accumulated scale unless ``reduce_sum=True``).  A float image takes the
separable route: the sampling grid is an outer product of per-axis lines,
so the resample is D matmuls (``ops/separable.py``), after the
interpolating prefilter (``prefilter=True``, the default of ``resize``, as
in the JAX package; ``bound='nearest'`` aliases to dct2 there) or, for
``restrict(..., prefilter=True)``, before it.  An integer label map takes
the generic route on the meshgrid of those lines, as in the JAX package:
``resize`` pulls it class by class (``grid_pull``'s label path) and
``restrict`` splats it as floats (``grid_push``).
"""
from __future__ import annotations

import torch

from ..options import normalize_options
from ..utils.shapes import make_list
from .api import grid_pull, grid_push
from .coeff import spline_coeff_nd
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
    prefilter : apply the interpolating prefilter (default True)
    kwargs : ``bound`` (default 'nearest'), ``extrapolate`` (default True);
        for a label map, forwarded to ``grid_pull`` (``classes=`` ...)
    """
    image = torch.as_tensor(image)
    ndim, anchors = _ndim_anchors(image, factor, shape, anchor)
    inshape = image.shape[-ndim:]
    factor, shape = _resolve_geometry(inshape, factor, shape, ndim)

    fdtype = image.dtype if torch.is_floating_point(image) \
        else torch.float32
    kw = dict(dtype=fdtype, device=image.device)
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

    kwargs.setdefault("bound", "nearest")
    kwargs.setdefault("extrapolate", True)
    kwargs.setdefault("interpolation", interpolation)
    kwargs.setdefault("prefilter", prefilter)
    if not torch.is_floating_point(image):
        grid = torch.stack(torch.meshgrid(*lines, indexing="ij"), -1)
        return grid_pull(image, grid, **kwargs)
    orders, bounds, ex = normalize_options(
        kwargs["interpolation"], kwargs["bound"], kwargs["extrapolate"],
        ndim)
    if kwargs["prefilter"]:
        image = spline_coeff_nd(image, orders, bounds, ndim)
    return separable_pull(image, lines, orders, bounds, ex)


def restrict(image, factor=None, shape=None, anchor="c",
             interpolation=1, reduce_sum=False, **kwargs):
    """Restrict (the adjoint of resize) an image by a factor or to a
    target shape.

    The sampling grid lives in the *output* space; the image is splatted
    by the transposed separable sampling matrices and divided by the
    accumulated scale unless ``reduce_sum``.  Arguments as :func:`resize`
    (``prefilter`` defaults to False; True prefilters the splat).  A label
    map is splatted as floats and the result is float.
    """
    image = torch.as_tensor(image)
    ndim, anchors = _ndim_anchors(image, factor, shape, anchor)
    inshape = image.shape[-ndim:]
    factor, shape = _resolve_geometry(inshape, factor, shape, ndim,
                                      for_restrict=True)

    fdtype = image.dtype if torch.is_floating_point(image) \
        else torch.float32
    kw = dict(dtype=fdtype, device=image.device)
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
    if torch.is_floating_point(image):
        orders, bounds, ex = normalize_options(
            kwargs["interpolation"], kwargs["bound"], kwargs["extrapolate"],
            ndim)
        out = separable_push(image, lines, tuple(shape), orders, bounds, ex)
        if kwargs["prefilter"]:
            out = spline_coeff_nd(out, orders, bounds, ndim)
    else:
        grid = torch.stack(torch.meshgrid(*lines, indexing="ij"), -1)
        out = grid_push(image, grid, shape, **kwargs)
    if not reduce_sum:
        out = out / fullscale
    return out
