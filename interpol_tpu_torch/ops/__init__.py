"""Operator tier: bounds/splines primitives, the plain gather, the
dense-warp window tier and its CUDA kernel, separable resize, and the
high-level API."""
from . import (  # noqa: F401
    bounds, splines, ndkernels, window, cuda_warp, separable, resize, api)
