"""Operator tier: bounds/splines primitives, the plain gather and scatter
cores, the dense-warp window tier and the generic push/pull tier with
their adjoints and CUDA kernels, the interpolating prefilter, separable
resize, the high-level API and the deformation-field algebra."""
from . import (  # noqa: F401
    bounds, splines, ndkernels, tiles, window, cuda_warp, scattered,
    pushpull, cuda_scattered, separable, coeff, resize, api, flow)
