"""Operator tier: bounds/splines primitives, the plain gather, the
dense-warp window tier with its adjoints and CUDA kernels, separable
resize, the high-level API and the deformation-field algebra."""
from . import (  # noqa: F401
    bounds, splines, ndkernels, window, cuda_warp, separable, resize, api,
    flow)
