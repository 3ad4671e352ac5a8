"""interpol_tpu_torch — PyTorch/CUDA port of interpol_tpu.

The forward dense-warp path, ported from the JAX package beside it
(``interpol_tpu/``, the reference): options and primitives (boundary
folding, B-spline taps), the plain gather and the dense-warp window tier,
the separable ``resize``, ``grid_pull`` / ``grid_grad`` with the grid
constructors, and the registration ``WarpModel`` forward.  CPU tensors run
plain PyTorch; CUDA tensors run the hand-written Hopper kernel
(``csrc/warp.cu``), built with nvcc at first use.  There is no backend
switch: the tensors' device decides.
"""
from . import options  # noqa: F401
from . import models, ops, utils  # noqa: F401
from .options import BoundType, ExtrapolateType, InterpolationType  # noqa: F401
from .ops.api import (  # noqa: F401
    grid_pull, grid_grad, identity_grid, add_identity_grid, affine_grid,
)
from .ops.resize import resize  # noqa: F401
from .models.warp import WarpModel, mse_loss, params_from_jax  # noqa: F401

__all__ = [
    "grid_pull", "grid_grad", "identity_grid", "add_identity_grid",
    "affine_grid", "resize", "WarpModel", "mse_loss", "params_from_jax",
    "BoundType", "ExtrapolateType", "InterpolationType", "options",
]
