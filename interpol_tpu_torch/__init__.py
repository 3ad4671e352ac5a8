"""interpol_tpu_torch — PyTorch/CUDA port of interpol_tpu.

Ported from the JAX package beside it (``interpol_tpu/``, the reference):
options and primitives (boundary folding, B-spline taps), the
interpolating prefilter (``spline_coeff``, ``spline_coeff_nd`` and
``prefilter=True`` everywhere), label maps (``classes=`` or an integer
input to ``grid_pull``, ``resize`` and ``restrict``), the plain
gather and scatter cores, the dense-warp window tier (with its adaptive
per-tile windows: ``tile_spread``, ``check_spread``,
``required_tile_spread``) and the generic push/pull tier with their
hand-wired adjoints (``torch.autograd.Function``s, differentiable to
second order and beyond), the separable ``resize`` and ``restrict``,
``grid_pull`` / ``grid_push`` / ``grid_count`` / ``grid_grad`` on any grid
with the grid constructors, the deformation-field algebra
(``ops/flow.py``), and the registration models ``WarpModel`` and
``SVFModel`` with their train steps and the coarse-to-fine
``PyramidModel`` (``register``, ``run_level``, ``image_pyramid``).  CPU
tensors run plain PyTorch; CUDA tensors run the hand-written Hopper
kernels (``csrc/warp.cu``, ``csrc/push.cu``, ``csrc/gather.cu``,
``csrc/splat.cu``), built with nvcc at first use.  There is no backend
switch: the tensors' device decides, and the models live on the card
unless the caller asks for the CPU.
"""
from . import options  # noqa: F401
from . import models, ops, utils  # noqa: F401
from .options import BoundType, ExtrapolateType, InterpolationType  # noqa: F401
from .ops.api import (  # noqa: F401
    grid_pull, grid_push, grid_count, grid_grad, pull, push, count,
    spline_coeff, spline_coeff_nd, identity_grid, add_identity_grid,
    add_identity_grid_, affine_grid, required_tile_spread,
)
from .ops.flow import (  # noqa: F401
    compose_disp, exp_disp, disp_jacobian, jacobian_det, invert_disp,
)
from .ops.resize import resize, restrict  # noqa: F401
from .models.warp import (  # noqa: F401
    WarpModel, mse_loss, params_from_jax, train_step,
)
from .models.svf import SVFModel, svf_mse_loss, svf_train_step  # noqa: F401
from .models.pyramid import (  # noqa: F401
    PyramidModel, image_pyramid, register, run_level,
)

__all__ = [
    "grid_pull", "grid_push", "grid_count", "grid_grad", "pull", "push",
    "count", "spline_coeff", "spline_coeff_nd", "identity_grid",
    "add_identity_grid", "add_identity_grid_", "affine_grid",
    "compose_disp", "exp_disp", "disp_jacobian", "jacobian_det",
    "invert_disp", "resize", "restrict", "required_tile_spread",
    "WarpModel", "mse_loss", "params_from_jax", "train_step", "SVFModel",
    "svf_mse_loss", "svf_train_step", "PyramidModel", "image_pyramid",
    "register", "run_level",
    "BoundType", "ExtrapolateType", "InterpolationType", "options",
]
