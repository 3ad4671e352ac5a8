"""Multi-device layer of the PyTorch port: batch data parallelism (no
collective), slab-sharded spatial ops with a ring halo exchange, point-
sharded scattered sampling (on replicated or slab-sharded volumes) and the
sharded prefilter, on ``torch.distributed`` with a ``DeviceMesh`` and
``DTensor``s (gloo for CPU tensors, NCCL for CUDA tensors)."""
from . import batch, coeff, points, spatial  # noqa: F401
from .batch import pull_dp, push_dp, count_dp, grad_dp  # noqa: F401
from .coeff import spline_coeff_nd_sharded  # noqa: F401
from .spatial import (  # noqa: F401
    halo_width, pull_sharded, push_sharded, count_sharded, grad_sharded)
from .points import (  # noqa: F401
    pull_points, grad_points, push_points, count_points, pull_points_slab,
    grad_points_slab, push_points_slab)
