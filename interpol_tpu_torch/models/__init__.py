"""Registration models: the dense-displacement ``WarpModel`` and the
diffeomorphic ``SVFModel``, with their losses and SGD train steps, and the
coarse-to-fine ``PyramidModel`` driver."""
from .warp import (  # noqa: F401
    WarpModel, mse_loss, params_from_jax, train_step)
from .svf import SVFModel, svf_mse_loss, svf_train_step  # noqa: F401
from .pyramid import (  # noqa: F401
    PyramidModel, image_pyramid, register, run_level)
