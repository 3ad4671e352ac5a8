"""Registration models: the dense-displacement ``WarpModel`` and the
diffeomorphic ``SVFModel``, with their losses and SGD train steps."""
from .warp import (  # noqa: F401
    WarpModel, mse_loss, params_from_jax, train_step)
from .svf import SVFModel, svf_mse_loss, svf_train_step  # noqa: F401
