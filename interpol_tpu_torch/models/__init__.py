"""Flagship workloads (the registration warp model's forward path)."""
from .warp import WarpModel, mse_loss, params_from_jax  # noqa: F401
