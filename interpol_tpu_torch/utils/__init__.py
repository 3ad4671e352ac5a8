from . import shapes  # noqa: F401
