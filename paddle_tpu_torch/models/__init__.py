"""Models of the port (``paddle_tpu/models``, in part)."""
from . import transformer  # noqa: F401
