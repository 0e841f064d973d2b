"""Models of the port (``paddle_tpu/models``, in part)."""
from . import deepfm, stacked_lstm, transformer  # noqa: F401
