"""Models of the port (``paddle_tpu/models``, in part)."""
from . import deepfm, machine_translation, stacked_lstm, transformer  # noqa: F401
