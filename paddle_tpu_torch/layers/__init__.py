"""The layer DSL of the port: the layer functions the Transformer and
the fc/SGD drive call (``paddle_tpu/layers``, in part)."""
from . import io, learning_rate_scheduler, nn, tensor  # noqa: F401
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .tensor import (  # noqa: F401
    assign,
    fill_constant,
    increment,
    ones,
    zeros,
)
