"""The layer DSL of the port: the layer functions the models, the
decoders and the fc/SGD drive call (``paddle_tpu/layers``, in part)."""
from . import control_flow, io, learning_rate_scheduler, nn, tensor  # noqa: F401
from .control_flow import (  # noqa: F401
    StaticRNN,
    While,
    array_length,
    array_read,
    array_write,
    beam_search,
    beam_search_decode,
    create_array,
    less_than,
)
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from .tensor import (  # noqa: F401
    assign,
    fill_constant,
    fill_constant_batch_size_like,
    increment,
    ones,
    zeros,
)
