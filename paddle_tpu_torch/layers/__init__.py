"""The layer DSL of the port: the layer functions the models, the
decoders, the training rewrites and the fc/SGD drive call
(``paddle_tpu/layers``, in part; ``detection`` is not ported)."""
from . import control_flow, io, learning_rate_scheduler, nn, ops, tensor  # noqa: F401
from .control_flow import (  # noqa: F401
    ConditionalBlock,
    DynamicRNN,
    IfElse,
    RankTable,
    StaticRNN,
    Switch,
    While,
    array_length,
    array_read,
    array_to_lod_tensor,
    array_write,
    beam_search,
    beam_search_decode,
    create_array,
    less_than,
    lod_rank_table,
    lod_tensor_to_array,
    max_sequence_len,
    merge_lod_tensor,
    reorder_lod_tensor_by_rank,
    shrink_memory,
    split_lod_tensor,
)
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
from . import nn_extras  # noqa: F401
from .nn_extras import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import (  # noqa: F401
    argmin,
    assign,
    create_global_var,
    create_parameter,
    create_tensor,
    fill_constant,
    fill_constant_batch_size_like,
    increment,
    ones,
    zeros,
    zeros_like,
)
