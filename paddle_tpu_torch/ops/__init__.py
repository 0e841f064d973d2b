"""Op rules of the port, registered on import (one module per family,
as in the JAX package)."""
from . import (  # noqa: F401
    array_ops,
    attention_ops,
    control_flow_ops,
    ctc_crf_ops,
    math_ops,
    misc_ops,
    nn_ops,
    optimizer_ops,
    quant_ops,
    sequence_ops,
    tensor_ops,
)
