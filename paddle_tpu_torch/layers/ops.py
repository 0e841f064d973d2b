"""The unary layer wrappers (reference:
layers/layer_function_generator.py + layers/ops.py — python wrappers emitted
from OpProto; here generated from the lowering registry):
``paddle_tpu/layers/ops.py``, copied unchanged."""
from __future__ import annotations

import sys

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round",
    "reciprocal", "square", "softplus", "softsign", "relu", "relu6",
    "elu", "gelu", "leaky_relu", "soft_relu", "brelu", "pow", "stanh",
    "hard_sigmoid", "swish", "hard_shrink", "thresholded_relu", "log",
    "sign",
]

_mod = sys.modules[__name__]


def _make(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
        helper.append_op(op_type, {"X": [x]}, {"Out": [out]}, attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"{op_type} activation (activation_op.cc functor)."
    return layer


for _op in _UNARY_OPS:
    from ..core import registry as _registry
    if _registry.has(_op):
        setattr(_mod, _op, _make(_op))

__all__ = [op for op in _UNARY_OPS if hasattr(_mod, op)]
