"""Tensor creation/assignment layers: ``paddle_tpu/layers/tensor.py``,
copied unchanged."""
from __future__ import annotations

import numpy as np

from ..core.program import Variable
from ..layer_helper import LayerHelper


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """Standalone trainable parameter (reference layers/tensor.py
    create_parameter)."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(
        shape=None, dtype=dtype, persistable=persistable,
        name=name or helper.name)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        shape=shape, dtype=dtype, persistable=persistable,
        name=name or helper.name)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    out = out or helper.create_variable_for_type_inference(
        dtype, shape=tuple(shape), stop_gradient=True)
    helper.append_op(
        "fill_constant", {}, {"Out": [out]},
        {"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    shp = list(shape)
    shp[output_dim_idx] = input.shape[input_dim_idx]
    out = helper.create_variable_for_type_inference(dtype, shape=tuple(shp))
    helper.append_op(
        "fill_constant_batch_size_like", {"Input": [input]}, {"Out": [out]},
        {"shape": list(shape), "dtype": dtype, "value": float(value),
         "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx},
    )
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        output = output or helper.create_variable_for_type_inference(
            input.dtype, shape=input.shape)
        helper.append_op("assign", {"X": [input]}, {"Out": [output]})
    else:
        arr = np.asarray(input)
        output = output or helper.create_variable_for_type_inference(
            str(arr.dtype), shape=arr.shape)
        helper.append_op(
            "assign_value", {}, {"Out": [output]},
            {"shape": list(arr.shape), "dtype": output.dtype,
             "values": arr.reshape(-1).tolist()},
        )
    return output


def cast(x, dtype):
    from .nn import cast as _cast
    return _cast(x, dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    out = out or helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("fill_zeros_like", {"X": [x]}, {"Out": [out]})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype, shape=x.shape)
    helper.append_op("increment", {"X": [x]}, {"Out": [out]}, {"step": value})
    return out


def argmax(x, axis=0):
    from .nn import argmax as _argmax
    return _argmax(x, axis)


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    shp = tuple(s for i, s in enumerate(x.shape) if i != (axis % len(x.shape)))
    out = helper.create_variable_for_type_inference("int64", shape=shp)
    helper.append_op("arg_min", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


__all__ = ["argmax", "argmin", "assign", "cast", "create_global_var",
           "create_parameter", "create_tensor", "fill_constant",
           "fill_constant_batch_size_like", "increment", "ones", "zeros",
           "zeros_like"]
