"""LayerHelper: shared machinery for layer functions.

Reference: ``python/paddle/fluid/layer_helper.py:49,288`` — creates
parameters (with startup-program initializer ops), temp output vars, appends
ops to the current block, and applies activations/bias.
"""
from __future__ import annotations

from typing import Optional

from .core import unique_name
from .core.program import (
    OP_ROLE_ATTR,
    Variable,
    default_main_program,
    default_startup_program,
)
from .initializer import (
    ConstantInitializer,
    XavierInitializer,
)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    # -- programs ----------------------------------------------------------
    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # -- inputs ------------------------------------------------------------
    def input(self, name="input"):
        inputs = self.kwargs.get(name)
        if isinstance(inputs, (list, tuple)):
            return list(inputs)
        return inputs

    def input_dtype(self, name="input"):
        inputs = self.input(name)
        if isinstance(inputs, list):
            return inputs[0].dtype
        return inputs.dtype

    # -- vars --------------------------------------------------------------
    def create_variable_for_type_inference(self, dtype, shape=None,
                                           stop_gradient=False) -> Variable:
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            shape=shape,
            stop_gradient=stop_gradient,
        )

    create_tmp_variable = create_variable_for_type_inference

    def create_parameter(
        self,
        attr,
        shape,
        dtype,
        is_bias: bool = False,
        default_initializer=None,
    ) -> Variable:
        attr = ParamAttr.to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w" if not is_bias else "b"]))
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer()
        )
        shape = [int(s) for s in shape]
        # declare in main program (used by ops) ...
        param = self.main_program.global_block.create_parameter(
            attr.name, shape, dtype,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
        )
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        param.gradient_clip_attr = attr.gradient_clip
        # ... and in the startup program with its initializer op
        sp_block = self.startup_program.global_block
        if not sp_block.has_var(attr.name):
            sp_param = sp_block.create_parameter(
                attr.name, shape, dtype, trainable=attr.trainable
            )
            init(sp_param, sp_block)
        return param

    def create_global_variable(self, shape, dtype, persistable=False,
                               name=None, stop_gradient=True) -> Variable:
        return self.main_program.global_block.create_var(
            name=name or unique_name.generate(".".join([self.name, "global"])),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient,
        )

    def create_or_get_global_variable(self, shape, dtype, name, **kw):
        gb = self.main_program.global_block
        if gb.has_var(name):
            return gb.vars[name]
        return self.create_global_variable(shape, dtype, name=name, **kw)

    def set_variable_initializer(self, var, initializer):
        sp_block = self.startup_program.global_block
        if not sp_block.has_var(var.name):
            sv = sp_block.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype,
                persistable=True,
            )
            initializer(sv, sp_block)

    # -- ops ---------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        program = self.main_program
        attrs = dict(attrs or {})
        attrs.setdefault(OP_ROLE_ATTR, program.op_role)
        ins = {k: self._names(v) for k, v in (inputs or {}).items()}
        outs = {k: self._names(v) for k, v in (outputs or {}).items()}
        return self.block.append_op(type, ins, outs, attrs)

    @staticmethod
    def _names(v):
        if isinstance(v, (list, tuple)):
            return [x.name if isinstance(x, Variable) else str(x) for x in v]
        return [v.name if isinstance(v, Variable) else str(v)]

    # -- activation / bias -------------------------------------------------
    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(
            input_var.dtype, shape=input_var.shape
        )
        self.append_op(act_type, {"X": [input_var]}, {"Out": [out]}, act)
        return out

    def append_bias_op(self, input_var: Variable, dim_start=1, dim_end=None) -> Variable:
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, size, input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(
            input_var.dtype, shape=input_var.shape
        )
        self.append_op(
            "elementwise_add", {"X": [input_var], "Y": [b]}, {"Out": [out]},
            {"axis": dim_start},
        )
        return out
