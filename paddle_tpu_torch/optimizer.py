"""Optimizers: append_backward + per-parameter optimizer ops.

The ``Optimizer`` base, ``SGD``, ``Momentum``, ``Adagrad`` and ``Adam``
of ``paddle_tpu/optimizer.py``, copied unchanged: ``minimize`` =
append_backward → gradient clip → regularization → one optimizer op per
parameter plus accumulator vars and LR ops (their rules are in
``ops/optimizer_ops.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .core import unique_name
from .core.backward import append_backward
from .core.program import (
    OP_ROLE_ATTR,
    OP_ROLE_VAR_ATTR,
    OpRole,
    Variable,
    default_main_program,
    default_startup_program,
)
from .clip import append_gradient_clip_ops, error_clip_callback
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map: Dict = {}
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self.helper: Optional[LayerHelper] = None
        self.type = getattr(self, "type", "sgd")

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program._uid] = self._learning_rate
            return
        if program._uid in self._learning_rate_map:
            return
        helper = LayerHelper("learning_rate")
        lr = helper.create_global_variable(
            shape=(), dtype="float32", persistable=True,
            name=unique_name.generate("learning_rate"))
        helper.set_variable_initializer(
            lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[program._uid] = lr

    def _global_learning_rate(self):
        return self._learning_rate_map[default_main_program()._uid]

    def _create_param_lr(self, param: Variable):
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        lr = self._global_learning_rate()
        if mult == 1.0:
            return lr
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference("float32", shape=())
        helper.append_op("scale", {"X": [lr]}, {"Out": [out]},
                         {"scale": float(mult), OP_ROLE_ATTR: OpRole.Optimize})
        return out

    # -- accumulators (reference optimizer.py:148-200) ---------------------
    def _add_accumulator(self, name, param, dtype="float32", fill_value=0.0,
                         shape=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            shape=shape if shape is not None else param.shape,
            dtype=dtype, persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks -------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- minimize (reference minimize:245) ---------------------------------
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def apply_gradients(self, params_grads):
        program = default_main_program()
        block = program.global_block
        with program.op_role_guard(OpRole.Optimize):
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads, self.regularization)
            self._create_global_learning_rate()
            self._create_accumulators(block, [pg[0] for pg in params_grads])
            optimize_ops = []
            for param_and_grad in params_grads:
                if param_and_grad[1] is None or not param_and_grad[0].trainable:
                    continue
                with program.op_role_guard(
                        OpRole.Optimize,
                        [param_and_grad[0].name, param_and_grad[1].name]):
                    op = self._append_optimize_op(block, param_and_grad)
                    optimize_ops.append(op)
            self._finish_update(block, params_grads)
        return optimize_ops

    def _opt_op(self, block, type, inputs, outputs, attrs=None):
        program = block.program
        a = dict(attrs or {})
        a[OP_ROLE_ATTR] = OpRole.Optimize
        a[OP_ROLE_VAR_ATTR] = program.op_role_vars
        ins = {k: [v.name if isinstance(v, Variable) else v for v in vs]
               for k, vs in inputs.items()}
        outs = {k: [v.name if isinstance(v, Variable) else v for v in vs]
                for k, vs in outputs.items()}
        return block.append_op(type, ins, outs, a)


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return self._opt_op(
            block, "sgd",
            {"Param": [p], "Grad": [g], "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p]},
        )


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return self._opt_op(
            block, "momentum",
            {"Param": [p], "Grad": [g], "Velocity": [v],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p], "VelocityOut": [v]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return self._opt_op(
            block, "adagrad",
            {"Param": [p], "Grad": [g], "Moment": [m],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p], "MomentOut": [m]},
            {"epsilon": self._epsilon},
        )


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=())
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=())

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return self._opt_op(
            block, "adam",
            {"Param": [p], "Grad": [g],
             "Moment1": [self._get_accumulator("moment1", p)],
             "Moment2": [self._get_accumulator("moment2", p)],
             "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
             "Beta2Pow": [self._get_accumulator("beta2_pow_acc", p)],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p],
             "Moment1Out": [self._get_accumulator("moment1", p)],
             "Moment2Out": [self._get_accumulator("moment2", p)],
             "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p)],
             "Beta2PowOut": [self._get_accumulator("beta2_pow_acc", p)]},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )


# reference-compatible aliases (optimizer.py tail)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer

__all__ = ["Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer",
           "Momentum", "MomentumOptimizer", "Optimizer", "SGD",
           "SGDOptimizer"]
