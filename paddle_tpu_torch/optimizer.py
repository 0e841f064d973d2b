"""Optimizers: append_backward + per-parameter optimizer ops.

``paddle_tpu/optimizer.py``, copied unchanged: ``minimize`` =
append_backward → gradient clip → regularization → one optimizer op per
parameter plus accumulator vars and LR ops (their rules are in
``ops/optimizer_ops.py``); every optimizer of the reference, their
aliases, and ``ModelAverage`` (``apply``/``restore`` run two small
programs of ``assign`` ops).
"""
from __future__ import annotations

from contextlib import contextmanager
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


class LarsMomentumOptimizer(MomentumOptimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=1e-3,
                 lars_weight_decay=5e-4, **kw):
        super().__init__(learning_rate, momentum, **kw)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return self._opt_op(
            block, "lars_momentum",
            {"Param": [p], "Grad": [g], "Velocity": [v],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p], "VelocityOut": [v]},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay},
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


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=())

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return self._opt_op(
            block, "adamax",
            {"Param": [p], "Grad": [g],
             "Moment": [self._get_accumulator("moment", p)],
             "InfNorm": [self._get_accumulator("inf_norm", p)],
             "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p],
             "MomentOut": [self._get_accumulator("moment", p)],
             "InfNormOut": [self._get_accumulator("inf_norm", p)],
             "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p)]},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return self._opt_op(
            block, "decayed_adagrad",
            {"Param": [p], "Grad": [g], "Moment": [m],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p], "MomentOut": [m]},
            {"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return self._opt_op(
            block, "adadelta",
            {"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
             "AvgSquaredUpdate": [asu],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p], "AvgSquaredGradOut": [asg],
             "AvgSquaredUpdateOut": [asu]},
            {"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        ins = {"Param": [p], "Grad": [g], "Moment": [mom], "MeanSquare": [ms],
               "LearningRate": [self._create_param_lr(p)]}
        outs = {"ParamOut": [p], "MomentOut": [mom], "MeanSquareOut": [ms]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            ins["MeanGrad"] = [mg]
            outs["MeanGradOut"] = [mg]
        return self._opt_op(
            block, "rmsprop", ins, outs,
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered},
        )


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return self._opt_op(
            block, "ftrl",
            {"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
             "LinearAccumulator": [lin],
             "LearningRate": [self._create_param_lr(p)]},
            {"ParamOut": [p], "SquaredAccumOut": [sq], "LinearAccumOut": [lin]},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


# reference-compatible aliases (optimizer.py tail)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (reference optimizer.py
    ModelAverage + average_accumulates_op.h).

    Appends an ``average_accumulates`` op per trainable parameter to the
    current main program; ``apply()`` swaps the averaged values in (with
    backup), ``restore()`` swaps them back::

        opt.minimize(loss)
        model_average = fluid.optimizer.ModelAverage(0.15)
        ...train...
        with model_average.apply(exe):
            evaluate()
    """

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization=regularization, name=name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        program = default_main_program()
        block = program.global_block
        self.params_grads = [
            (p, p) for p in block.all_parameters() if p.trainable]
        with program.op_role_guard(OpRole.Optimize):
            for param, _ in self.params_grads:
                self._append_average_accumulate_op(block, param)
        self._build_apply_restore()

    def _append_average_accumulate_op(self, block, param):
        sum_1 = self._add_accumulator("sum_1", param)
        sum_2 = self._add_accumulator("sum_2", param)
        sum_3 = self._add_accumulator("sum_3", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        dtype="int64", shape=[1])
        old_acc = self._add_accumulator("old_num_accumulates", param,
                                        dtype="int64", shape=[1])
        num_upd = self._add_accumulator("num_updates", param,
                                        dtype="int64", shape=[1])
        self._opt_op(
            block, "average_accumulates",
            {"param": [param], "in_sum_1": [sum_1], "in_sum_2": [sum_2],
             "in_sum_3": [sum_3], "in_num_accumulates": [num_acc],
             "in_old_num_accumulates": [old_acc],
             "in_num_updates": [num_upd]},
            {"out_sum_1": [sum_1], "out_sum_2": [sum_2],
             "out_sum_3": [sum_3], "out_num_accumulates": [num_acc],
             "out_old_num_accumulates": [old_acc],
             "out_num_updates": [num_upd]},
            {"average_window": self.average_window,
             "min_average_window": self.min_average_window,
             "max_average_window": self.max_average_window})

    def _build_apply_restore(self):
        from . import layers
        from .core.program import Program, program_guard

        def mirror(block, var):
            return block.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype,
                persistable=True)

        self.apply_program = Program()
        self.restore_program = Program()
        with program_guard(self.apply_program, Program()):
            block = self.apply_program.global_block
            for param, _ in self.params_grads:
                p = mirror(block, param)
                backup = block.create_var(
                    name=param.name + "@BACKUP", shape=param.shape,
                    dtype=param.dtype, persistable=True)
                block.append_op("assign", {"X": [p.name]},
                                {"Out": [backup.name]}, {})
                accs = [mirror(block, self._get_accumulator(n, param))
                        for n in ("sum_1", "sum_2", "sum_3")]
                total = layers.sums([
                    mirror(block,
                           self._get_accumulator("num_accumulates", param)),
                    mirror(block, self._get_accumulator(
                        "old_num_accumulates", param))])
                cnt = layers.cast(total, param.dtype)
                ssum = layers.sums(accs)
                avg = layers.elementwise_div(
                    ssum, layers.elementwise_max(
                        cnt, layers.fill_constant([1], param.dtype, 1.0)))
                block.append_op("assign", {"X": [avg.name]},
                                {"Out": [p.name]}, {})
        with program_guard(self.restore_program, Program()):
            block = self.restore_program.global_block
            for param, _ in self.params_grads:
                p = mirror(block, param)
                backup = block.create_var(
                    name=param.name + "@BACKUP", shape=param.shape,
                    dtype=param.dtype, persistable=True)
                block.append_op("assign", {"X": [backup.name]},
                                {"Out": [p.name]}, {})

    @contextmanager
    def apply(self, executor, need_restore=True):
        executor.run(self.apply_program)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        executor.run(self.restore_program)


__all__ = ["Adadelta", "AdadeltaOptimizer", "Adagrad", "AdagradOptimizer",
           "Adam", "AdamOptimizer", "Adamax", "AdamaxOptimizer",
           "DecayedAdagrad", "DecayedAdagradOptimizer", "Ftrl",
           "FtrlOptimizer", "LarsMomentum", "LarsMomentumOptimizer",
           "ModelAverage", "Momentum", "MomentumOptimizer", "Optimizer",
           "RMSProp", "RMSPropOptimizer", "SGD", "SGDOptimizer"]
