"""In-graph learning-rate schedules:
``paddle_tpu/layers/learning_rate_scheduler.py``, copied unchanged
(exponential, natural-exp, inverse-time, polynomial, noam, piecewise and
cosine decay).

Each schedule is emitted as ops over a persistable global step counter,
so the LR update runs on the device inside the same program run as the
optimizer.
"""
from __future__ import annotations

import math

from ..core.program import OP_ROLE_ATTR, OpRole, default_main_program
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import tensor

LR_COUNTER = "@LR_DECAY_COUNTER@"


def _step_counter(name, begin=0, step=1.0):
    """Create-or-return a persistable auto-incrementing counter var
    (one increment prepended per run).  Distinct names give independent
    counters — the LR schedulers share LR_COUNTER; the public
    autoincreased_step_counter defaults to its own @STEP_COUNTER@
    (reference layers/nn.py:~autoincreased_step_counter)."""
    helper = LayerHelper("global_step_counter")
    program = default_main_program()
    gb = program.global_block
    if gb.has_var(name):
        return gb.vars[name]
    counter = helper.create_global_variable(
        shape=(), dtype="float32", persistable=True, name=name)
    # the prepended increment runs before any read, so start at
    # begin-step to make the first run observe `begin`
    helper.set_variable_initializer(
        counter, ConstantInitializer(float(begin) - float(step)))
    with program.op_role_guard(OpRole.LRSched):
        gb.prepend_op("increment", {"X": [name]}, {"Out": [name]},
                      {"step": float(step), OP_ROLE_ATTR: OpRole.LRSched})
    return counter


def _decay_step_counter(begin=0):
    return _step_counter(LR_COUNTER, begin=begin, step=1.0)


def _sched_op(helper, type, ins, attrs=None, shape=()):
    out = helper.create_variable_for_type_inference("float32", shape=shape)
    helper.append_op(type, ins, {"Out": [out]}, {
        **(attrs or {}), OP_ROLE_ATTR: OpRole.LRSched})
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    helper = LayerHelper("exponential_decay")
    step = _decay_step_counter()
    div = _sched_op(helper, "scale", {"X": [step]}, {"scale": 1.0 / decay_steps})
    if staircase:
        div = _sched_op(helper, "floor", {"X": [div]})
    # decay_rate ** div  ==  exp(div * log(decay_rate))
    scaled = _sched_op(helper, "scale", {"X": [div]}, {"scale": math.log(decay_rate)})
    factor = _sched_op(helper, "exp", {"X": [scaled]})
    return _sched_op(helper, "scale", {"X": [factor]}, {"scale": float(learning_rate)})


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    helper = LayerHelper("natural_exp_decay")
    step = _decay_step_counter()
    div = _sched_op(helper, "scale", {"X": [step]}, {"scale": 1.0 / decay_steps})
    if staircase:
        div = _sched_op(helper, "floor", {"X": [div]})
    scaled = _sched_op(helper, "scale", {"X": [div]}, {"scale": -decay_rate})
    factor = _sched_op(helper, "exp", {"X": [scaled]})
    return _sched_op(helper, "scale", {"X": [factor]}, {"scale": float(learning_rate)})


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    helper = LayerHelper("inverse_time_decay")
    step = _decay_step_counter()
    div = _sched_op(helper, "scale", {"X": [step]}, {"scale": 1.0 / decay_steps})
    if staircase:
        div = _sched_op(helper, "floor", {"X": [div]})
    denom = _sched_op(helper, "scale", {"X": [div]},
                      {"scale": decay_rate, "bias": 1.0, "bias_after_scale": True})
    inv = _sched_op(helper, "reciprocal", {"X": [denom]})
    return _sched_op(helper, "scale", {"X": [inv]}, {"scale": float(learning_rate)})


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    helper = LayerHelper("polynomial_decay")
    step = _decay_step_counter()
    capped = _sched_op(helper, "clip", {"X": [step]},
                       {"min": 0.0, "max": float(decay_steps)})
    frac = _sched_op(helper, "scale", {"X": [capped]}, {"scale": 1.0 / decay_steps})
    one_minus = _sched_op(helper, "scale", {"X": [frac]},
                          {"scale": -1.0, "bias": 1.0})
    powed = _sched_op(helper, "pow", {"X": [one_minus]}, {"factor": power})
    return _sched_op(
        helper, "scale", {"X": [powed]},
        {"scale": float(learning_rate - end_learning_rate),
         "bias": float(end_learning_rate)})


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (transformer schedule; reference learning_rate_scheduler.py:44)."""
    helper = LayerHelper("noam_decay")
    step = _decay_step_counter(begin=1)
    a = _sched_op(helper, "pow", {"X": [step]}, {"factor": -0.5})
    b = _sched_op(helper, "scale", {"X": [step]},
                  {"scale": warmup_steps ** -1.5})
    m = _sched_op(helper, "elementwise_min", {"X": [a], "Y": [b]})
    return _sched_op(helper, "scale", {"X": [m]}, {"scale": d_model ** -0.5})


def piecewise_decay(boundaries, values):
    """Step-function LR via nested where ops."""
    assert len(values) == len(boundaries) + 1
    helper = LayerHelper("piecewise_decay")
    step = _decay_step_counter()
    lr = tensor.fill_constant((), "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        boundary = tensor.fill_constant((), "float32", float(b))
        cond = _sched_op(helper, "less_than", {"X": [step], "Y": [boundary]})
        val = tensor.fill_constant((), "float32", float(v))
        lr = _sched_op(helper, "where", {"Condition": [cond], "X": [val], "Y": [lr]})
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    helper = LayerHelper("cosine_decay")
    step = _decay_step_counter()
    epoch = _sched_op(helper, "scale", {"X": [step]}, {"scale": 1.0 / step_each_epoch})
    epoch = _sched_op(helper, "floor", {"X": [epoch]})
    inner = _sched_op(helper, "scale", {"X": [epoch]}, {"scale": math.pi / epochs})
    cosv = _sched_op(helper, "cos", {"X": [inner]})
    return _sched_op(
        helper, "scale", {"X": [cosv]},
        {"scale": learning_rate * 0.5, "bias": learning_rate * 0.5})


__all__ = ["cosine_decay", "exponential_decay", "inverse_time_decay",
           "natural_exp_decay", "noam_decay", "piecewise_decay",
           "polynomial_decay"]
