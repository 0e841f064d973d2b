"""In-graph learning-rate schedules: the noam schedule of
``paddle_tpu/layers/learning_rate_scheduler.py``, copied unchanged.

Each schedule is emitted as ops over a persistable global step counter,
so the LR update runs on the device inside the same program run as the
optimizer.
"""
from __future__ import annotations

from ..core.program import OP_ROLE_ATTR, OpRole, default_main_program
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

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


__all__ = ["noam_decay"]
