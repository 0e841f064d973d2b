"""Control-flow op rules: ``static_rnn`` (and ``dynamic_rnn``, its
length-masked form) and ``while`` over a sub-block.

The port of ``paddle_tpu/ops/control_flow_ops.py``.  The reference
lowers a sub-block to ``lax.scan`` and differentiates the scan with
``jax.vjp``.  The port has no trace: it runs the sub-block step by step
through its ops' rules (``core/lowering.py: run_block``), in an
environment that keeps autograd's graph, so the steps chain into one
graph.  The gradient follows the interpreter's tape design: the
executor runs ``static_rnn`` under autograd on leaf copies of the float
``X``, ``Init`` and ``Captured`` inputs its grad op asks for, and
``static_rnn_grad`` calls ``torch.autograd.grad`` on that tape; nothing
is run twice.

The handlers see program variables by name, as the reference's do:
``CONTROL_FLOW_OPS[type](program, op, env)`` returns the op's rule
``(ctx, ins, attrs) -> outs`` over its slot values, and the rule may
write names outside the op's output slots into ``env`` (a memory's
final value, ``<mem>@LAST``).

``while`` runs in its inference form (the reference's
``lax.while_loop``): the sub-block runs through ``run_block`` until the
condition var is false, with ``max_iters``, when set, a hard cap.  The
condition is read on the host once an iteration, one device sync a
step.  Its training form (``max_iters`` under a training context: the
reference's masked scan, with ``while_grad``) and ``conditional_block``
are registered, so that ``append_backward`` builds their grad ops as the
reference does, but running either raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.registry import register, register_grad


def _never(ctx, ins, attrs):  # pragma: no cover
    raise RuntimeError("control-flow ops run through CONTROL_FLOW_OPS")


# registry entries let append_backward build grad op descs generically
register("static_rnn", no_grad_slots=())(_never)
register("dynamic_rnn", no_grad_slots=("SeqLen",))(_never)
register("while", no_grad_slots=("Condition", "Init"))(_never)
register("conditional_block", no_grad_slots=("Condition", "Init"))(_never)


@register_grad("while")
def _while_grad(ctx, ins, attrs):
    raise NotImplementedError(
        "while_grad (the reference's vjp over its masked scan) is not "
        "ported yet (ROADMAP queue 1 item 4)")


def _mask_to(active, new, old):
    """``new`` on the rows where ``active`` [B] holds, else ``old``."""
    m = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
    return torch.where(m, new, old)


def lower_static_rnn(program, op, env: Dict):
    """static_rnn (recurrent_op.cc:222; the reference's
    ``lower_static_rnn``).  attrs: sub_block, step_inputs (outer
    [B, T, ...] names, the X slot), step_input_vars (inner per-step
    names), memories [[inner mem, init, updated inner]], step_outputs
    [[inner, outer]].  Step t binds each step input to ``x[:, t]`` and
    each memory to its carry, runs the sub-block, and carries the
    updated memories on.  With a SeqLen input (dynamic_rnn) a row past
    its length keeps its carry and outputs zeros.  Outputs are
    ``[B, T, ...]``; each memory's final carry goes to ``<mem>@LAST``."""
    from ..core.lowering import run_block

    sub = program.blocks[op.attr("sub_block")]
    step_in_inner = op.attr("step_input_vars")
    memories = op.attr("memories")
    step_outputs = op.attr("step_outputs")
    captured = op.input("Captured")

    def rule(ctx, ins, attrs):
        xs = ins.get("X", [])
        seq_len = ins["SeqLen"][0].reshape(-1) if ins.get("SeqLen") else None
        T = xs[0].shape[1] if xs else int(op.attr("max_len", 0))
        outer = dict(zip(captured, ins.get("Captured", [])))
        carry = list(ins.get("Init", []))
        stacked = [[] for _ in step_outputs]
        for t in range(T):
            benv = dict(outer)
            benv.update((mem, c) for (mem, _, _), c in zip(memories, carry))
            benv.update((name, x[:, t]) for name, x in zip(step_in_inner, xs))
            run_block(ctx, program, sub, benv)
            new = [benv[upd] for _, _, upd in memories]
            outs = [benv[inner] for inner, _ in step_outputs]
            if seq_len is not None:
                active = t < seq_len
                new = [_mask_to(active, n, c) for n, c in zip(new, carry)]
                outs = [_mask_to(active, o, torch.zeros_like(o)) for o in outs]
            carry = new
            for seq, o in zip(stacked, outs):
                seq.append(o)
        for (mem, _, _), c in zip(memories, carry):
            env[mem + "@LAST"] = c.detach()
        return {"Out": [torch.stack(seq, 1) for seq in stacked]}

    return rule


def lower_while(program, op, env: Dict):
    """while (while_op.cc:36; the reference's ``lower_while``).  attrs:
    sub_block, carry_vars (the condition var first), captured_vars,
    max_iters.  Binds the captured vars, the condition and the carries,
    then repeats the sub-block, which must reassign the condition var,
    while that var holds and fewer than ``max_iters`` (when set)
    iterations have run.  The carries' final values are the op's Out;
    the condition's final value is written to ``env`` by name, as the
    reference's handler does."""
    from ..core.lowering import run_block

    sub = program.blocks[op.attr("sub_block")]
    cond_name = op.input("Condition")[0]
    carry_names = [n for n in op.attr("carry_vars") if n != cond_name]
    captured = op.input("Captured")
    max_iters = int(op.attr("max_iters", 0) or 0)

    def rule(ctx, ins, attrs):
        if max_iters and ctx.training:
            raise NotImplementedError(
                "the training form of the 'while' op (max_iters under a "
                "training executor: the reference's masked scan, and "
                "while_grad) is not ported yet (ROADMAP queue 1 item 4); "
                "an inference executor runs the loop")
        benv = dict(zip(captured, ins.get("Captured", [])))
        benv[cond_name] = ins["Condition"][0]
        benv.update(zip(carry_names, ins.get("X", [])))
        n = 0
        while (not max_iters or n < max_iters) \
                and bool(benv[cond_name].reshape(())):
            run_block(ctx, program, sub, benv)
            n += 1
        env[cond_name] = benv[cond_name]
        return {"Out": [benv[c] for c in carry_names]}

    return rule


def _not_ported(program, op, env: Dict):
    def rule(ctx, ins, attrs):
        raise NotImplementedError(
            f"the {op.type!r} op is not ported yet (ROADMAP queue 1 "
            f"item 4)")
    return rule


# forward handlers; a grad op of these types (static_rnn_grad, ...) is
# served from its forward's tape (core/lowering.py)
CONTROL_FLOW_OPS = {
    "static_rnn": lower_static_rnn,
    "dynamic_rnn": lower_static_rnn,
    "while": lower_while,
    "conditional_block": _not_ported,
}

__all__ = ["CONTROL_FLOW_OPS", "lower_static_rnn", "lower_while"]
