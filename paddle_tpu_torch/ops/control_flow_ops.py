"""Control-flow op rules: ``static_rnn`` (and ``dynamic_rnn``, its
length-masked form) over a sub-block.

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

``while`` and ``conditional_block`` are registered, so that
``append_backward`` builds their grad ops as the reference does, but
running either raises ``NotImplementedError``: they come with beam-search
decoding.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.registry import register


def _never(ctx, ins, attrs):  # pragma: no cover
    raise RuntimeError("control-flow ops run through CONTROL_FLOW_OPS")


# registry entries let append_backward build grad op descs generically
register("static_rnn", no_grad_slots=())(_never)
register("dynamic_rnn", no_grad_slots=("SeqLen",))(_never)
register("while", no_grad_slots=("Condition", "Init"))(_never)
register("conditional_block", no_grad_slots=("Condition", "Init"))(_never)


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


def _not_ported(program, op, env: Dict):
    def rule(ctx, ins, attrs):
        raise NotImplementedError(
            f"the {op.type!r} op is not ported yet (it comes with "
            f"beam-search decoding: While, the TensorArray ops, "
            f"beam_search)")
    return rule


# forward handlers; a grad op of these types (static_rnn_grad, ...) is
# served from its forward's tape (core/lowering.py)
CONTROL_FLOW_OPS = {
    "static_rnn": lower_static_rnn,
    "dynamic_rnn": lower_static_rnn,
    "while": _not_ported,
    "conditional_block": _not_ported,
}

__all__ = ["CONTROL_FLOW_OPS", "lower_static_rnn"]
