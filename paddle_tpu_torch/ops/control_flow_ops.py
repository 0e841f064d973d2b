"""Control-flow op rules: ``static_rnn`` (and ``dynamic_rnn``, its
length-masked form), ``while`` and ``conditional_block`` over a
sub-block.

The port of ``paddle_tpu/ops/control_flow_ops.py``.  The reference
lowers a sub-block to ``lax.scan``/``lax.while_loop``/``lax.cond`` and
differentiates it with ``jax.vjp``.  The port has no trace: it runs the
sub-block through its ops' rules (``core/lowering.py: run_block``), in
an environment that keeps autograd's graph, so the steps chain into one
graph.  The gradients follow the interpreter's tape design: the
executor runs the forward op under autograd on leaf copies of the float
inputs its grad op asks for (``X``, ``Init`` and ``Captured`` for
``static_rnn``; the float carries ``X`` and the captured vars
``Captured`` for ``while`` and ``conditional_block``), and the grad op
(``static_rnn_grad``, ``while_grad``, ``conditional_block_grad``) calls
``torch.autograd.grad`` on that tape; nothing is run twice.  At the
forward op's position a carry's input is the value its ``@INIT``
snapshot copies (the layers emit the ``assign`` just before the op), so
the leaves are the reference's primal inputs (``_carry_inits``).

The handlers see program variables by name, as the reference's do:
``CONTROL_FLOW_OPS[type](program, op, env)`` returns the op's rule
``(ctx, ins, attrs) -> outs`` over its slot values, and the rule may
write names outside the op's output slots into ``env`` (a memory's
final value, ``<mem>@LAST``; the loop condition's final value).

``while`` has two forms, as in the reference.  Under a training context
with ``max_iters`` set it is the reference's masked scan: exactly
``max_iters`` iterations, each carry and the condition selected with
``torch.where`` on the device condition, so the loop makes no host read
and a NaN or Inf made in a masked iteration is dropped as ``jnp.where``
drops it; forward and gradient truncate together at the bound.
Otherwise (inference, or no bound) the sub-block runs while the
condition holds, read on the host once an iteration, with ``max_iters``,
when set, a hard cap.  ``conditional_block`` reads its condition on the
host once and runs the sub-block only when it holds; the carries keep
their prior values otherwise.
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


def lower_while(program, op, env: Dict):
    """while (while_op.cc:36; the reference's ``lower_while``).  attrs:
    sub_block, carry_vars (the condition var first), captured_vars,
    max_iters.  Binds the captured vars, the condition and the carries,
    then runs the sub-block, which must reassign the condition var:
    under a training context with ``max_iters``, as the masked scan
    (module doc); otherwise while the condition holds and fewer than
    ``max_iters`` (when set) iterations have run.  The carries' final
    values are the op's Out; the condition's final value is written to
    ``env`` by name, as the reference's handler does."""
    from ..core.lowering import run_block

    sub = program.blocks[op.attr("sub_block")]
    cond_name = op.input("Condition")[0]
    carry_names = [n for n in op.attr("carry_vars") if n != cond_name]
    captured = op.input("Captured")
    max_iters = int(op.attr("max_iters", 0) or 0)

    def body(ctx, cond, carry, outer):
        benv = dict(outer)
        benv[cond_name] = cond
        benv.update(zip(carry_names, carry))
        run_block(ctx, program, sub, benv)
        return benv[cond_name], [benv[n] for n in carry_names]

    def rule(ctx, ins, attrs):
        if not max_iters and torch.is_grad_enabled():
            # a tape asks for while_grad (reference lower_while_grad)
            raise NotImplementedError(
                "gradient of While requires max_iters (a static trip-count "
                "bound): While(cond, max_iters=N)")
        outer = dict(zip(captured, ins.get("Captured", [])))
        cond = ins["Condition"][0]
        carry = list(ins.get("X", []))
        if max_iters and ctx.training:
            for _ in range(max_iters):
                new_cond, new = body(ctx, cond, carry, outer)
                active = cond.reshape(()).to(torch.bool)
                carry = [torch.where(active, n.to(c.dtype), c)
                         for n, c in zip(new, carry)]
                cond = torch.where(active, new_cond.to(cond.dtype), cond)
        else:
            n = 0
            while (not max_iters or n < max_iters) \
                    and bool(cond.reshape(())):
                cond, carry = body(ctx, cond, carry, outer)
                n += 1
        env[cond_name] = cond
        return {"Out": carry}

    return rule


def lower_conditional_block(program, op, env: Dict):
    """conditional_block (conditional_block_op.cc; the reference's
    ``lower_conditional_block``).  attrs: sub_block, carry_vars,
    captured_vars.  The scalar condition is read on the host; when it
    holds the sub-block runs on the captured vars and the carries and
    the carries' new values are the op's Out, else the carries keep
    their prior values."""
    from ..core.lowering import run_block

    sub = program.blocks[op.attr("sub_block")]
    carry_names = list(op.attr("carry_vars"))
    captured = op.input("Captured")
    for n in carry_names:
        if n not in env:
            raise RuntimeError(
                f"conditional_block carry {n!r} has no prior value; "
                f"initialize it before the block (layers.fill_constant)")

    def rule(ctx, ins, attrs):
        carry = list(ins.get("X", []))
        if not bool(ins["Condition"][0].reshape(())):
            return {"Out": carry}
        benv = dict(zip(captured, ins.get("Captured", [])))
        benv.update(zip(carry_names, carry))
        run_block(ctx, program, sub, benv)
        return {"Out": [benv[n] for n in carry_names]}

    return rule


# forward handlers; a grad op of these types (static_rnn_grad,
# while_grad, conditional_block_grad) is served from its forward's tape
# (core/lowering.py)
CONTROL_FLOW_OPS = {
    "static_rnn": lower_static_rnn,
    "dynamic_rnn": lower_static_rnn,
    "while": lower_while,
    "conditional_block": lower_conditional_block,
}

__all__ = ["CONTROL_FLOW_OPS", "lower_conditional_block", "lower_static_rnn",
           "lower_while"]
