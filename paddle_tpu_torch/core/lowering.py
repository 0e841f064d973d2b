"""Block interpreter: a Program block run op by op through the registry.

The port of ``paddle_tpu/core/lowering.py``.  ``analyze_block`` finds a
block's external reads (scope state) and persistable writes exactly as
the reference does, walking control-flow sub-blocks; ``lower_ops`` then
runs every op's rule eagerly on torch tensors, and sends the ops in
``CONTROL_FLOW_OPS`` to their handlers (``ops/control_flow_ops.py``),
which run their sub-block through :func:`run_block`.  There is no jit:
the reference's ``build_block_fn`` is the plan plus one interpreter
pass (``Executor.run``).  The reference's two peephole hooks run on
the top-level block, in its order:

- the fused sparse gather: with ``FLAGS_sparse_fused_kernel`` on,
  sparse ``lookup_table`` ops that share one Ids input are gathered by
  one K9 launch (``kernels/sparse.py: plan_lookup_fusion``);
- the int8 FC: the ``mul``/``fused_fc`` ops the ``quantize_int8`` pass
  stamped run through K5 (``kernels/quant.py: plan_int8``).  An
  uncalibrated program builds no plan and runs unchanged.

A value that is not a tensor (a ``SelectedRows`` gradient) passes
through the environment untouched.  A variable leaves the environment
after the last op that reads or writes it (the plan's ``drops``)
unless it is fetched or persistable: eager PyTorch frees an activation
gradient once the backward has used it, and so does the interpreter,
while autograd keeps what a tape still needs.

Gradients.  Eager PyTorch has no common-subexpression pass, so the
reference's default grad (re-trace the forward under ``jax.vjp`` and
let XLA merge it with the original) would run every forward twice.
Instead the plan pairs each grad op ``<type>_grad`` with its forward op
once per program, by the forward input and output names the grad op
carries (``core/backward.py`` copies them verbatim), and adds nothing
to the program, so a program the reference built runs unchanged:

- a paired forward op runs under ``torch.enable_grad()`` on leaf copies
  of the inputs whose gradients its grad op asks for, and keeps its
  autograd graph (the op's *tape*);
- the grad op calls ``torch.autograd.grad`` on that graph with the
  incoming cotangents; a missing cotangent counts as zeros, as the
  reference's ``make_cot`` does;
- a grad op whose forward left no tape re-runs the forward on fresh
  leaves (``torch.func``-style re-execution) and adds one to
  :data:`grad_recomputes`;
- ops with an explicit grad rule (dropout, cast) keep theirs and run
  their forward without a tape.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import quant as _quant_kernels
from ..kernels import sparse as _sparse_kernels
from ..observability import perf as _perf
from ..observability import stats as _obs_stats
from ..observability import trace as _obs_trace
from ..ops.control_flow_ops import CONTROL_FLOW_OPS
from . import registry
from .program import EMPTY_VAR, Block, Program
from .registry import GRAD_OP_SUFFIX, LowerContext, is_float_tensor

# ops handled by the executor itself, not lowered
SKIP_OPS = ("feed", "fetch")

# grad ops computed by re-running their forward (no tape); the
# Transformer training step keeps this at 0
grad_recomputes = 0


@dataclass
class BlockPlan:
    """Static dataflow summary of one block, plus the grad pairing."""

    block_idx: int
    feed_names: tuple
    fetch_names: tuple
    state_reads: List[str] = field(default_factory=list)     # scope vars read
    persist_writes: List[str] = field(default_factory=list)  # scope vars written
    has_stateful: bool = False
    # grad op index -> index of its forward op
    grad_fwd: Dict[int, int] = field(default_factory=dict)
    # forward op index -> [(input slot, position)] whose grads are asked for
    taped: Dict[int, List[Tuple[str, int]]] = field(default_factory=dict)
    # forward op index -> index of the last grad op that reads its tape
    tape_last_use: Dict[int, int] = field(default_factory=dict)
    # op index -> the vars no later op reads or writes, to drop from the
    # run's environment once the op has run (fetches and persistables
    # stay)
    drops: Dict[int, List[str]] = field(default_factory=dict)


def _is_grad_op(op) -> bool:
    return op.type.endswith(GRAD_OP_SUFFIX) and not registry.has(op.type)


def _base_type(op) -> str:
    return op.type[: -len(GRAD_OP_SUFFIX)]


def _fwd_key(op) -> tuple:
    # backward.py builds the grad op's inputs as {**ins, **outs, grads}
    d = {**op.inputs, **op.outputs}
    return (op.type, tuple(sorted((s, tuple(n)) for s, n in d.items())))


def _grad_key(op) -> tuple:
    d = {s: n for s, n in op.inputs.items() if not s.endswith("@GRAD")}
    return (_base_type(op), tuple(sorted((s, tuple(n))
                                         for s, n in d.items())))


def _wanted_grads(op) -> List[Tuple[str, int]]:
    """(forward input slot, position) pairs a grad op writes."""
    out = []
    for slot, names in op.outputs.items():
        if not slot.endswith("@GRAD"):
            continue
        for j, n in enumerate(names):
            if n and n != EMPTY_VAR:
                out.append((slot[: -len("@GRAD")], j))
    return out


def pair_grad_ops(block: Block, plan: BlockPlan) -> None:
    """Pair every grad op without a custom rule with the latest earlier
    forward op of the same type and the same input/output names."""
    last_fwd: Dict[tuple, int] = {}
    for pos, op in enumerate(block.ops):
        if op.type in SKIP_OPS:
            continue
        if not _is_grad_op(op):
            last_fwd[_fwd_key(op)] = pos
            continue
        base = _base_type(op)
        if not registry.has(base) or registry.get(base).grad is not None:
            continue
        fwd = last_fwd.get(_grad_key(op))
        if fwd is None:
            continue
        plan.grad_fwd[pos] = fwd
        wanted = plan.taped.setdefault(fwd, [])
        for w in _wanted_grads(op):
            if w not in wanted:
                wanted.append(w)
        plan.tape_last_use[fwd] = pos


def analyze_block(program: Program, block_idx: int, feed_names: Sequence[str],
                  fetch_names: Sequence[str]) -> BlockPlan:
    t0 = time.perf_counter_ns() if _obs_trace.flags_on() else None
    plan = BlockPlan(block_idx, tuple(feed_names), tuple(fetch_names))
    seen_reads = set()
    persist_written = set()
    block = program.blocks[block_idx]

    def is_persistable(blk: Block, name: str) -> bool:
        v = blk.var_or_none(name)
        return bool(v and v.persistable)

    def walk(blk: Block, defined: set):
        for op in blk.ops:
            if op.type in SKIP_OPS:
                continue
            base = _base_type(op) if _is_grad_op(op) else op.type
            if registry.has(base) and registry.get(base).stateful:
                plan.has_stateful = True
            for n in op.input_arg_names():
                if n and n != EMPTY_VAR and n not in defined \
                        and n not in seen_reads:
                    seen_reads.add(n)
                    plan.state_reads.append(n)
            # names a control-flow op binds inside its sub-block (step
            # inputs, memories, loop carries) are not scope reads
            inner = set(op.attr("carry_vars", ()) or ())
            inner |= set(op.attr("step_input_vars", ()) or ())
            inner |= {m[0] for m in (op.attr("memories", ()) or ())}
            for sub in op.sub_block_ids:
                walk(program.blocks[sub], set(defined) | inner)
            for n in op.output_arg_names():
                if not n or n == EMPTY_VAR:
                    continue
                defined.add(n)
                if is_persistable(blk, n) and n not in persist_written:
                    persist_written.add(n)
                    plan.persist_writes.append(n)

    walk(block, set(feed_names))

    # fetches of vars never touched by ops must still come from scope
    defined_or_read = seen_reads | set(feed_names)
    for op in block.ops:
        defined_or_read |= set(op.output_arg_names())
    for n in fetch_names:
        if n not in defined_or_read and n not in seen_reads:
            seen_reads.add(n)
            plan.state_reads.append(n)
    pair_grad_ops(block, plan)
    plan_drops(block, plan)
    if t0 is not None:
        t1 = time.perf_counter_ns()
        _obs_stats.scope("lowering").histogram("analyze_ms").observe(
            (t1 - t0) / 1e6)
        if _obs_trace.enabled():
            _obs_trace.emit("lowering::analyze", t0, t1)
    return plan


def plan_drops(block: Block, plan: BlockPlan) -> None:
    """Fill ``plan.drops``: each var at the last op that reads or writes
    it, unless it is fetched or persistable.  (A control-flow op's
    sub-block sees only the outer vars the op takes as inputs.)"""
    last: Dict[str, int] = {}
    for pos, op in enumerate(block.ops):
        if op.type not in SKIP_OPS:
            for n in op.input_arg_names() + op.output_arg_names():
                last[n] = pos
    keep = set(plan.fetch_names)
    for n, pos in last.items():
        v = block.var_or_none(n)
        if n and n != EMPTY_VAR and n not in keep \
                and not (v is not None and v.persistable):
            plan.drops.setdefault(pos, []).append(n)


def _gather_ins(op, env: Dict) -> Dict:
    ins = {}
    for slot, names in op.inputs.items():
        if slot.endswith("@GRAD"):
            # grad slots keep positional alignment; missing grads → None
            vals = [env.get(n) if n and n != EMPTY_VAR else None
                    for n in names]
            if any(v is not None for v in vals):
                ins[slot] = vals
        else:
            vals = [env[n] for n in names if n and n != EMPTY_VAR]
            if vals:
                ins[slot] = vals
    return ins


def _rule(program: Program, op, env: Dict, opdef):
    """The forward rule of ``op``: a control-flow op's from its handler,
    any other op's from the registry."""
    make = CONTROL_FLOW_OPS.get(opdef.type)
    return make(program, op, env) if make is not None else opdef.lower


def _run_with_leaves(opdef, rule, ctx, ins, attrs, wanted):
    """Run a forward rule under autograd with leaf copies of the wanted
    float inputs; returns (leaves {(slot, j): leaf}, outs)."""
    ins = {s: list(v) for s, v in ins.items()}
    leaves = {}
    for slot, j in wanted:
        vals = ins.get(slot)
        if slot in opdef.no_grad_slots or vals is None or j >= len(vals) \
                or not is_float_tensor(vals[j]):
            continue
        leaf = vals[j].detach().requires_grad_(True)
        vals[j] = leaf
        leaves[(slot, j)] = leaf
    with torch.enable_grad():
        outs = rule(ctx, ins, attrs)
    return leaves, outs


def _grads_from_graph(leaves, outs, ins, retain: bool) -> Dict:
    """``torch.autograd.grad`` of the recorded outputs against their
    cotangents (``<slot>@GRAD`` in ``ins``); outputs without one are
    left out, which is a zero cotangent."""
    ys, gs = [], []
    for slot, vals in outs.items():
        g_list = ins.get(slot + "@GRAD")
        if not g_list:
            continue
        for j, y in enumerate(vals):
            if j >= len(g_list) or g_list[j] is None:
                continue
            if not isinstance(y, torch.Tensor) or not y.requires_grad:
                continue
            g = g_list[j]
            ys.append(y)
            gs.append(g.to(y.dtype) if g.dtype != y.dtype else g)
    keys = list(leaves)
    if ys and keys:
        grads = torch.autograd.grad(ys, [leaves[k] for k in keys], gs,
                                    allow_unused=True, retain_graph=retain)
    else:
        grads = [None] * len(keys)
    by_slot: Dict[str, Dict[int, torch.Tensor]] = {}
    for (slot, j), g in zip(keys, grads):
        if g is None:
            g = torch.zeros_like(leaves[(slot, j)])
        by_slot.setdefault(slot + "@GRAD", {})[j] = g.detach()
    return {s: [d.get(j) for j in range(max(d) + 1)]
            for s, d in by_slot.items()}


def _recompute_grad(base, rule, ctx, ins, op) -> Dict:
    """Grad of an op whose forward left no tape: run the forward again
    on fresh leaves (counted in :data:`grad_recomputes`)."""
    global grad_recomputes
    grad_recomputes += 1
    fwd_out = set(op.attrs.get("__fwd_out_slots__", ()))
    if base.output_slots:
        fwd_out |= set(base.output_slots)
    fwd_ins = {s: v for s, v in ins.items()
               if not s.endswith("@GRAD") and s not in fwd_out
               and (base.input_slots is None or s in base.input_slots)}
    attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
    leaves, outs = _run_with_leaves(base, rule, ctx, fwd_ins, attrs,
                                    _wanted_grads(op))
    return _grads_from_graph(leaves, outs, ins, retain=False)


def lower_ops(ctx: LowerContext, program: Program, block: Block, env: Dict,
              plan: BlockPlan, trace: Optional[list] = None) -> Dict:
    """Run every op in ``block`` through its rule, mutating env.  A
    ``trace`` list gets each op's shapes as it ran
    (``observability/perf.py: op_meta``, the perf plane's cost walk)."""
    tapes: Dict[int, tuple] = {}
    fusion = (_sparse_kernels.plan_lookup_fusion(block)
              if _sparse_kernels.enabled_for(ctx) else None)
    int8_plan = _quant_kernels.plan_int8(block)
    for pos, op in enumerate(block.ops):
        if op.type in SKIP_OPS:
            continue
        if not ((fusion is not None and fusion.covers(pos)
                 and fusion.lower(pos, env))
                or (int8_plan is not None and int8_plan.covers(pos)
                    and int8_plan.lower(pos, env))):
            _lower_op(ctx, program, block, op, pos, env, plan, tapes)
        if trace is not None:
            trace.append(_perf.op_meta(op, env))
        for n in plan.drops.get(pos, ()):
            env.pop(n, None)
    return env


def _lower_op(ctx, program, block, op, pos, env, plan, tapes) -> None:
    """Run one op through its rule (or its grad op through its forward's
    tape) and store its outputs in ``env``."""
    try:
        if _is_grad_op(op):
            ins = _gather_ins(op, env)
            base = registry.get(_base_type(op))
            fwd = plan.grad_fwd.get(pos)
            if base.grad is not None:
                outs = base.grad(ctx, ins, op.attrs)
            elif fwd is not None and fwd in tapes:
                last = plan.tape_last_use[fwd] == pos
                leaves, fouts = (tapes.pop(fwd) if last
                                 else tapes[fwd])
                outs = _grads_from_graph(leaves, fouts, ins,
                                         retain=not last)
            else:
                # a control-flow grad op carries its forward's attrs
                # and inputs, so the handler serves it too
                rule = _rule(program, op, env, base)
                outs = _recompute_grad(base, rule, ctx, ins, op)
        else:
            opdef = registry.get(op.type)
            rule = _rule(program, op, env, opdef)
            ins = _gather_ins(op, env)
            wanted = plan.taped.get(pos)
            if wanted:
                leaves, outs = _run_with_leaves(opdef, rule, ctx, ins,
                                                op.attrs, wanted)
                tapes[pos] = (leaves, outs)
            else:
                outs = rule(ctx, ins, op.attrs)
    except Exception as e:
        raise type(e)(f"while lowering op {op!r} in block {block.idx}: "
                      f"{e}") from e
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for name, val in zip(names, vals):
            if name and name != EMPTY_VAR and val is not None:
                env[name] = (val.detach() if isinstance(val, torch.Tensor)
                             else val)


def run_block(ctx: LowerContext, program: Program, block: Block,
              env: Dict) -> Dict:
    """Run the ops of a control-flow sub-block through their rules,
    mutating ``env``, and keep autograd's graph: unlike
    :func:`lower_ops` it stores what the rules return as it is, so
    gradients reach the values the caller bound in ``env``.  The rules
    see a context whose ``block`` is the sub-block, so the recurrent
    cells take their plain, differentiable versions there
    (``ops/nn_ops.py: _use_kernel``); the K9 lookup peephole is planned
    for the top-level block only.  A sub-block holds forward ops only:
    ``append_backward`` differentiates a control-flow op as a whole."""
    sub_ctx = copy.copy(ctx)
    sub_ctx.block = block
    for op in block.ops:
        if op.type in SKIP_OPS:
            continue
        try:
            rule = _rule(program, op, env, registry.get(op.type))
            outs = rule(sub_ctx, _gather_ins(op, env), op.attrs)
        except Exception as e:
            raise type(e)(f"while lowering op {op!r} in block {block.idx}: "
                          f"{e}") from e
        for slot, names in op.outputs.items():
            for name, val in zip(names, outs.get(slot, ())):
                if name and name != EMPTY_VAR and val is not None:
                    env[name] = val
    return env


__all__ = ["BlockPlan", "SKIP_OPS", "analyze_block", "grad_recomputes",
           "lower_ops", "pair_grad_ops", "plan_drops", "run_block"]
