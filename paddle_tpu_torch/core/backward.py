"""Graph-level autodiff: append gradient ops to the program.

Reference: ``python/paddle/fluid/backward.py:469`` (``append_backward``) —
find the op path to the loss, emit one grad op per forward op in reverse
order, sum duplicate gradient contributions, prune no-grad branches.

TPU-native difference: grad ops here carry no hand-written kernels.  A grad
op of type ``<op>_grad`` lowers through ``jax.vjp`` of the forward lowering
rule by default (``registry.vjp_grad``), so every registered op is
differentiable for free; ops whose forward consumes randomness register an
explicit grad rule (e.g. dropout uses its saved Mask).  Because the whole
block is jitted as one XLA computation, the vjp's re-traced forward is
merged with the original forward by XLA CSE.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from . import registry
from .program import (
    EMPTY_VAR,
    OP_ROLE_ATTR,
    OP_ROLE_VAR_ATTR,
    Block,
    Operator,
    OpRole,
    Variable,
    grad_var_name,
)
from .registry import GRAD_OP_SUFFIX
from .types import VarType, is_float


def _find_relevant_ops(block: Block, target: str) -> Set[int]:
    """Backward reachability: indices of ops whose outputs (transitively)
    feed the target var (reference ``_find_op_path_``, backward.py:645)."""
    needed = {target}
    relevant: Set[int] = set()
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if needed & set(op.output_arg_names()):
            relevant.add(idx)
            needed |= {n for n in op.input_arg_names() if n}
    return relevant


def _grad_allowed(block: Block, name: str, no_grad_set: Set[str]) -> bool:
    if not name or name == EMPTY_VAR or name in no_grad_set:
        return False
    v = block.var_or_none(name)
    if v is None:
        return True  # temp without desc: allow, dtype unknown
    if v.stop_gradient:
        return False
    return v.dtype is None or is_float(v.dtype)


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
) -> List[tuple]:
    """Append grad ops for ``loss``; return [(param_var, grad_var)] pairs.

    Only block-0 programs for now; grad-of-control-flow (reference
    while_op.cc:101 reverse sub-block machinery) arrives with the sequence
    stack, where RNN recurrence is a scan op whose vjp is the reverse scan.
    """
    assert loss.shape in ((1,), ()), (
        f"loss must be a scalar, got shape {loss.shape}"
    )
    return _append_backward_impl([loss], None, parameter_list, no_grad_set)


def calc_gradient(targets, inputs, target_gradients=None,
                  no_grad_set=None):
    """Gradients of ``targets`` w.r.t. ``inputs`` (reference
    backward.py:685 calc_gradient): seeds are ``target_gradients`` (or
    ones over each target); returns the grad Variable per input (None
    when the input does not influence any target — see reference semantics)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(
            target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    if target_gradients is not None and \
            len(target_gradients) != len(targets):
        raise ValueError(
            f"calc_gradient: {len(targets)} targets but "
            f"{len(target_gradients)} target_gradients")
    pairs = _append_backward_impl(list(targets), target_gradients,
                                  [v.name if isinstance(v, Variable) else v
                                   for v in inputs],
                                  no_grad_set, inputs_need_params=False)
    by_name = {p.name: g for p, g in pairs}
    return [by_name.get(v.name if isinstance(v, Variable) else v)
            for v in inputs]


def _append_backward_impl(
    targets: List[Variable],
    target_gradients: Optional[List[Variable]],
    parameter_list: Optional[Sequence[str]],
    no_grad_set: Optional[Set[str]],
    inputs_need_params: bool = True,
) -> List[tuple]:
    block = targets[0].block
    program = block.program
    no_grad = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient:
            no_grad.add(v.name)

    relevant = set()
    for t in targets:
        relevant |= _find_relevant_ops(block, t.name)

    # contributions: var name -> list of grad var names feeding it
    contribs: Dict[str, List[str]] = {}
    # monotone per-var counter for @RENAME@k grad names (stays unique even
    # when an in-place rewrite resets the contribution list below)
    grad_counts: Dict[str, int] = {}

    def add_contrib(var_name: str, grad_name: str):
        contribs.setdefault(var_name, []).append(grad_name)

    def resolve_out_grad(var_name: str) -> Optional[str]:
        """Gradient var for ``var_name``, emitting a sum op when several
        partials exist (reference ``_addup_repetitive_outputs_``)."""
        lst = contribs.get(var_name)
        if not lst:
            return None
        if len(lst) == 1:
            return lst[0]
        g = grad_var_name(var_name)
        _make_grad_var(block, g, var_name)
        block.append_op(
            "sum", {"X": list(lst)}, {"Out": [g]},
            {OP_ROLE_ATTR: OpRole.Backward},
        )
        contribs[var_name] = [g]
        return g

    # seeds: d target / d target = 1 (reference scale_loss_grad
    # boundary), or the caller-supplied target_gradients (calc_gradient)
    n_fwd_ops = len(block.ops)  # before any seed ops are appended
    for ti, t in enumerate(targets):
        tg = target_gradients[ti] if target_gradients else None
        if tg is not None:
            if tuple(tg.shape) != tuple(t.shape):
                raise ValueError(
                    f"target_gradient {tg.name!r} shape {tg.shape} != "
                    f"target {t.name!r} shape {t.shape}")
            add_contrib(t.name, tg.name)
            continue
        t_grad = grad_var_name(t.name)
        block.create_var(name=t_grad, shape=t.shape, dtype=t.dtype)
        block.append_op(
            "fill_constant",
            {},
            {"Out": [t_grad]},
            {
                "shape": list(t.shape),
                "value": 1.0,
                "dtype": t.dtype,
                OP_ROLE_ATTR: OpRole.Backward | OpRole.Loss,
            },
        )
        add_contrib(t.name, t_grad)
    for idx in range(n_fwd_ops - 1, -1, -1):
        if idx not in relevant:
            continue
        op = block.ops[idx]
        if op.attr(OP_ROLE_ATTR, OpRole.Forward) != OpRole.Forward:
            continue
        if op.type == "while" and not op.attr("max_iters"):
            raise NotImplementedError(
                "gradient of While needs a static trip-count bound: "
                "While(cond, max_iters=N) — the backward pass re-runs the "
                "loop as an N-step masked scan (the functional form of "
                "while_grad's step-scope replay, while_op.cc:101)")
        if op.type in ("static_rnn", "dynamic_rnn", "while",
                       "conditional_block"):
            # grad re-traces the sub-block; rng-consuming ops inside would
            # draw fresh keys and silently corrupt gradients — reject them
            sub = program.blocks[op.attr("sub_block")]
            for sop in sub.ops:
                if registry.has(sop.type) and registry.get(sop.type).stateful:
                    raise NotImplementedError(
                        f"op {sop.type!r} inside a {op.type} sub-block is "
                        f"not differentiable (rng re-traced in the reverse "
                        f"pass); hoist it outside or use is_test")
        if not registry.has(op.type):
            raise KeyError(f"cannot differentiate unregistered op {op.type!r}")
        opdef = registry.get(op.type)

        # gather grads of this op's outputs
        out_grad_inputs: Dict[str, List[str]] = {}
        any_grad = False
        for slot, names in op.outputs.items():
            gs = []
            for n in names:
                g = resolve_out_grad(n) if n else None
                gs.append(g if g is not None else EMPTY_VAR)
                any_grad = any_grad or g is not None
            out_grad_inputs[slot + "@GRAD"] = gs
        if not any_grad:
            continue

        if opdef.stateful and opdef.grad is None:
            raise RuntimeError(
                f"op {op.type!r} consumes randomness/state and must register "
                f"an explicit grad rule"
            )

        # grad op inputs: fwd ins + fwd outs + out grads
        g_inputs: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            g_inputs[slot] = list(names)
        for slot, names in op.outputs.items():
            g_inputs[slot] = list(names)
        g_inputs.update(out_grad_inputs)

        # in-place rewrites (op input name == output name, e.g. a
        # conditional_block/while carry): the downstream cotangent was just
        # consumed via Out@GRAD; earlier writers of the var must see ONLY
        # the grad wrt the pre-op value this grad op emits (the reference's
        # _rename_arg_ SSA discipline, backward.py:135)
        for n in set(op.input_arg_names()) & set(op.output_arg_names()):
            if n and n != EMPTY_VAR and contribs.get(n):
                grad_counts[n] = grad_counts.get(n, 0) + len(contribs[n])
                contribs[n] = []

        # grad op outputs: grads of differentiable inputs (renamed when a
        # var already has a partial, summed lazily at consumption)
        g_outputs: Dict[str, List[str]] = {}
        pairs_for_role: List[str] = []
        produced = False
        for slot, names in op.inputs.items():
            if slot in opdef.no_grad_slots:
                continue
            outs = []
            for n in names:
                if not _grad_allowed(block, n, no_grad):
                    outs.append(EMPTY_VAR)
                    continue
                k = grad_counts.get(n, 0) + len(contribs.get(n, []))
                gname = grad_var_name(n) if k == 0 else f"{grad_var_name(n)}@RENAME@{k}"
                _make_grad_var(block, gname, n)
                add_contrib(n, gname)
                outs.append(gname)
                produced = True
            if any(o != EMPTY_VAR for o in outs):
                g_outputs[slot + "@GRAD"] = outs
        if not produced:
            continue

        block.append_op(
            op.type + GRAD_OP_SUFFIX,
            g_inputs,
            g_outputs,
            {
                **{k: v for k, v in op.attrs.items() if k != OP_ROLE_ATTR},
                "__fwd_out_slots__": list(op.outputs.keys()),
                OP_ROLE_ATTR: OpRole.Backward,
            },
        )
        # sparse lookup gradients are SelectedRows (selected_rows.h:32);
        # mark the grad var so regularizers/transpilers can branch on it
        if op.type == "lookup_table" and op.attrs.get("is_sparse"):
            for gn in g_outputs.get("W@GRAD", ()):
                if gn != EMPTY_VAR:
                    block.var(gn).type = VarType.SELECTED_ROWS

    # canonicalize: any var left with several partials gets its summed
    # ``<var>@GRAD`` materialized, so fetching a leaf gradient by name sees
    # the total, not one partial (reference _addup_repetitive_outputs_
    # sums eagerly; we sum lazily, so flush here).  A single surviving
    # @RENAME partial (in-place carry reset) is assigned onto the
    # canonical name too — else the fetch would see the stale pre-reset
    # partial.
    for n, lst in list(contribs.items()):
        canonical = grad_var_name(n)
        if len(lst) > 1:
            resolve_out_grad(n)
        elif lst and lst[0] != canonical and grad_counts.get(n, 0):
            _make_grad_var(block, canonical, n)
            block.append_op("assign", {"X": [lst[0]]}, {"Out": [canonical]},
                            {OP_ROLE_ATTR: OpRole.Backward})

    # collect (param, grad) pairs
    params = (
        [block.var(p) if isinstance(p, str) else p for p in parameter_list]
        if parameter_list
        else block.all_parameters()
    )
    pairs = []
    for p in params:
        if inputs_need_params and not p.trainable:
            continue
        g = resolve_out_grad(p.name)
        if g is None:
            continue
        gv = block.var(g)
        pairs.append((p, gv))
    # annotate backward ops with their (param, grad) pairs for parallel
    # lowering (reference op_role_var, multi_devices_graph_pass.cc:520)
    role_vars = [n for p, g in pairs for n in (p.name, g.name)]
    for op in block.ops:
        if op.attr(OP_ROLE_ATTR) == OpRole.Backward and not op.has_attr(OP_ROLE_VAR_ATTR):
            op.set_attr(OP_ROLE_VAR_ATTR, role_vars)
    return pairs


def _make_grad_var(block: Block, grad_name: str, fwd_name: str) -> Variable:
    fv = block.var_or_none(fwd_name)
    return block.create_var(
        name=grad_name,
        shape=fv.shape if fv is not None else None,
        dtype=fv.dtype if fv is not None else "float32",
    )
