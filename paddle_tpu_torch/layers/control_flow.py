"""Control-flow layers: While, StaticRNN, DynamicRNN, ConditionalBlock,
Switch, IfElse, the TensorArray layers, beam search and the LoD
rank-table layers.

``paddle_tpu/layers/control_flow.py``, copied unchanged: the same calls
build the same ``while``/``static_rnn``/``dynamic_rnn``/
``conditional_block`` ops and sub-blocks, byte for byte
(``Program.serialize``).  The ops' rules run the sub-blocks through
their ops (``ops/control_flow_ops.py``).
"""
from __future__ import annotations

import collections
from typing import List, Optional

from ..core.program import Variable, default_main_program
from ..layer_helper import LayerHelper
from .nn import _unary


def _written_names(block) -> List[str]:
    out = []
    for op in block.ops:
        for n in op.output_arg_names():
            if n and n not in out:
                out.append(n)
    return out


def _unstop_float_carries(parent, carries) -> None:
    """Loop carries are mutable state, not constants: a float TEMP var
    written inside the block becomes differentiable even if its initial
    value came from a stop-gradient source (fill_constant init).
    Persistable vars keep their flag."""
    from ..core.types import is_float

    for n in carries:
        v = parent.var_or_none(n)
        if v is not None and not v.persistable \
                and (v.dtype is None or is_float(v.dtype)):
            v.stop_gradient = False


def _copy_carry_inits(parent, sub_idx, names) -> List[str]:
    """Snapshot pre-block carry values into explicit ``@INIT`` vars
    (assign ops before the control-flow op; the reference's grad
    lowering reads them)."""
    out = []
    for n in names:
        v = parent.var(n)
        init = parent.create_var(name=f"{n}@INIT@{sub_idx}", shape=v.shape,
                                 dtype=v.dtype, stop_gradient=True)
        parent.append_op("assign", {"X": [n]}, {"Out": [init.name]})
        out.append(init.name)
    return out


def _captured_names(block, exclude) -> List[str]:
    defined = set(exclude)
    captured = []
    for op in block.ops:
        for n in op.input_arg_names():
            if n and n not in defined and n not in captured \
                    and not block.has_var(n):
                captured.append(n)
        defined |= {n for n in op.output_arg_names() if n}
    return captured


class BlockGuard:
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.block = self.program._create_block()
        return self.block

    def __exit__(self, exc_type, *a):
        self.program._rollback()
        return False


class While:
    """while loop (control_flow.py:654).  The sub-block must reassign the
    condition var; vars assigned in the block that exist outside become the
    loop carry.  ``max_iters`` (a static trip-count bound) caps the loop;
    the reference also differentiates it through it."""

    def __init__(self, cond: Variable, name: Optional[str] = None,
                 max_iters: Optional[int] = None):
        self.helper = LayerHelper("while", name=name)
        assert cond.dtype == "bool", "While condition must be bool"
        self.cond_var = cond
        self.max_iters = max_iters

    def block(self):
        return _WhileGuard(self)


class _WhileGuard(BlockGuard):
    def __init__(self, while_op: While):
        super().__init__(default_main_program())
        self.while_op = while_op

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            self.program._rollback()
            return False
        sub = self.block
        self.program._rollback()
        parent = self.program.current_block()
        cond_name = self.while_op.cond_var.name
        carries = [n for n in _written_names(sub)
                   if parent.var_or_none(n) is not None and n != cond_name]
        captured = [n for n in _captured_names(sub, [cond_name] + carries)
                    if parent.var_or_none(n) is not None]
        _unstop_float_carries(parent, carries)
        init_names = _copy_carry_inits(parent, sub.idx, [cond_name] + carries)
        parent.append_op(
            "while",
            {"Condition": [cond_name], "X": carries, "Captured": captured,
             "Init": init_names},
            {"Out": carries},
            {"sub_block": sub.idx, "carry_vars": [cond_name] + carries,
             "captured_vars": captured,
             "max_iters": self.while_op.max_iters or 0},
        )
        return False


class StaticRNN:
    """Fixed-length RNN over [B, T, ...] step inputs (control_flow.py:429;
    its op runs the sub-block a step at a time under one tape)."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = self.BEFORE_RNN_BLOCK
        self._step_inputs = []      # (outer_name, inner_var)
        self._memories = []         # [inner_mem_name, init_name, updated_name]
        self._outputs = []          # (inner_name, outer_var)
        self._sub_block = None
        self.seq_len = None

    def step(self):
        return _RnnGuard(self)

    def _assert_in_rnn_block(self):
        assert self.status == self.IN_RNN_BLOCK, "must be called in rnn.step() block"

    def step_input(self, x: Variable) -> Variable:
        self._assert_in_rnn_block()
        if self.seq_len is None:
            self.seq_len = x.shape[1]
        inner = self._sub_block.create_var(
            name=x.name + "@STEP", dtype=x.dtype,
            shape=(x.shape[0],) + tuple(x.shape[2:]))
        self._step_inputs.append((x.name, inner))
        return inner

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1) -> Variable:
        self._assert_in_rnn_block()
        if init is None:
            assert shape is not None and batch_ref is not None, \
                "memory needs init or (shape, batch_ref)"
            parent = self._sub_block.parent_block
            # batch_ref may be an inner step var — the init op lives in the
            # parent block, so reference the outer sequence input instead
            ref_name = batch_ref.name
            for outer, inner in self._step_inputs:
                if inner.name == ref_name:
                    ref_name = outer
                    break
            init = parent.create_var(
                name=self.helper.name + f".mem_init_{len(self._memories)}",
                dtype=batch_ref.dtype,
                shape=(batch_ref.shape[0],) + tuple(shape))
            # materialize init before the rnn op (in the parent block)
            parent.append_op(
                "fill_constant_batch_size_like",
                {"Input": [ref_name]}, {"Out": [init.name]},
                {"shape": [-1] + list(shape), "dtype": init.dtype,
                 "value": init_value, "input_dim_idx": 0, "output_dim_idx": 0})
        mem = self._sub_block.create_var(
            name=self.helper.name + f".mem_{len(self._memories)}",
            dtype=init.dtype, shape=init.shape)
        self._memories.append([mem.name, init.name, None])
        return mem

    def update_memory(self, mem: Variable, var: Variable) -> None:
        self._assert_in_rnn_block()
        for rec in self._memories:
            if rec[0] == mem.name:
                rec[2] = var.name
                return
        raise ValueError(f"{mem.name} is not a memory of this RNN")

    def step_output(self, o: Variable) -> None:
        self._assert_in_rnn_block()
        outer = self._sub_block.parent_block.create_var(
            name=o.name + "@SEQ", dtype=o.dtype,
            shape=(o.shape[0], self.seq_len) + tuple(o.shape[1:]))
        self._outputs.append((o.name, outer))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        assert self.status == self.AFTER_RNN_BLOCK, "call rnn() after the step block"
        outs = [outer for _, outer in self._outputs]
        return outs[0] if len(outs) == 1 else outs

    def _complete(self):
        sub = self._sub_block
        parent = sub.parent_block
        assert all(rec[2] is not None for rec in self._memories), \
            "every memory needs update_memory"
        inner_defined = [inner.name for _, inner in self._step_inputs] + \
            [rec[0] for rec in self._memories]
        captured = _captured_names(sub, inner_defined)
        parent.append_op(
            "static_rnn",
            {"X": [outer for outer, _ in self._step_inputs],
             "Init": [rec[1] for rec in self._memories],
             "Captured": captured},
            {"Out": [outer.name for _, outer in self._outputs]},
            {"sub_block": sub.idx,
             "step_inputs": [outer for outer, _ in self._step_inputs],
             "step_input_vars": [inner.name for _, inner in self._step_inputs],
             "memories": self._memories,
             "step_outputs": [[inner, outer.name] for inner, outer in self._outputs]},
        )


class _RnnGuard(BlockGuard):
    def __init__(self, rnn: StaticRNN):
        super().__init__(default_main_program())
        self.rnn = rnn

    def __enter__(self):
        self.block = self.program._create_block()
        self.rnn._sub_block = self.block
        self.rnn.status = StaticRNN.IN_RNN_BLOCK
        return self.block

    def __exit__(self, exc_type, *a):
        self.program._rollback()
        if exc_type is None:
            self.rnn.status = StaticRNN.AFTER_RNN_BLOCK
            self.rnn._complete()
        return False


class ConditionalBlock:
    """Run a block iff condition (control_flow.py:1203)."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        self.helper = LayerHelper("conditional_block", name=name)
        self.cond = inputs[0] if isinstance(inputs, (list, tuple)) else inputs

    def block(self):
        return _CondGuard(self)


class _CondGuard(BlockGuard):
    def __init__(self, cb: ConditionalBlock):
        super().__init__(default_main_program())
        self.cb = cb

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            self.program._rollback()
            return False
        sub = self.block
        self.program._rollback()
        parent = self.program.current_block()
        carries = [n for n in _written_names(sub)
                   if parent.var_or_none(n) is not None]
        cond_name = self.cb.cond.name
        captured = [n for n in _captured_names(sub, [cond_name] + carries)
                    if parent.var_or_none(n) is not None]
        _unstop_float_carries(parent, carries)
        init_names = _copy_carry_inits(parent, sub.idx, carries)
        parent.append_op(
            "conditional_block",
            {"Condition": [cond_name], "X": carries, "Captured": captured,
             "Init": init_names},
            {"Out": carries},
            {"sub_block": sub.idx, "carry_vars": carries,
             "captured_vars": captured},
        )
        return False


class Switch:
    """case/default sugar over ConditionalBlock (control_flow.py:1285)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions: List[Variable] = []

    def case(self, condition):
        from . import nn
        if self.pre_not_conditions:
            not_prev = _unary("logical_not", self.pre_not_conditions[-1],
                              out_dtype="bool")
            cond = self._and(not_prev, condition)
        else:
            cond = condition
        self.pre_not_conditions.append(
            self._or(self.pre_not_conditions[-1], condition)
            if self.pre_not_conditions else condition)
        return ConditionalBlock([cond]).block()

    def default(self):
        assert self.pre_not_conditions, "default needs a prior case"
        not_all = _unary("logical_not", self.pre_not_conditions[-1],
                         out_dtype="bool")
        return ConditionalBlock([not_all]).block()

    def _and(self, a, b):
        helper = LayerHelper("logical_and")
        out = helper.create_variable_for_type_inference("bool", shape=a.shape)
        helper.append_op("logical_and", {"X": [a], "Y": [b]}, {"Out": [out]})
        return out

    def _or(self, a, b):
        helper = LayerHelper("logical_or")
        out = helper.create_variable_for_type_inference("bool", shape=a.shape)
        helper.append_op("logical_or", {"X": [a], "Y": [b]}, {"Out": [out]})
        return out

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class DynamicRNN(StaticRNN):
    """Variable-length RNN over padded sequences (control_flow.py:1541).

    The reference sorts sequences with a LoDRankTable and shrinks the
    batch per step; the padded form runs over [B, T, ...] and masks
    memory updates + outputs by each row's sequence length (the ``@LEN``
    companion of the lod_level>=1 input): rows past their length keep
    their last state and emit zeros.  Differentiated through one tape,
    as StaticRNN (``ops/control_flow_ops.py``).
    """

    def __init__(self, name: Optional[str] = None):
        super().__init__(name=name)
        self._seq_len_name = None

    def block(self):  # reference API name
        return self.step()

    def step_input(self, x: Variable) -> Variable:
        from .nn import seq_len_var

        lv = seq_len_var(x)
        if lv is None:
            raise ValueError(
                f"DynamicRNN.step_input needs a sequence input with a "
                f"length companion (data(lod_level=1)); {x.name!r} has "
                f"none — use StaticRNN for fixed-length input")
        if self._seq_len_name is None:
            self._seq_len_name = lv.name
        return super().step_input(x)

    def _complete(self):
        sub = self._sub_block
        parent = sub.parent_block
        assert all(rec[2] is not None for rec in self._memories), \
            "every memory needs update_memory"
        inner_defined = [inner.name for _, inner in self._step_inputs] + \
            [rec[0] for rec in self._memories]
        captured = _captured_names(sub, inner_defined)
        parent.append_op(
            "dynamic_rnn",
            {"X": [outer for outer, _ in self._step_inputs],
             "Init": [rec[1] for rec in self._memories],
             "Captured": captured,
             "SeqLen": [self._seq_len_name]},
            {"Out": [outer.name for _, outer in self._outputs]},
            {"sub_block": sub.idx,
             "step_inputs": [outer for outer, _ in self._step_inputs],
             "step_input_vars": [inner.name for _, inner in self._step_inputs],
             "memories": self._memories,
             "step_outputs": [[inner, outer.name]
                              for inner, outer in self._outputs]},
        )
        # outputs are padded sequences with the same lengths as the input
        from .nn import _alias_len

        seq_len = parent.var(self._seq_len_name)
        for _, outer in self._outputs:
            _alias_len(outer, seq_len)


def less_than(x, y, cond=None):
    from .nn import _cmp_layer

    return _cmp_layer("less_than", x, y, cond)


# ---------------------------------------------------------------------------
# TensorArray (preallocated [max_len, ...] + int64 length; ops/array_ops.py)
# ---------------------------------------------------------------------------

def _array_len_var(array: Variable) -> Variable:
    return array.block.var(array.name + "@ALEN")


def create_array(dtype, element_shape, max_len, name=None) -> Variable:
    """TensorArray of capacity ``max_len`` (LoDTensorArray analogue;
    the reference grows on write, a static shape needs the bound)."""
    helper = LayerHelper("array", name=name)
    arr = helper.create_variable_for_type_inference(
        dtype, shape=(max_len,) + tuple(element_shape))
    ln = arr.block.create_var(name=arr.name + "@ALEN", dtype="int64",
                              shape=(1,))
    helper.append_op("fill_constant", {}, {"Out": [arr]},
                     {"shape": [max_len] + list(element_shape),
                      "dtype": arr.dtype, "value": 0.0})
    helper.append_op("fill_constant", {}, {"Out": [ln]},
                     {"shape": [1], "dtype": "int64", "value": 0})
    return arr


def array_write(x: Variable, i: Variable, array: Variable) -> Variable:
    """array[i] = x (tensor_array_read_write_op.cc WriteToArray)."""
    ln = _array_len_var(array)
    array.block.program.current_block().append_op(
        "array_write",
        {"X": [x.name], "I": [i.name], "Array": [array.name],
         "ArrayLen": [ln.name]},
        {"Out": [array.name], "LenOut": [ln.name]})
    return array


def array_read(array: Variable, i: Variable) -> Variable:
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(
        array.dtype, shape=tuple(array.shape[1:]))
    helper.append_op("array_read", {"Array": [array], "I": [i]},
                     {"Out": [out]})
    return out


def array_length(array: Variable) -> Variable:
    """Number of written slots (reference array_length op)."""
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", shape=(1,))
    helper.append_op("assign", {"X": [_array_len_var(array)]},
                     {"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# beam search (ops/array_ops.py; reference beam_search_op.cc)
# ---------------------------------------------------------------------------

def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                name=None):
    """One step of beam search over [batch*beam, K] candidates; returns
    (selected_ids [BW,1], selected_scores [BW,1], parent_idx [BW]).
    Seed pre_scores with 0 for beam 0 and -inf for the others of each
    group at step 0 (see ops/array_ops.py beam_search docstring)."""
    helper = LayerHelper("beam_search", name=name)
    bw = ids.shape[0]
    sel_ids = helper.create_variable_for_type_inference("int64", shape=(bw, 1))
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype, shape=(bw, 1))
    parent = helper.create_variable_for_type_inference("int64", shape=(bw,))
    helper.append_op(
        "beam_search",
        {"PreIds": [pre_ids], "PreScores": [pre_scores], "Ids": [ids],
         "Scores": [scores]},
        {"SelectedIds": [sel_ids], "SelectedScores": [sel_scores],
         "ParentIdx": [parent]},
        {"beam_size": beam_size, "end_id": end_id})
    return sel_ids, sel_scores, parent


BeamDecodeResult = collections.namedtuple(
    "BeamDecodeResult", ["ids", "scores", "cand_len", "src_len"])


def beam_search_decode(ids_array, parents_array, beam_size, end_id,
                       scores_array=None, name=None):
    """Backtrack TensorArrays of per-step selections into the reference's
    level-2 nested result (beam_search_decode_op.cc), padded:

    - ``ids``      [batch*beam, max_len] flat token values, with its
      ``@LEN`` companion aliased to ``cand_len`` so sequence ops mask
      each candidate at its real token length
    - ``scores``   [batch*beam, max_len] per-token scores along the same
      backtrack (None unless ``scores_array`` is given)
    - ``cand_len`` [batch*beam] tokens per candidate (incl. the end_id)
    - ``src_len``  [batch] candidates per source sentence
    """
    from .nn import _alias_len

    helper = LayerHelper("beam_search_decode", name=name)
    t_max, bw = ids_array.shape[0], ids_array.shape[1]
    sents = helper.create_variable_for_type_inference(
        "int64", shape=(bw, t_max))
    cand_len = helper.create_variable_for_type_inference(
        "int64", shape=(bw,), stop_gradient=True)
    src_len = helper.create_variable_for_type_inference(
        "int64", shape=(bw // beam_size,), stop_gradient=True)
    ins = {"Ids": [ids_array], "Parents": [parents_array],
           "ArrayLen": [_array_len_var(ids_array)]}
    outs = {"SentenceIds": [sents], "SentenceLen": [cand_len],
            "SourceLen": [src_len]}
    scores = None
    if scores_array is not None:
        ins["Scores"] = [scores_array]
        scores = helper.create_variable_for_type_inference(
            scores_array.dtype, shape=(bw, t_max))
        outs["SentenceScores"] = [scores]
    helper.append_op("beam_search_decode", ins, outs,
                     {"end_id": end_id, "beam_size": beam_size})
    _alias_len(sents, cand_len)
    return BeamDecodeResult(sents, scores, cand_len, src_len)


# ---------------------------------------------------------------------------
# LoD rank-table machinery (reference layers/control_flow.py lod_rank_table
# family + IfElse).  A RankTable is a pair of [B] vars: sequence indices in
# descending-length order and the lengths in that order.
# ---------------------------------------------------------------------------

class RankTable:
    """LoDRankTable analogue (framework/lod_rank_table.h) on the padded
    contract."""

    def __init__(self, rank_idx: Variable, rank_len: Variable):
        self.rank_idx = rank_idx
        self.rank_len = rank_len


def lod_rank_table(x, level=0):
    """Build a rank table from x's @LEN companion (level-1 sequences;
    reference lod_rank_table_op.cc)."""
    from .nn import seq_len_var

    if level != 0:
        raise ValueError(
            "lod_rank_table: only level-0 of the level-1 padded contract "
            "exists (nested LoD has no rank table)")
    sl = seq_len_var(x)
    if sl is None:
        raise ValueError(f"lod_rank_table: {x.name!r} has no @LEN companion")
    helper = LayerHelper("lod_rank_table")
    idx = helper.create_variable_for_type_inference(
        "int64", shape=(x.shape[0],), stop_gradient=True)
    lens = helper.create_variable_for_type_inference(
        "int64", shape=(x.shape[0],), stop_gradient=True)
    helper.append_op("lod_rank_table", {"SeqLen": [sl]},
                     {"RankIdx": [idx], "RankLen": [lens]}, {})
    return RankTable(idx, lens)


def max_sequence_len(rank_table):
    """Longest sequence length in the table (max_sequence_len_op.cc)."""
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference(
        "int64", shape=(1,), stop_gradient=True)
    helper.append_op("max_sequence_len",
                     {"RankLen": [rank_table.rank_len]}, {"Out": [out]}, {})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """Gather rows into rank order (reorder_lod_tensor_by_rank_op.cc)."""
    from .nn import seq_len_var, _alias_len

    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    ins = {"X": [x], "RankIdx": [rank_table.rank_idx]}
    outs = {"Out": [out]}
    sl = seq_len_var(x)
    if sl is not None:
        new_len = helper.create_variable_for_type_inference(
            "int64", shape=(x.shape[0],), stop_gradient=True)
        ins["SeqLen"] = [sl]
        outs["OutLen"] = [new_len]
    helper.append_op("reorder_lod_tensor_by_rank", ins, outs, {})
    if sl is not None:
        _alias_len(out, new_len)
    return out


def lod_tensor_to_array(x, table):
    """[B,T,...] -> TensorArray [T,B,...] in rank order
    (lod_tensor_to_array_op.cc; the array is full-batch per step, see
    ops/array_ops.py)."""
    helper = LayerHelper("lod_tensor_to_array")
    T = x.shape[1]
    arr = helper.create_variable_for_type_inference(
        x.dtype, shape=(T, x.shape[0]) + tuple(x.shape[2:]))
    ln = arr.block.create_var(name=arr.name + "@ALEN", dtype="int64",
                              shape=(1,))
    helper.append_op("lod_tensor_to_array",
                     {"X": [x], "RankIdx": [table.rank_idx]},
                     {"Out": [arr], "LenOut": [ln]}, {})
    return arr


def array_to_lod_tensor(x, table):
    """Inverse of lod_tensor_to_array (array_to_lod_tensor_op.cc)."""
    from .nn import _alias_len

    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(
        x.dtype, shape=(x.shape[1], x.shape[0]) + tuple(x.shape[2:]))
    out_len = helper.create_variable_for_type_inference(
        "int64", shape=(x.shape[1],), stop_gradient=True)
    helper.append_op("array_to_lod_tensor",
                     {"X": [x], "RankIdx": [table.rank_idx],
                      "RankLen": [table.rank_len]},
                     {"Out": [out], "OutLen": [out_len]}, {})
    _alias_len(out, out_len)  # lengths restored to original row order
    return out


def shrink_memory(x, i, table):
    """Zero memory rows of finished sequences at step i
    (shrink_rnn_memory_op.cc; masked instead of sliced: static shapes)."""
    helper = LayerHelper("shrink_rnn_memory")
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("shrink_rnn_memory",
                     {"X": [x], "I": [i], "RankLen": [table.rank_len]},
                     {"Out": [out]}, {})
    return out


def split_lod_tensor(input, mask, level=0):
    """Route rows by boolean mask into (true, false) full-batch tensors
    with unselected rows zeroed (split_lod_tensor_op.cc redesign)."""
    helper = LayerHelper("split_lod_tensor")
    out_true = helper.create_variable_for_type_inference(
        input.dtype, shape=input.shape)
    out_false = helper.create_variable_for_type_inference(
        input.dtype, shape=input.shape)
    helper.append_op("split_lod_tensor",
                     {"X": [input], "Mask": [mask]},
                     {"OutTrue": [out_true], "OutFalse": [out_false]}, {})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    """Row-wise select (merge_lod_tensor_op.cc)."""
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_variable_for_type_inference(
        in_true.dtype, shape=in_true.shape)
    helper.append_op("merge_lod_tensor",
                     {"InTrue": [in_true], "InFalse": [in_false],
                      "Mask": [mask], "X": [x]},
                     {"Out": [out]}, {})
    return out


class IfElse:
    """Row-wise if-else (reference layers/control_flow.py IfElse).

    The reference's redesign, copied: the reference splits the batch by
    ``cond`` and runs each block on its subset; here both blocks run on
    the full batch (unselected rows zeroed by split_lod_tensor) and the
    outputs merge row-wise, with static shapes.  Contract unchanged for
    row-wise blocks (each output row depends only on its input row).

    Usage matches the reference::

        ie = fluid.layers.IfElse(cond)      # cond: [B, 1] bool
        with ie.true_block():
            d = ie.input(x)
            ie.output(some_layers(d))
        with ie.false_block():
            d = ie.input(x)
            ie.output(other_layers(d))
        out, = ie()
    """

    OUT, IN_TRUE, IN_FALSE = 0, 1, 2

    def __init__(self, cond, name=None):
        self.cond = cond
        self.status = self.OUT
        self._splits = {}     # input name -> (true_masked, false_masked)
        self._outputs = {self.IN_TRUE: [], self.IN_FALSE: []}

    def _guard(self, status):
        import contextlib

        @contextlib.contextmanager
        def guard():
            if self.status != self.OUT:
                raise ValueError("cannot nest IfElse blocks")
            self.status = status
            try:
                yield
            finally:
                self.status = self.OUT
        return guard()

    def true_block(self):
        return self._guard(self.IN_TRUE)

    def false_block(self):
        return self._guard(self.IN_FALSE)

    def input(self, x):
        if self.status == self.OUT:
            raise ValueError("IfElse.input() must be called inside a block")
        if x.name not in self._splits:
            self._splits[x.name] = split_lod_tensor(x, self.cond)
        t, f = self._splits[x.name]
        return t if self.status == self.IN_TRUE else f

    def output(self, *outs):
        if self.status == self.OUT:
            raise ValueError("IfElse.output() must be called inside a block")
        self._outputs[self.status].extend(outs)

    def __call__(self):
        t_outs = self._outputs[self.IN_TRUE]
        f_outs = self._outputs[self.IN_FALSE]
        if len(t_outs) != len(f_outs):
            raise ValueError(
                f"IfElse blocks produced {len(t_outs)} vs {len(f_outs)} "
                "outputs; both blocks must ie.output() the same arity")
        return [merge_lod_tensor(t, f, t, self.cond)
                for t, f in zip(t_outs, f_outs)]


__all__ = ["BeamDecodeResult", "ConditionalBlock", "DynamicRNN", "IfElse",
           "RankTable", "StaticRNN", "Switch", "While", "array_length",
           "array_read", "array_to_lod_tensor", "array_write",
           "beam_search", "beam_search_decode", "create_array", "less_than",
           "lod_rank_table", "lod_tensor_to_array", "max_sequence_len",
           "merge_lod_tensor", "reorder_lod_tensor_by_rank", "shrink_memory",
           "split_lod_tensor"]
