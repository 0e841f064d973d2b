"""Control-flow layers: StaticRNN.

The part of ``paddle_tpu/layers/control_flow.py`` that machine
translation's training program calls, copied unchanged: the same calls
build the same ``static_rnn`` op and sub-block, byte for byte
(``Program.serialize``).  The op's rule runs the sub-block step by step
(``ops/control_flow_ops.py``).  While, ConditionalBlock and Switch come
with beam-search decoding.
"""
from __future__ import annotations

from typing import List, Optional

from ..core.program import Variable, default_main_program
from ..layer_helper import LayerHelper


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


class StaticRNN:
    """Fixed-length RNN over [B, T, ...] step inputs (control_flow.py:429;
    lowers to lax.scan → trains via reverse-scan vjp)."""

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


__all__ = ["StaticRNN"]
