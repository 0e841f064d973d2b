"""Control flow on the port: ``static_rnn`` (and ``dynamic_rnn``, its
length-masked form) against the JAX reference, from the same copied
starting values.

The reference lowers a sub-block to ``lax.scan`` and differentiates it
with ``jax.vjp``; the port runs the sub-block step by step under one
autograd tape, and ``static_rnn_grad`` reads that tape.  Every gradient
the grad op asks for is checked: the step inputs (``X``), the
memories' initial values (``Init``) and the captured outer variables
and parameters (``Captured``).  Tolerances: 1e-5 for the forward,
rtol 1e-4 / atol 2e-6 for the gradients (float32 through the steps in
two frameworks, as the stacked LSTM's tests).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import rnn as TR

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
B, T, D, HD = 4, 5, 6, 8
LENS = np.array([5, 2, 1, 4], "int64")


def _feed(seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(B, T, D).astype("float32"),
            "x@LEN": LENS,
            "h0": rs.randn(B, HD).astype("float32") * 0.3,
            "bias": rs.randn(HD).astype("float32") * 0.1,
            "seq": rs.randn(B, 3, 4 * HD).astype("float32") * 0.3}


def _rnn_model(fluid, rnn_cls, cell=None):
    """A two-output RNN whose step reads a step input, a memory with an
    initial value, a memory the layer fills from the batch, a captured
    outer variable (``bias``) and captured parameters; ``cell`` puts a recurrent op (``gru``/``lstm``) over the
    captured sequence ``seq`` inside the step."""
    L = fluid.layers
    x = L.data("x", [D], lod_level=1, stop_gradient=False)
    h0 = L.data("h0", [HD], stop_gradient=False)
    bias = L.data("bias", [HD], append_batch_size=False, stop_gradient=False)
    seq = L.data("seq", [3, 4 * HD], stop_gradient=False)
    rnn = rnn_cls()
    with rnn.step():
        cur = rnn.step_input(x)
        h = rnn.memory(init=h0)
        # a memory whose initial value the layer makes from the batch
        acc = rnn.memory(shape=[HD], batch_ref=cur, init_value=0.5)
        pre = L.fc([cur, h], HD, param_attr=[fluid.ParamAttr(name="rnn.wx"),
                                             fluid.ParamAttr(name="rnn.wh")],
                   bias_attr=fluid.ParamAttr(name="rnn.b"))
        pre = L.elementwise_add(L.elementwise_add(pre, bias), acc)
        if cell == "gru":
            hid = L.dynamic_gru(L.slice(seq, axes=[2], starts=[0],
                                        ends=[3 * HD]), HD,
                                param_attr=fluid.ParamAttr(name="cell.w"),
                                bias_attr=fluid.ParamAttr(name="cell.b"))
            pre = L.elementwise_add(pre, L.reduce_sum(hid, dim=1))
        elif cell == "lstm":
            hid, _ = L.dynamic_lstm(seq, 4 * HD,
                                    param_attr=fluid.ParamAttr(name="cell.w"),
                                    bias_attr=fluid.ParamAttr(name="cell.b"))
            pre = L.elementwise_add(pre, L.reduce_sum(hid, dim=1))
        new_h = L.tanh(pre)
        rnn.update_memory(h, new_h)
        rnn.update_memory(acc, L.scale(new_h, scale=0.5))
        rnn.step_output(new_h)
        rnn.step_output(L.fc(new_h, 3, param_attr=fluid.ParamAttr(
            name="rnn.out.w"), bias_attr=False))
    out, logits = rnn()
    loss = L.elementwise_add(L.mean(out), L.mean(L.square(logits)))
    fluid.append_backward(loss)
    return out, logits


def _build(fluid, Program, guard, unique, rnn_cls, cell):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 3
    with guard(main, startup), unique.guard():
        out, logits = _rnn_model(fluid, rnn_cls, cell)
    params = sorted(p.name for p in main.all_parameters())
    fetch = ([out.name, logits.name, "x@GRAD", "h0@GRAD", "bias@GRAD",
              "seq@GRAD"] if cell else
             [out.name, logits.name, "x@GRAD", "h0@GRAD", "bias@GRAD"])
    return main, startup, fetch + [p + "@GRAD" for p in params], params


def _reference(kind, cell):
    rnn_cls = (jfluid.layers.StaticRNN if kind == "static_rnn"
               else jfluid.layers.control_flow.DynamicRNN)
    main, startup, fetch, params = _build(jfluid, JProgram, j_guard,
                                          j_unique, rnn_cls, cell)
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {p: np.array(scope.find_var(p)) for p in params}
        want = exe.run(main, feed=_feed(), fetch_list=fetch)
    return main, fetch, params, init, want


def _run_port(program, fetch, init):
    scope = tfluid.Scope()
    scope.load_numpy(init, device="cpu")
    n = t_lowering.grad_recomputes
    got = tfluid.Executor("cpu").run(program, feed=_feed(), fetch_list=fetch,
                                     scope=scope)
    assert t_lowering.grad_recomputes == n      # the tape, no re-run
    return got


def _compare(fetch, got, want):
    for name, a, b in zip(fetch[:2], got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **FWD_TOL)
    for name, a, b in zip(fetch[2:], got[2:], want[2:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
        assert np.abs(a).max() > 0, name


@pytest.mark.parametrize("kind", ["static_rnn", "dynamic_rnn"])
def test_rnn_forward_and_every_gradient_match_reference(kind):
    """X, Init and Captured (an outer variable and every parameter of the
    step) gradients; the outputs come back [B, T, ...].  static_rnn is
    built by the port's own StaticRNN (byte-identical program);
    dynamic_rnn, whose layer is not ported, by deserializing the
    reference's program, so its SeqLen masking (rows past their length
    keep their memory and output zeros) runs on the port."""
    ref_main, fetch, params, init, want = _reference(kind, None)
    if kind == "static_rnn":
        main, _, t_fetch, _ = _build(tfluid, TProgram, t_guard, t_unique,
                                     tfluid.layers.StaticRNN, None)
        assert main.serialize() == ref_main.serialize()
        assert t_fetch == fetch
    else:
        main = TProgram.deserialize(ref_main.serialize())
    types = [op.type for op in main.global_block.ops]
    assert types.count(kind) == 1 and types.count(kind + "_grad") == 1
    got = _run_port(main, fetch, init)
    assert got[0].shape == (B, T, HD) and got[1].shape == (B, T, 3)
    if kind == "dynamic_rnn":
        assert not np.any(got[0][2, 1:]) and not np.any(got[1][1, 2:])
    _compare(fetch, got, want)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_recurrent_cell_in_a_sub_block_takes_the_plain_version(
        cell, monkeypatch):
    """A gru/lstm op inside the step is differentiated by the step's
    tape, so it runs its plain version and never the ctypes kernels (the
    reference keeps its Pallas cells to the top-level block too): the
    kernel wrappers are made to raise, and the gradients still reach the
    cell's weights and the captured sequence."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran inside a sub-block")

    for fn in ("gru_fused", "gru_fused_grad", "lstm_fused",
               "lstm_fused_grad"):
        monkeypatch.setattr(TR, fn, refuse)
    ref_main, fetch, params, init, want = _reference("static_rnn", cell)
    main, _, _, _ = _build(tfluid, TProgram, t_guard, t_unique,
                           tfluid.layers.StaticRNN, cell)
    assert main.serialize() == ref_main.serialize()
    assert [op.type for op in main.blocks[1].ops].count(cell) == 1
    _compare(fetch, _run_port(main, fetch, init), want)


def _while_program():
    L = jfluid.layers
    main, startup = JProgram(), JProgram()
    with j_guard(main, startup), j_unique.guard():
        x = L.data("x", [4])
        flag = L.data("flag", [], append_batch_size=False, dtype="bool")
        s = L.fill_constant((), "float32", 0.0)
        # max_iters under a training executor: the training form
        with L.While(flag, max_iters=3).block():
            L.assign(L.elementwise_add(s, L.reduce_sum(x)), s)
            L.assign(L.fill_constant((), "bool", 0.0), flag)
    return main, s


def _cond_program():
    L = jfluid.layers
    main, startup = JProgram(), JProgram()
    with j_guard(main, startup), j_unique.guard():
        x = L.data("x", [4])
        flag = L.data("flag", [], append_batch_size=False, dtype="bool")
        s = L.fill_constant((), "float32", -1.0)
        with L.ConditionalBlock([flag]).block():
            L.assign(L.reduce_sum(x), s)
    return main, s


@pytest.mark.parametrize("kind", ["while", "conditional_block"])
def test_while_and_conditional_block_are_not_ported(kind):
    """Both are registered (append_backward builds their grad ops) but
    running conditional_block, or while in its training form (max_iters
    under a training executor: the reference's masked scan), raises
    NotImplementedError naming the op.  The inference while runs
    (tests/test_torch_beam_ops.py)."""
    main, s = _while_program() if kind == "while" else _cond_program()
    prog = TProgram.deserialize(main.serialize())
    assert kind in [op.type for op in prog.global_block.ops]
    feed = {"x": np.ones((2, 4), "float32"), "flag": np.array(True)}
    with pytest.raises(NotImplementedError, match=repr(kind)):
        tfluid.Executor("cpu").run(prog, feed=feed, fetch_list=[s.name],
                                   scope=tfluid.Scope())
