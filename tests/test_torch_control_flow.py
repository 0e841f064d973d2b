"""Control flow on the port against the JAX reference, from the same
copied starting values: ``static_rnn`` (and ``dynamic_rnn``, its
length-masked form), the training ``while`` (the reference's masked
scan) with ``while_grad``, the inference ``while``,
``conditional_block`` with its grad, and ``Switch``.

The reference lowers a sub-block to ``lax.scan``/``lax.cond`` and
differentiates it with ``jax.vjp``; the port runs the sub-block through
its ops under one autograd tape, and the grad op reads that tape.  Every
gradient the grad op asks for is checked: the step inputs (``X``), the
memories' initial values (``Init``) and the captured outer variables
and parameters (``Captured``).  Tolerances: 1e-5 for the RNN forward,
rtol 1e-4 / atol 2e-6 for its gradients (float32 through the steps in
two frameworks, as the stacked LSTM's tests); ``CF_FWD_TOL`` and
``CF_GRAD_TOL`` below for the other programs.
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


# ---------------------------------------------------------------------------
# while (training form and while_grad), conditional_block and Switch: each
# program is built by both packages (byte-identical), the reference's
# startup values are copied into the port's scope, and both run the same
# feed.  Tolerances: CF_FWD_TOL for forward values and CF_GRAD_TOL for
# gradients (float32 through a few steps in two frameworks, as above).
# ---------------------------------------------------------------------------

CF_FWD_TOL = dict(rtol=1e-5, atol=1e-6)
CF_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
RB, RT, RH = 2, 4, 3       # tests/test_decode.py's while recurrence


def _parity(build, feed, training=True):
    """``build(fluid) -> fetch names`` under each package; returns the
    reference's fetches, the port's, and the port's program."""
    progs = {}
    for key, fluid, Program, guard, unique in (
            ("ref", jfluid, JProgram, j_guard, j_unique),
            ("port", tfluid, TProgram, t_guard, t_unique)):
        main, startup = Program(), Program()
        main.random_seed = startup.random_seed = 5
        with guard(main, startup), unique.guard():
            fetch = build(fluid)
        progs[key] = (main, startup, fetch)
    (jm, js, fetch), (tm, ts, _) = progs["ref"], progs["port"]
    assert tm.serialize() == jm.serialize()
    assert ts.serialize() == js.serialize()
    exe, scope = JExecutor(training=training), JScope()
    with j_scope_guard(scope):
        exe.run(js)
        init = {p.name: np.array(scope.find_var(p.name))
                for p in jm.all_parameters()}
        want = exe.run(jm, feed=feed, fetch_list=fetch, sync=True)
    t_scope = tfluid.Scope()
    t_scope.load_numpy(init, device="cpu")
    n = t_lowering.grad_recomputes
    got = tfluid.Executor("cpu", training=training).run(
        tm, feed=feed, fetch_list=fetch, scope=t_scope, sync=True)
    assert t_lowering.grad_recomputes == n      # the tape, no re-run
    return [np.asarray(w) for w in want], got, tm


def _while_rnn(w0):
    """h <- tanh(h @ w + x_t), t = 0..RT-1, as a While loop
    (tests/test_decode.py:72)."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [RT, RH])
        x.stop_gradient = False
        w = L.create_parameter(
            [RH, RH], "float32", name="w",
            default_initializer=fluid.initializer.NumpyArrayInitializer(w0))
        xt = L.transpose(x, perm=[1, 0, 2])
        h = L.fill_constant([RB, RH], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", RT)
        cond = L.less_than(i, n)
        with L.While(cond, max_iters=RT).block():
            x_t = L.array_read(xt, i)
            L.assign(L.tanh(L.elementwise_add(L.mul(h, w), x_t)), h)
            L.increment(i, 1)
            L.less_than(i, n, cond=cond)
        loss = L.mean(L.square(h))
        fluid.append_backward(loss)
        return [loss.name, "x@GRAD", "w@GRAD"]
    return build


def _scan_rnn(w0):
    """The same recurrence as a StaticRNN (tests/test_decode.py:100)."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [RT, RH])
        x.stop_gradient = False
        w = L.create_parameter(
            [RH, RH], "float32", name="w",
            default_initializer=fluid.initializer.NumpyArrayInitializer(w0))
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            mem = rnn.memory(shape=[RH], batch_ref=x_t, init_value=0.0)
            new = L.tanh(L.elementwise_add(L.mul(mem, w), x_t))
            rnn.update_memory(mem, new)
            rnn.step_output(new)
        last = L.squeeze(L.slice(rnn(), axes=[1], starts=[RT - 1],
                                 ends=[RT]), [1])
        loss = L.mean(L.square(last))
        fluid.append_backward(loss)
        return [loss.name, "x@GRAD", "w@GRAD"]
    return build


def test_while_grad_matches_reference_and_static_rnn():
    """The training while (a masked scan of max_iters steps) and
    while_grad, X@GRAD through the captured transposed input and
    Captured@GRAD of the parameter, against the reference, and against
    the port's own StaticRNN of the same recurrence (the reference's
    check, tests/test_decode.py:121)."""
    rng = np.random.RandomState(0)
    xv = rng.randn(RB, RT, RH).astype("float32")
    w0 = (rng.randn(RH, RH) * 0.5).astype("float32")
    want, got, prog = _parity(_while_rnn(w0), {"x": xv})
    assert [op.type for op in prog.global_block.ops].count("while_grad") == 1
    for name, a, b in zip(("loss", "x@GRAD", "w@GRAD"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **CF_GRAD_TOL)
        assert np.abs(a).max() > 0, name
    _, scan, _ = _parity(_scan_rnn(w0), {"x": xv})
    for name, a, b in zip(("loss", "x@GRAD", "w@GRAD"), got, scan):
        np.testing.assert_allclose(a, b, err_msg=name, **CF_GRAD_TOL)


def _accumulate(trips, max_iters, nan_after=None):
    """acc += x for ``trips`` iterations under While(max_iters); with
    ``nan_after`` the body also adds log(nan_after - i), NaN once i
    passes it (in the masked iterations only)."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [1])
        x.stop_gradient = False
        acc = L.fill_constant([1, 1], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", trips)
        cond = L.less_than(i, n)
        with L.While(cond, max_iters=max_iters).block():
            new = L.elementwise_add(acc, x)
            if nan_after is not None:
                lim = L.fill_constant([1], "float32", float(nan_after))
                new = L.elementwise_add(new, L.log(L.elementwise_sub(
                    lim, L.cast(i, "float32"))))
            L.assign(new, acc)
            L.increment(i, 1)
            L.less_than(i, n, cond=cond)
        loss = L.mean(acc)
        fluid.append_backward(loss)
        return [loss.name, "x@GRAD", acc.name]
    return build


@pytest.mark.parametrize("trips,max_iters,loss,grad", [
    (2, 8, 6.0, 2.0),    # early exit: no gradient from masked iterations
    (10, 5, 15.0, 5.0),  # truncation: forward and backward stop together
])
def test_while_masked_scan_exit_and_truncation(trips, max_iters, loss,
                                               grad):
    """tests/test_decode.py:136 and :159 on the port, against the
    reference and against the exact values."""
    want, got, _ = _parity(_accumulate(trips, max_iters),
                           {"x": np.array([[3.0]], "float32")})
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **CF_FWD_TOL)
    np.testing.assert_allclose(got[0], loss, rtol=1e-6)
    np.testing.assert_allclose(got[1], [[grad]], rtol=1e-6)


def test_while_masked_iterations_drop_nan_as_the_reference():
    """The training form reads no condition on the host: the masked
    iterations still run, and a NaN they make (log of a negative) is
    dropped by the select, as the reference's jnp.where drops it; the
    gradients agree with the reference's, NaN for NaN."""
    want, got, _ = _parity(_accumulate(2, 6, nan_after=1.5),
                           {"x": np.array([[3.0]], "float32")})
    assert np.isfinite(got[0]).all() and np.isfinite(got[2]).all()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, equal_nan=True, **CF_FWD_TOL)


@pytest.mark.parametrize("flag", [1.0, 0.0])
def test_conditional_block_grad_matches_reference(flag):
    """tests/test_decode.py:187: the block's values where the condition
    holds and the carry's prior value otherwise, and the gradient of
    both the carry (X@GRAD) and the captured var (Captured@GRAD, zeros
    when the block did not run)."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [3])
        x.stop_gradient = False
        c = L.data("c", [1])
        y = L.scale(x, scale=1.0)
        with L.ConditionalBlock([L.cast(c, "bool")]).block():
            L.assign(L.scale(x, scale=3.0), y)
        loss = L.mean(y)
        fluid.append_backward(loss)
        return [loss.name, y.name, "x@GRAD"]

    feed = {"x": np.arange(1, 4, dtype="float32")[None],
            "c": np.array([[flag]], "float32")}
    want, got, _ = _parity(build, feed)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **CF_FWD_TOL)
    np.testing.assert_allclose(got[2], np.full((1, 3), (3.0 if flag else
                                                        1.0) / 3.0),
                               rtol=1e-6)


def test_unbounded_while_and_conditional_block_forward():
    """tests/test_control_flow.py:13 and :35: a while without max_iters
    runs its inference form under a training executor (one host read of
    the condition an iteration), and conditional_block takes its block
    or keeps the carry's value."""
    def loop(fluid):
        L = fluid.layers
        x = L.data("x", [4])
        i = L.fill_constant((), "float32", 0.0)
        n = L.fill_constant((), "float32", 10.0)
        s = L.fill_constant((), "float32", 0.0)
        cond = fluid.layers.control_flow.less_than(i, n)
        with fluid.layers.While(cond).block():
            L.assign(L.elementwise_add(s, L.reduce_sum(x)), s)
            L.increment(i, 1.0)
            fluid.layers.control_flow.less_than(i, n, cond=cond)
        return [s.name]

    want, got, _ = _parity(loop, {"x": np.ones((2, 4), "float32")})
    assert float(got[0]) == float(want[0]) == 80.0

    def block(fluid):
        L = fluid.layers
        x = L.data("x", [1])
        flag = L.data("flag", [], append_batch_size=False, dtype="bool")
        out = L.fill_constant((), "float32", -1.0)
        with fluid.layers.ConditionalBlock([flag]).block():
            L.assign(L.reduce_sum(x), out)
        return [out.name]

    for flag, value in ((True, 6.0), (False, -1.0)):
        want, got, _ = _parity(block, {"x": np.full((3, 1), 2.0, "float32"),
                                       "flag": np.array(flag)})
        assert float(got[0]) == float(want[0]) == value


def test_unbounded_while_grad_raises_naming_max_iters():
    """tests/test_control_flow.py:104: differentiating a While without
    max_iters raises NotImplementedError naming max_iters, when
    append_backward builds the program and, for a program built with a
    bound that is then removed, when while_grad's tape is asked for."""
    L = tfluid.layers
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        x = L.data("x", [4])
        i = L.fill_constant((), "float32", 0.0)
        n = L.fill_constant((), "float32", 3.0)
        s = L.fc(x, 1)
        cond = L.control_flow.less_than(i, n)
        with L.While(cond).block():
            L.assign(L.scale(s, 2.0), s)
            L.increment(i, 1.0)
            L.control_flow.less_than(i, n, cond=cond)
        with pytest.raises(NotImplementedError, match="max_iters"):
            tfluid.optimizer.SGD(0.1).minimize(L.mean(s))
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        x = L.data("x", [1], stop_gradient=False)
        acc = L.fill_constant([1, 1], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        cond = L.less_than(i, n)
        with L.While(cond, max_iters=4).block():
            L.assign(L.elementwise_add(acc, x), acc)
            L.increment(i, 1)
            L.less_than(i, n, cond=cond)
        tfluid.append_backward(L.mean(acc))
    for op in main.global_block.ops:
        if op.type in ("while", "while_grad"):
            op.attrs["max_iters"] = 0
    with pytest.raises(NotImplementedError, match="max_iters"):
        tfluid.Executor("cpu").run(
            main, feed={"x": np.ones((1, 1), "float32")},
            fetch_list=["x@GRAD"], scope=tfluid.Scope())


def test_conditional_block_carry_without_prior_value_raises():
    """The reference's error (control_flow_ops.py:203) for a carry the
    parent never gave a value."""
    from paddle_tpu_torch.ops.control_flow_ops import CONTROL_FLOW_OPS
    L = tfluid.layers
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        flag = L.data("flag", [], append_batch_size=False, dtype="bool")
        out = main.global_block.create_var(name="unset", shape=(),
                                           dtype="float32")
        with L.ConditionalBlock([flag]).block():
            L.assign(L.fill_constant((), "float32", 1.0), out)
    (op,) = [o for o in main.global_block.ops
             if o.type == "conditional_block"]
    with pytest.raises(RuntimeError, match="no prior value"):
        CONTROL_FLOW_OPS["conditional_block"](main, op, {"flag": None})


@pytest.mark.parametrize("step", [1, 4, 8])
def test_switch_cases_and_default_match_reference(step):
    """Switch (control_flow.py:1285): the first case whose condition
    holds, else the default, through one conditional_block a case;
    forward and the gradient through the taken branch."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [3])
        x.stop_gradient = False
        k = L.data("k", [1], append_batch_size=False)
        out = L.fill_constant([1, 3], "float32", 0.0)
        with L.Switch() as switch:
            with switch.case(L.less_than(
                    k, L.fill_constant([1], "float32", 3.0))):
                L.assign(L.scale(x, scale=2.0), out)
            with switch.case(L.less_than(
                    k, L.fill_constant([1], "float32", 6.0))):
                L.assign(L.scale(x, scale=3.0), out)
            with switch.default():
                L.assign(L.scale(x, scale=4.0), out)
        loss = L.mean(out)
        fluid.append_backward(loss)
        return [out.name, "x@GRAD"]

    xv = np.array([[1.0, 2.0, 3.0]], "float32")
    want, got, prog = _parity(build, {"x": xv,
                                      "k": np.array([step], "float32")})
    assert [op.type for op in prog.global_block.ops].count(
        "conditional_block") == 3
    scale = 2.0 if step < 3 else 3.0 if step < 6 else 4.0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **CF_FWD_TOL)
    np.testing.assert_allclose(got[0], scale * xv, rtol=1e-6)
    np.testing.assert_allclose(got[1], np.full((1, 3), scale / 3.0),
                               rtol=1e-6)


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than",
                                "greater_equal", "equal", "not_equal",
                                "logical_and", "logical_or", "logical_xor",
                                "logical_not"])
def test_compare_and_logical_ops_match_reference(op):
    """The comparison and logical op rules (Switch builds its cases from
    logical_not/and/or), with Y broadcast along ``axis``, against the
    reference's, exactly."""
    rs = np.random.RandomState(3)
    if op.startswith("logical"):
        feed = {"x": rs.rand(4, 3) > 0.5, "y": rs.rand(3) > 0.5}
    else:
        feed = {"x": rs.randint(0, 3, (4, 3)).astype("float32"),
                "y": rs.randint(0, 3, (4,)).astype("float32")}
    axis = -1 if op.startswith("logical") else 0

    def build(fluid):
        L = fluid.layers
        dt = "bool" if op.startswith("logical") else "float32"
        x = L.data("x", [4, 3], append_batch_size=False, dtype=dt)
        y = L.data("y", list(feed["y"].shape), append_batch_size=False,
                   dtype=dt)
        helper = fluid.layer_helper.LayerHelper(op)
        out = helper.create_variable_for_type_inference("bool")
        ins = {"X": [x]} if op == "logical_not" else {"X": [x], "Y": [y]}
        helper.append_op(op, ins, {"Out": [out]}, {"axis": axis})
        return [out.name]

    want, got, _ = _parity(build, feed)
    assert got[0].dtype == np.bool_
    np.testing.assert_array_equal(got[0], want[0])
