"""The port's Program stack against the JAX package's: the IR
round-trips byte for byte, the port's layers build the reference's
Transformer program byte for byte, and the fc/SGD drive trains the same
losses from the same starting values.

Tolerance of the drive: a 4-in, 1-out fc trained by SGD over 30 steps
of float32 arithmetic in two frameworks; the losses agree to float32
rounding, well inside 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.layer_helper import LayerHelper as THelper
from paddle_tpu_torch.models import transformer as t_transformer

SMALL = dict(src_vocab=50, tgt_vocab=50, max_len=16, d_model=32, n_head=4,
             d_ffn=64, n_layer=2)


def _build(Program, guard, unique, module, **kw):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 3
    with guard(main, startup), unique.guard():
        module.build(**kw)
    return main, startup


@pytest.mark.parametrize("impl,dropout", [("pallas", 0.1), ("pallas", 0.0),
                                          ("xla", 0.1)])
def test_port_layers_build_the_reference_transformer(impl, dropout):
    kw = dict(SMALL, dropout=dropout, attention_impl=impl)
    jm, js = _build(JProgram, j_guard, j_unique, j_transformer, **kw)
    tm, ts = _build(TProgram, t_guard, t_unique, t_transformer, **kw)
    assert tm.serialize() == jm.serialize()
    assert ts.serialize() == js.serialize()


def test_serialized_reference_program_round_trips():
    jm, js = _build(JProgram, j_guard, j_unique, j_transformer,
                    **dict(SMALL, dropout=0.1, attention_impl="pallas"))
    for prog in (jm, js):
        data = prog.serialize()
        assert TProgram.deserialize(data).serialize() == data


def test_reference_program_runs_in_the_port():
    """A program the reference built and serialized runs in the port
    unchanged (with the port's own random initial values)."""
    jm, js = _build(JProgram, j_guard, j_unique, j_transformer,
                    **dict(SMALL, dropout=0.1, attention_impl="pallas"))
    main = TProgram.deserialize(jm.serialize())
    startup = TProgram.deserialize(js.serialize())
    loss = [op for op in main.global_block.ops
            if op.type == "elementwise_div"][-1].output("Out")[0]
    rs = np.random.RandomState(0)
    feed = {"src_ids": rs.randint(0, 50, (2, 16)).astype("int64"),
            "tgt_ids": rs.randint(0, 50, (2, 16)).astype("int64"),
            "lbl_ids": rs.randint(0, 50, (2, 16)).astype("int64"),
            "src_mask": np.ones((2, 16), "float32"),
            "tgt_mask": np.ones((2, 16), "float32")}
    exe = tfluid.Executor(tfluid.CPUPlace())
    before = t_lowering.grad_recomputes
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        (l,) = exe.run(main, feed=feed, fetch_list=[loss])
    assert np.isfinite(l) and l.shape == ()
    assert t_lowering.grad_recomputes == before


def test_grad_op_without_its_forward_recomputes_and_counts():
    """A grad op whose forward is not in the program (its inputs fed)
    re-runs the forward rule on fresh leaves: right, and counted."""
    main = TProgram()
    blk = main.global_block
    for n, shape in (("x", (3, 4)), ("w", (4, 2)), ("out", (3, 2)),
                     ("out@GRAD", (3, 2)), ("x@GRAD", (3, 4))):
        blk.create_var(name=n, shape=shape, dtype="float32")
    blk.append_op("mul_grad",
                  {"X": ["x"], "Y": ["w"], "Out": ["out"],
                   "Out@GRAD": ["out@GRAD"]},
                  {"X@GRAD": ["x@GRAD"]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1,
                   "__fwd_out_slots__": ["Out"]})
    rs = np.random.RandomState(4)
    x, w, g = (rs.randn(*s).astype("float32")
               for s in ((3, 4), (4, 2), (3, 2)))
    before = t_lowering.grad_recomputes
    (gx,) = tfluid.Executor("cpu").run(
        main, feed={"x": x, "w": w, "out": x @ w, "out@GRAD": g},
        fetch_list=["x@GRAD"], scope=tfluid.Scope())
    np.testing.assert_allclose(gx, g @ w.T, rtol=1e-6, atol=1e-6)
    assert t_lowering.grad_recomputes == before + 1


def _fc_program(fluid, Program, guard, unique):
    main, startup = Program(), Program()
    with guard(main, startup), unique.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        p = fluid.layers.fc(x, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def _persistables(prog):
    return [v.name for v in prog.global_block.vars.values()
            if v.persistable]


def test_fc_sgd_drive_matches_the_reference():
    jm, js, jl = _fc_program(jfluid, JProgram, j_guard, j_unique)
    tm, ts, tl = _fc_program(tfluid, TProgram, t_guard, t_unique)
    assert tm.serialize() == jm.serialize()
    rs = np.random.RandomState(1)
    feeds = []
    for _ in range(30):
        xb = rs.randn(16, 4).astype("float32")
        feeds.append({"x": xb, "y": xb.sum(1, keepdims=True)})
    jexe, jscope = JExecutor(), JScope()
    with j_scope_guard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in _persistables(js)}
        jloss = [float(jexe.run(jm, feed=f, fetch_list=[jl], sync=True)[0])
                 for f in feeds]
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    tscope.load_numpy(init, device="cpu")
    with tfluid.scope_guard(tscope):
        tloss = [float(texe.run(tm, feed=f, fetch_list=[tl])[0])
                 for f in feeds]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-7)
    assert tloss[-1] < 0.01 * tloss[0]


def test_scope_numpy_round_trip_and_missing_state():
    scope = tfluid.Scope()
    arrs = {"a": np.arange(6, dtype="float32").reshape(2, 3),
            "b": np.array(3, dtype="int64")}
    scope.load_numpy(arrs, device="cpu")
    assert isinstance(scope.find_var("a"), torch.Tensor)
    back = scope.to_numpy()
    for n in arrs:
        np.testing.assert_array_equal(back[n], arrs[n])
    _, _, loss = _fc_program(tfluid, TProgram, t_guard, t_unique)
    main = loss.block.program
    with pytest.raises(RuntimeError, match="startup program"):
        tfluid.Executor("cpu").run(
            main, feed={"x": np.zeros((2, 4), "float32"),
                        "y": np.zeros((2, 1), "float32")},
            fetch_list=[loss], scope=tfluid.Scope())


def test_unported_ops_raise():
    exe = tfluid.Executor("cpu")

    def run(build, feed):
        main, startup = TProgram(), TProgram()
        with t_guard(main, startup), t_unique.guard():
            out = build()
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            return exe.run(main, feed=feed, fetch_list=[out], sync=True)

    def l1_norm():
        helper = THelper("l1_norm")
        out = helper.create_variable_for_type_inference("float32",
                                                        shape=(1,))
        helper.append_op("l1_norm", {"X": [tfluid.layers.data("x", [4])]},
                         {"Out": [out]})
        return out

    # l1_norm (misc_ops) is not ported yet; gather and then scatter,
    # which this case used before, came with beam-search decoding and
    # the training rewrites
    with pytest.raises(KeyError, match="no lowering registered"):
        run(l1_norm, {"x": np.zeros((2, 4), "float32")})
    # a nested (lod_level 2) sequence_pool runs since the nested form
    # was ported: each sentence's first word here (inner lengths 1)
    w = np.arange(24, dtype="float32").reshape(2, 3, 4, 1)
    got, = run(lambda: tfluid.layers.sequence_pool(
        tfluid.layers.data("w", [1], lod_level=2), "sum"),
        {"w": w, "w@LEN": np.array([3, 2], "int64"),
         "w@LEN2": np.ones((2, 3), "int64")})
    np.testing.assert_array_equal(got, w[:, :, 0])
    # a sparse embedding runs (its gradient is a SelectedRows)
    run(lambda: tfluid.layers.embedding(
        tfluid.layers.data("ids", [1], dtype="int64"), [10, 4],
        is_sparse=True), {"ids": np.zeros((2, 1), "int64")})
