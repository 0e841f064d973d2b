"""``contrib.decoder.TrainingDecoder`` (over ``DynamicRNN``), the
``DynamicRNN`` layer's length masking, and the gradients of ``gather``
and ``expand`` on the port against the JAX reference, from the same
copied starting values (``tests/test_contrib_decoder.py``,
``tests/test_decode.py:210``).

Tolerances: ``DEC_LOSS_RTOL`` = 1e-5 for the loss; each gradient within
``DEC_GRAD_REL`` = 1e-4 of its max|ref| (float32 through a 6-step
recurrence, a softmax and Adam in two frameworks); the masked forward of
the DynamicRNN exactly (sums of ones); ``gather``/``expand`` gradients
within 1e-6 (sums of a few float32 terms in another order).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.contrib import decoder as j_decoder
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu_torch.contrib import decoder as t_decoder
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard

DEC_LOSS_RTOL = 1e-5
DEC_GRAD_REL = 1e-4
V, EMB, HID, T, B = 12, 16, 32, 6, 8
END_ID = 1
SIDES = {"ref": (jfluid, j_decoder, JProgram, j_guard, j_unique),
         "port": (tfluid, t_decoder, TProgram, t_guard, t_unique)}


def _train_program(fluid, dec, Program, guard, unique, adam=True):
    """tests/test_contrib_decoder.py:24: a sequence_pool encoder, a
    StateCell fc cell under TrainingDecoder, cross entropy."""
    L = fluid.layers
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 7
    with guard(main, startup), unique.guard():
        src = L.data("src", [1], dtype="int64", lod_level=1)
        tgt = L.data("tgt", [1], dtype="int64", lod_level=1)
        lbl = L.data("lbl", [T, 1], dtype="int64")
        enc = L.sequence_pool(L.embedding(
            src, [V, EMB], param_attr=fluid.ParamAttr(name="dec.src_emb")),
            "first")
        h0 = L.fc(enc, HID, act="tanh",
                  param_attr=fluid.ParamAttr(name="dec.h0.w"),
                  bias_attr=fluid.ParamAttr(name="dec.h0.b"))
        cell = dec.StateCell(inputs={"x": None},
                             states={"h": dec.InitState(init=h0)},
                             out_state="h")

        @cell.state_updater
        def updater(c):
            c.set_state("h", L.fc(
                L.concat([c.get_input("x"), c.get_state("h")], axis=1),
                HID, act="tanh",
                param_attr=fluid.ParamAttr(name="dec.cell.w"),
                bias_attr=fluid.ParamAttr(name="dec.cell.b")))

        decoder = dec.TrainingDecoder(cell)
        tgt_emb = L.embedding(tgt, [V, EMB],
                              param_attr=fluid.ParamAttr(name="dec.tgt_emb"))
        with decoder.block():
            cur = decoder.step_input(tgt_emb)
            decoder.state_cell.compute_state(inputs={"x": cur})
            score = L.fc(decoder.state_cell.get_state("h"), V,
                         act="softmax",
                         param_attr=fluid.ParamAttr(name="dec.out.w"),
                         bias_attr=fluid.ParamAttr(name="dec.out.b"))
            decoder.state_cell.update_states()
            decoder.output(score)
        loss = L.mean(L.cross_entropy(decoder(), lbl))
        if adam:
            fluid.optimizer.Adam(5e-3).minimize(loss)
        else:
            fluid.append_backward(loss)
    params = sorted(p.name for p in main.all_parameters())
    return main, startup, loss, params


def _toy_batch(seed, ragged=False):
    """tests/test_contrib_decoder.py:66's copy task; with ``ragged``
    the target rows end at 3..T tokens."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, V, (B, T)).astype("int64")
    tgt = np.zeros((B, T), "int64")
    lbl = np.zeros((B, T, 1), "int64")
    tgt[:, 1:] = src[:, :1]
    lbl[:, :-1, 0] = src[:, :1]
    lbl[:, -1, 0] = END_ID
    tlen = (rng.randint(3, T + 1, (B,)) if ragged
            else np.full((B,), T)).astype("int64")
    return {"src": src[..., None], "src@LEN": np.full((B,), T, "int64"),
            "tgt": tgt[..., None], "tgt@LEN": tlen, "lbl": lbl}


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_training_decoder_step_matches_reference(ragged):
    """One Adam step from copied starts: byte-identical programs (one
    dynamic_rnn and its grad), the loss and every parameter's gradient,
    the dec.cell.* ones only dynamic_rnn_grad reaches included, and the
    parameters after the step; with ragged target lengths the rows past
    their length are masked in both."""
    feed = _toy_batch(0, ragged)
    built = {k: _train_program(*v[:1], v[1], *v[2:]) for k, v in
             SIDES.items()}
    (jm, js, jl, params), (tm, _, tl, _) = built["ref"], built["port"]
    assert tm.serialize() == jm.serialize()
    types = [op.type for op in tm.global_block.ops]
    assert types.count("dynamic_rnn") == types.count("dynamic_rnn_grad") == 1
    fetch = [jl.name] + [p + "@GRAD" for p in params]
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(js)
        init = {v.name: np.array(scope.find_var(v.name))
                for v in jm.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        want = [np.asarray(w) for w in
                exe.run(jm, feed=feed, fetch_list=fetch, sync=True)]
        want_after = {p: np.array(scope.find_var(p)) for p in params}
    t_scope = tfluid.Scope()
    t_scope.load_numpy(init, device="cpu")
    n = t_lowering.grad_recomputes
    got = tfluid.Executor("cpu").run(tm, feed=feed, fetch_list=fetch,
                                     scope=t_scope, sync=True)
    assert t_lowering.grad_recomputes == n
    np.testing.assert_allclose(got[0], want[0], rtol=DEC_LOSS_RTOL)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        scale = np.abs(b).max()
        assert scale > 0, name
        assert np.abs(a - b).max() <= DEC_GRAD_REL * scale, name
    after = t_scope.to_numpy(params)
    for p in params:
        np.testing.assert_allclose(after[p], want_after[p],
                                   rtol=DEC_GRAD_REL, atol=1e-6, err_msg=p)


def test_state_cell_and_training_decoder_contract_errors():
    """tests/test_contrib_decoder.py:265 on the port."""
    L = tfluid.layers
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        x = L.data("x", [4])
        h0 = L.fc(x, 8)
        with pytest.raises(ValueError, match="out_state"):
            t_decoder.StateCell(inputs={"x": None},
                                states={"h": t_decoder.InitState(init=h0)},
                                out_state="missing")
        with pytest.raises(ValueError, match="InitState"):
            t_decoder.StateCell(inputs={"x": None}, states={"h": h0},
                                out_state="h")
        cell = t_decoder.StateCell(
            inputs={"x": None}, states={"h": t_decoder.InitState(init=h0)},
            out_state="h")
        with pytest.raises(ValueError, match="Invalid input"):
            cell.get_input("x")
        d = t_decoder.TrainingDecoder(cell)
        with pytest.raises(ValueError, match="inside block"):
            d.step_input(x)
        with pytest.raises(ValueError, match="already entered"):
            t_decoder.TrainingDecoder(cell)
        with pytest.raises(ValueError, match="outside the block"):
            d()


def test_dynamic_rnn_masks_by_length():
    """tests/test_decode.py:210: a cumulative-sum DynamicRNN over padded
    rows stops at each row's length, forward and gradient, against the
    reference and the exact values."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [1], lod_level=1)
        x.stop_gradient = False
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)
            mem = drnn.memory(shape=[1], batch_ref=x_t, init_value=0.0)
            new = L.elementwise_add(mem, x_t)
            drnn.update_memory(mem, new)
            drnn.output(new)
        seq = drnn()
        fluid.append_backward(L.mean(seq))
        return [seq.name, "x@GRAD"]

    feed = {"x": np.ones((2, 5, 1), "float32"),
            "x@LEN": np.array([2, 4], "int64")}
    outs = {}
    for key, (fluid, _, Program, guard, unique) in SIDES.items():
        main, startup = Program(), Program()
        with guard(main, startup), unique.guard():
            fetch = build(fluid)
        exe = (JExecutor() if key == "ref" else tfluid.Executor("cpu"))
        scope = JScope() if key == "ref" else tfluid.Scope()
        outs[key] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope, sync=True)]
        outs[key + "_prog"] = main.serialize()
    assert outs["port_prog"] == outs["ref_prog"]
    want = np.zeros((2, 5, 1), "float32")
    want[0, :2, 0] = [1, 2]
    want[1, :4, 0] = [1, 2, 3, 4]
    gwant = np.zeros((2, 5, 1), "float32")
    gwant[0, :2, 0] = [2, 1]
    gwant[1, :4, 0] = [4, 3, 2, 1]
    for key in ("ref", "port"):
        np.testing.assert_array_equal(outs[key][0], want)
        np.testing.assert_allclose(outs[key][1], gwant / want.size,
                                   rtol=1e-6)


@pytest.mark.parametrize("axis", [0, 1])
def test_gather_and_expand_gradients_match_reference(axis):
    """The explicit grad rules of gather (repeated indices sum in their
    order) and expand (sums over the tiles), against the reference's
    vjp of jnp.take and jnp.tile."""
    def build(fluid):
        L = fluid.layers
        x = L.data("x", [3, 4], append_batch_size=False,
                   stop_gradient=False)
        idx = L.data("idx", [5], append_batch_size=False, dtype="int64")
        helper = fluid.layer_helper.LayerHelper("gather")
        g = helper.create_variable_for_type_inference("float32")
        helper.append_op("gather", {"X": [x], "Index": [idx]},
                         {"Out": [g]}, {"axis": axis})
        e = L.expand(L.square(x), [2, 3])
        loss = L.elementwise_add(L.mean(L.square(g)), L.mean(e))
        fluid.append_backward(loss)
        return [loss.name, "x@GRAD"]

    rs = np.random.RandomState(axis)
    feed = {"x": rs.randn(3, 4).astype("float32"),
            "idx": np.array([2, 0, 2, 1, 2], "int64")}
    outs = {}
    for key, (fluid, _, Program, guard, unique) in SIDES.items():
        main, startup = Program(), Program()
        with guard(main, startup), unique.guard():
            fetch = build(fluid)
        exe = (JExecutor() if key == "ref" else tfluid.Executor("cpu"))
        scope = JScope() if key == "ref" else tfluid.Scope()
        outs[key] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope, sync=True)]
        outs[key + "_types"] = [op.type for op in main.global_block.ops]
    assert {"gather_grad", "expand_grad"} <= set(outs["port_types"])
    for a, b in zip(outs["port"], outs["ref"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
