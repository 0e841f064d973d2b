"""Beam search's op rules on the port against the reference's, on the
same seeded numpy inputs: ``log``, ``less_than``, ``expand``,
``gather``, ``array_write``/``array_read``, ``beam_search`` and
``beam_search_decode``; then the inference ``while`` through
``Executor.run``, and the programs that machine translation's
``mode="infer"`` and ``contrib.decoder.BeamSearchDecoder.decode()``
build, byte for byte.

Tolerances: ``log`` within 1e-6 relative (two libms; -inf at 0 and at
subnormal inputs in both), everything else
exactly: comparisons, copies, indexing, and ``beam_search``'s selection
(a stable descending sort against ``lax.top_k``, ties included) and
``beam_search_decode``'s backtrack.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.contrib import decoder as j_decoder
from paddle_tpu.core import registry as j_registry
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import machine_translation as j_mt
from paddle_tpu_torch.contrib import decoder as t_decoder
from paddle_tpu_torch.core import registry as t_registry
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.models import machine_translation as t_mt


def _both(op, ins, attrs):
    """Every output slot of the reference's rule and of the port's, as
    numpy arrays, on the same inputs."""
    jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
    tins = {k: [torch.from_numpy(np.array(v))] for k, v in ins.items()}
    want = j_registry.get(op).lower(None, jins, attrs)
    got = t_registry.get(op).lower(None, tins, attrs)
    assert sorted(got) == sorted(want)
    return ({s: np.asarray(v[0]) for s, v in want.items()},
            {s: v[0].numpy() for s, v in got.items()})


def _same(want, got):
    for slot in want:
        assert got[slot].shape == want[slot].shape, slot
        assert got[slot].dtype == want[slot].dtype, slot
        np.testing.assert_array_equal(got[slot], want[slot], err_msg=slot)


def test_log_matches_reference_with_zero_and_tiny():
    """-inf at 0 and at a subnormal input, which the reference's XLA
    treats as zero: log(softmax) gives -inf in both packages where a
    probability underflows."""
    x = np.random.RandomState(0).rand(4, 7).astype("float32")
    x[0, :3] = [0.0, 1e-38, 1.0]
    want, got = _both("log", {"X": x}, {})
    assert got["Out"][0, 0] == -np.inf and want["Out"][0, 0] == -np.inf
    np.testing.assert_allclose(got["Out"], want["Out"], rtol=1e-6)


@pytest.mark.parametrize("yshape,axis", [((3, 4), -1), ((1,), -1),
                                         ((3,), 0)])
def test_less_than_matches_reference(yshape, axis):
    rs = np.random.RandomState(1)
    x = rs.randint(0, 5, (3, 4)).astype("int64")
    y = rs.randint(0, 5, yshape).astype("int64")
    want, got = _both("less_than", {"X": x, "Y": y}, {"axis": axis})
    assert got["Out"].dtype == np.bool_
    _same(want, got)


@pytest.mark.parametrize("shape,times", [((2, 3), [1, 4]),
                                         ((2, 1, 3), [1, 5, 1]),
                                         ((3,), [2])])
def test_expand_matches_reference(shape, times):
    x = np.random.RandomState(2).randn(*shape).astype("float32")
    _same(*_both("expand", {"X": x}, {"expand_times": times}))


@pytest.mark.parametrize("ishape,axis", [((5,), 0), ((2, 3), 0), ((4,), 1)])
def test_gather_matches_reference(ishape, axis):
    rs = np.random.RandomState(3)
    x = rs.randn(6, 5, 2).astype("float32")
    index = rs.randint(0, x.shape[axis], ishape).astype("int64")
    _same(*_both("gather", {"X": x, "Index": index}, {"axis": axis}))


@pytest.mark.parametrize("i,length,x_dtype", [(2, 0, "float32"),
                                              (0, 3, "float32"),
                                              (4, 5, "int64"),
                                              (3, 1, "float64")])
def test_array_write_and_read_match_reference(i, length, x_dtype):
    """The written slot and the length max(length, i+1), the value cast
    to the array's dtype; the other slots untouched; the read of the
    written slot."""
    rs = np.random.RandomState(4)
    arr = rs.randn(6, 3).astype("float32")
    x = (rs.randint(-9, 9, (3,)) if x_dtype == "int64"
         else rs.randn(3)).astype(x_dtype)
    ins = {"Array": arr, "X": x, "I": np.array([i], "int64"),
           "ArrayLen": np.array([length], "int64")}
    want, got = _both("array_write", ins, {})
    _same(want, got)
    assert got["LenOut"][0] == max(length, i + 1)
    np.testing.assert_array_equal(got["Out"][i], x.astype("float32"))
    read_w, read_g = _both("array_read", {"Array": got["Out"],
                                          "I": np.array([i], "int64")}, {})
    _same(read_w, read_g)


def test_array_write_leaves_its_input_unchanged():
    """array_write is out of place: the While layer's @INIT snapshot of
    a carried array must not change when the loop writes the array."""
    arr = torch.zeros(4, 2)
    out = t_registry.get("array_write").lower(
        None, {"Array": [arr], "X": [torch.ones(2)],
               "I": [torch.tensor([1])], "ArrayLen": [torch.tensor([0])]},
        {})
    assert not arr.any() and out["Out"][0][1].eq(1).all()


def _beam_case(name):
    """(PreIds, PreScores, Ids, Scores, beam, end_id) for each case."""
    rs = np.random.RandomState(5)
    if name == "finished_beam":      # tests/test_decode.py:276's case
        beam, k, b, end_id = 3, 4, 2, 0
        bw = b * beam
        pre_ids = rs.randint(0, 7, size=(bw, 1)).astype("int64")
        pre_ids[1, 0] = end_id
        pre_scores = rs.randn(bw, 1).astype("float32")
        ids = rs.randint(1, 7, size=(bw, k)).astype("int64")
        scores = rs.randn(bw, k).astype("float32")
        return pre_ids, pre_scores, ids, scores, beam, end_id
    beam, k, b, end_id = 3, 4, 2, 2
    bw = b * beam
    pre_ids = np.full((bw, 1), 1, "int64")
    ids = np.tile(np.arange(k, dtype="int64") + 3, (bw, 1))
    if name == "exact_ties":
        pre_scores = np.zeros((bw, 1), "float32")
        scores = np.round(rs.randn(bw, k), 1).astype("float32")
        scores[0, 1] = scores[0, 2] = scores[2, 0] = scores[3, 3] = 2.5
    elif name in ("neg_inf_seed", "neg_1e9_seed"):
        seed = -np.inf if name == "neg_inf_seed" else -1e9
        pre_scores = np.tile(np.array([[0.0], [seed], [seed]], "float32"),
                             (b, 1))
        scores = np.tile(rs.randn(1, k).astype("float32"), (bw, 1)) \
            + pre_scores
    elif name == "all_finished":
        pre_ids[:, 0] = end_id
        pre_scores = rs.randn(bw, 1).astype("float32")
        scores = rs.randn(bw, k).astype("float32")
    else:                             # two groups, one beam finished
        pre_ids[4, 0] = end_id
        pre_scores = rs.randn(bw, 1).astype("float32")
        scores = (rs.randn(bw, k) + pre_scores).astype("float32")
    return pre_ids, pre_scores, ids, scores, beam, end_id


@pytest.mark.parametrize("case", ["finished_beam", "exact_ties",
                                  "neg_inf_seed", "neg_1e9_seed",
                                  "all_finished", "two_groups"])
def test_beam_search_equals_reference_exactly(case):
    pre_ids, pre_scores, ids, scores, beam, end_id = _beam_case(case)
    ins = {"PreIds": pre_ids, "PreScores": pre_scores, "Ids": ids,
           "Scores": scores}
    want, got = _both("beam_search", ins,
                      {"beam_size": beam, "end_id": end_id})
    _same(want, got)
    if case == "neg_inf_seed":
        # only beam 0 of each group expands: its K candidates, then the
        # -inf ties in index order
        assert (got["ParentIdx"].reshape(2, beam)[:, 0]
                == [0, beam]).all()


def _decode_inputs(t_max, length, rs):
    bw, end_id = 6, 2
    ids = rs.randint(0, 5, (t_max, bw)).astype("int64")
    ids[1, 3] = end_id
    parents = np.stack([rs.permutation(bw) // 3 * 3 + rs.randint(0, 3, bw)
                        for _ in range(t_max)]).astype("int64")
    scores = rs.randn(t_max, bw).astype("float32")
    return ids, parents, scores, np.array([length], "int64"), end_id


@pytest.mark.parametrize("length", [7, 4, 1])
@pytest.mark.parametrize("with_scores", [True, False])
def test_beam_search_decode_equals_reference_exactly(length, with_scores):
    """Backtrack with ArrayLen at and below T_max (steps past it give
    end_id and keep the pointer), with and without SentenceScores."""
    ids, parents, scores, alen, end_id = _decode_inputs(
        7, length, np.random.RandomState(6))
    ins = {"Ids": ids, "Parents": parents, "ArrayLen": alen}
    if with_scores:
        ins["Scores"] = scores
    want, got = _both("beam_search_decode", ins,
                      {"end_id": end_id, "beam_size": 3})
    assert ("SentenceScores" in got) == with_scores
    _same(want, got)
    assert (got["SentenceLen"] <= length).all()


def _while_program(fluid, Program, guard, unique, max_iters):
    """s += x.sum() while i < n, one increment of i an iteration; n is
    fed, so the condition decides when the loop stops unless max_iters
    caps it first."""
    L = fluid.layers
    main, startup = Program(), Program()
    with guard(main, startup), unique.guard():
        x = L.data("x", [4])
        n = L.data("n", [1], dtype="int64", append_batch_size=False)
        s = L.fill_constant([1], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        arr = L.create_array("float32", [1], max_len=8)
        cond = L.less_than(i, n)
        with L.While(cond, max_iters=max_iters).block():
            L.assign(L.elementwise_add(s, L.reduce_sum(x)), s)
            L.array_write(s, i, arr)
            L.increment(i, 1)
            L.less_than(i, n, cond=cond)
        length = L.array_length(arr)
        last = L.array_read(arr, L.fill_constant([1], "int64", 0))
    return main, [s.name, i.name, arr.name, length.name, last.name]


@pytest.mark.parametrize("max_iters,n", [(None, 5), (3, 5), (8, 2)])
def test_inference_while_matches_reference(max_iters, n):
    """The inference while, with and without max_iters; with 3 < n the
    cap binds and the loop stops at 3 iterations."""
    j_main, fetch = _while_program(jfluid, JProgram, j_guard, j_unique,
                                   max_iters)
    t_main, t_fetch = _while_program(tfluid, TProgram, t_guard, t_unique,
                                     max_iters)
    assert t_main.serialize() == j_main.serialize() and t_fetch == fetch
    feed = {"x": np.random.RandomState(7).randn(2, 4).astype("float32"),
            "n": np.array([n], "int64")}
    want = JExecutor(training=False).run(j_main, feed=feed,
                                         fetch_list=fetch, scope=JScope())
    got = tfluid.Executor("cpu", training=False).run(
        t_main, feed=feed, fetch_list=fetch, scope=tfluid.Scope())
    iters = min(n, max_iters or n)
    assert int(got[1][0]) == iters and int(got[3][0]) == iters
    for name, a, b in zip(fetch, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                   err_msg=name)


def _mt_infer(Program, guard, unique, module):
    main, startup = Program(), Program()
    with guard(main, startup), unique.guard():
        module.build(src_vocab=50, tgt_vocab=60, emb_dim=32, hid=24,
                     max_len=8, beam_size=3, mode="infer")
    return main, startup


def test_mt_infer_program_is_the_references():
    """mt.build(mode="infer"): the same ops (types, slots, attrs) and
    vars (shapes, dtypes), the while sub-block included, byte for byte."""
    j_main, j_start = _mt_infer(JProgram, j_guard, j_unique, j_mt)
    t_main, t_start = _mt_infer(TProgram, t_guard, t_unique, t_mt)
    assert t_main.serialize() == j_main.serialize()
    assert t_start.serialize() == j_start.serialize()
    top = [op.type for op in t_main.global_block.ops]
    assert top.count("gru") == 2 and top.count("while") == 1
    assert top[-1] == "beam_search_decode"
    body = [op.type for op in t_main.blocks[1].ops]
    assert body.count("beam_search") == 1 and body.count("array_write") == 3


def _beam_search_decoder(fluid, decoder, Program, guard, unique):
    """contrib.decoder's StateCell + BeamSearchDecoder on the machine
    translation decoder pattern (tests/test_contrib_decoder.py:181)."""
    L = fluid.layers
    V, EMB, HID, T, beam = 12, 16, 32, 6, 3
    main, startup = Program(), Program()
    with guard(main, startup), unique.guard():
        src = L.data("src", [1], dtype="int64", lod_level=1)
        src_emb = L.embedding(
            src, [V, EMB], param_attr=fluid.ParamAttr(name="dec.src_emb"))
        enc = L.sequence_pool(src_emb, "first")
        h0 = L.fc(enc, HID, act="tanh",
                  param_attr=fluid.ParamAttr(name="dec.h0.w"),
                  bias_attr=fluid.ParamAttr(name="dec.h0.b"))
        cell = decoder.StateCell(inputs={"x": None},
                                 states={"h": decoder.InitState(init=h0)},
                                 out_state="h")

        @cell.state_updater
        def updater(c):
            c.set_state("h", L.fc(
                L.concat([c.get_input("x"), c.get_state("h")], axis=1), HID,
                act="tanh", param_attr=fluid.ParamAttr(name="dec.cell.w"),
                bias_attr=fluid.ParamAttr(name="dec.cell.b")))

        init_ids = L.data("init_ids", [1], dtype="int64")
        init_scores = L.data("init_scores", [1])
        dec = decoder.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=V, word_dim=EMB, topk_size=V, sparse_emb=False,
            max_len=T, beam_size=beam, end_id=1,
            emb_param_attr=fluid.ParamAttr(name="dec.tgt_emb"),
            score_param_attr=fluid.ParamAttr(name="dec.out.w"),
            score_bias_attr=fluid.ParamAttr(name="dec.out.b"))
        dec.decode()
    return main, startup


def test_beam_search_decoder_program_is_the_references():
    """BeamSearchDecoder.decode(): the same program, the carried state
    made in the parent block before the While (the frozen-state fix,
    reference contrib/decoder.py:362-373)."""
    j_main, j_start = _beam_search_decoder(jfluid, j_decoder, JProgram,
                                           j_guard, j_unique)
    t_main, t_start = _beam_search_decoder(tfluid, t_decoder, TProgram,
                                           t_guard, t_unique)
    assert t_main.serialize() == j_main.serialize()
    assert t_start.serialize() == j_start.serialize()
    (wop,) = [op for op in t_main.global_block.ops if op.type == "while"]
    carried = [n for n in wop.attr("carry_vars")
               if n.startswith("assign")]
    assert carried, wop.attr("carry_vars")


def test_while_grad_is_not_ported():
    """A bounded while's gradient (``while_grad``, the reference's vjp
    over its masked scan; ported since) where the forward ran in its
    inference form (an inference executor): the tape of the iterations
    that ran gives x@GRAD = 2 (two trips) / 2 (the mean) per element."""
    L = tfluid.layers
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        x = L.data("x", [4], stop_gradient=False)
        s = L.fill_constant([1], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        cond = L.less_than(i, n)
        with L.While(cond, max_iters=2).block():
            L.assign(L.elementwise_add(s, L.reduce_sum(x)), s)
            L.increment(i, 1)
            L.less_than(i, n, cond=cond)
        tfluid.append_backward(L.mean(s))
    assert "while_grad" in [op.type for op in main.global_block.ops]
    (g,) = tfluid.Executor("cpu", training=False).run(
        main, feed={"x": np.ones((2, 4), "float32")},
        fetch_list=["x@GRAD"], scope=tfluid.Scope())
    np.testing.assert_array_equal(g, np.full((2, 4), 2.0, "float32"))
