"""The LoD machinery on the port against the JAX reference: the nine LoD
op types (``lod_rank_table``, ``max_sequence_len``,
``reorder_lod_tensor_by_rank``, ``lod_tensor_to_array``,
``array_to_lod_tensor``, ``shrink_rnn_memory``, ``split_lod_tensor``,
``merge_lod_tensor``, ``lod_array_length``), their layers and
``IfElse``, forward and gradients, and the ``LoDTensor``/``DataFeeder``
copies (``tests/test_lod_machinery.py``).

Each program is built by both packages (byte-identical), run on the same
feed from the same copied start, and compared: the ops move, select and
zero values, so their forwards and the integer outputs must be equal
exactly; gradients within ``LOD_GRAD_TOL`` (float32 sums in two
frameworks).
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
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard

LOD_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _parity(build, feed):
    """``build(fluid) -> fetch names`` under each package (the programs
    must serialize identically); returns (reference, port) fetches."""
    out = {}
    for key, fluid, Program, guard, unique in (
            ("ref", jfluid, JProgram, j_guard, j_unique),
            ("port", tfluid, TProgram, t_guard, t_unique)):
        main, startup = Program(), Program()
        main.random_seed = startup.random_seed = 5
        with guard(main, startup), unique.guard():
            fetch = build(fluid)
        out[key] = (main, startup, fetch)
    (jm, js, fetch), (tm, ts, _) = out["ref"], out["port"]
    assert tm.serialize() == jm.serialize()
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(js)
        init = {p.name: np.array(scope.find_var(p.name))
                for p in jm.all_parameters()}
        want = exe.run(jm, feed=feed, fetch_list=fetch, sync=True)
    t_scope = tfluid.Scope()
    t_scope.load_numpy(init, device="cpu")
    got = tfluid.Executor("cpu").run(tm, feed=feed, fetch_list=fetch,
                                     scope=t_scope, sync=True)
    return [np.asarray(w) for w in want], got


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_rank_table_reorder_and_max_sequence_len():
    """tests/test_lod_machinery.py:23, with a tie (two rows of length 3)
    kept in their original order."""
    lens = np.array([2, 5, 3, 3], "int64")
    x = np.arange(4 * 5 * 2, dtype="float32").reshape(4, 5, 2)

    def build(fluid):
        d = fluid.layers.data("x", [5, 2], lod_level=1)
        table = fluid.layers.lod_rank_table(d)
        re = fluid.layers.reorder_lod_tensor_by_rank(d, table)
        mlen = fluid.layers.max_sequence_len(table)
        return [table.rank_idx.name, table.rank_len.name, re.name,
                mlen.name, fluid.layers.nn.seq_len_var(re).name]

    want, got = _parity(build, {"x": x, "x@LEN": lens})
    _equal(got, want)
    np.testing.assert_array_equal(got[0], [1, 2, 3, 0])
    np.testing.assert_array_equal(got[2], x[[1, 2, 3, 0]])
    np.testing.assert_array_equal(got[4], lens[[1, 2, 3, 0]])
    assert int(got[3].reshape(())) == 5


def test_lod_tensor_array_round_trip_and_lengths():
    """tests/test_lod_machinery.py:43 and :61: the array holds the rank
    order, ``array_to_lod_tensor`` is the exact inverse and gives the
    lengths back in the original row order (a sequence_pool after it
    masks with them); ``lod_array_length`` reads the array's length."""
    lens = np.array([2, 4, 1], "int64")
    x = np.arange(3 * 4 * 3, dtype="float32").reshape(3, 4, 3)

    def build(fluid):
        L = fluid.layers
        d = L.data("x", [4, 3], lod_level=1)
        table = L.lod_rank_table(d)
        arr = L.lod_tensor_to_array(d, table)
        back = L.array_to_lod_tensor(arr, table)
        step0 = L.array_read(arr, L.fill_constant([1], "int64", 0))
        pooled = L.sequence_pool(back, "sum")
        helper = fluid.layer_helper.LayerHelper("lod_array_length")
        n = helper.create_variable_for_type_inference("int64", shape=(1,))
        helper.append_op("lod_array_length",
                         {"ArrayLen": [arr.name + "@ALEN"]}, {"Out": [n]})
        return [back.name, step0.name, pooled.name, n.name,
                L.nn.seq_len_var(back).name]

    want, got = _parity(build, {"x": x, "x@LEN": lens})
    _equal(got[:2] + got[3:], want[:2] + want[3:])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], x[[1, 0, 2], 0])
    np.testing.assert_array_equal(got[4], lens)
    assert int(got[3][0]) == 4


def test_shrink_memory_masks_finished_rows():
    """tests/test_lod_machinery.py:80: at step 1 the two sequences
    longer than 1 keep their (rank-ordered) memory rows."""
    def build(fluid):
        d = fluid.layers.data("x", [5], lod_level=1)
        m = fluid.layers.data("mem", [4])
        table = fluid.layers.lod_rank_table(d)
        i = fluid.layers.fill_constant([1], "int64", 1)
        return [fluid.layers.shrink_memory(m, i, table).name]

    want, got = _parity(build, {"x": np.zeros((3, 5), "float32"),
                                "x@LEN": np.array([1, 3, 2], "int64"),
                                "mem": np.ones((3, 4), "float32")})
    _equal(got, want)
    np.testing.assert_array_equal(got[0], [[1] * 4, [1] * 4, [0] * 4])


def test_split_merge_and_ifelse():
    """tests/test_lod_machinery.py:98 and :116: split zeroes the other
    side's rows, merge is its exact inverse, IfElse runs both blocks on
    the full batch and merges row-wise."""
    x = np.arange(12, dtype="float32").reshape(4, 3)
    mask = np.array([[1], [0], [1], [0]], "bool")

    def split(fluid):
        d = fluid.layers.data("x", [3])
        m = fluid.layers.data("m", [1], dtype="bool")
        t, f = fluid.layers.split_lod_tensor(d, m)
        merged = fluid.layers.merge_lod_tensor(t, f, d, m)
        return [t.name, f.name, merged.name]

    want, got = _parity(split, {"x": x, "m": mask})
    _equal(got, want)
    np.testing.assert_array_equal(got[2], x)

    def ifelse(fluid):
        L = fluid.layers
        d = L.data("x", [1])
        cond = L.less_than(d, L.fill_constant([4, 1], "float32", 2.5))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(ie.input(d), scale=10.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(d), scale=-1.0))
        return [o.name for o in ie()]

    want, got = _parity(ifelse, {"x": np.array([[1.0], [2.0], [3.0], [4.0]],
                                               "float32")})
    _equal(got, want)
    np.testing.assert_array_equal(got[0], [[10.0], [20.0], [-3.0], [-4.0]])


def test_lod_op_gradients_match_reference():
    """Gradients through reorder, the array round trip, shrink_memory
    and an IfElse, into a fed sequence and a parameter: each LoD op is
    differentiated by the port's tape, the reference's by jax.vjp."""
    rs = np.random.RandomState(0)
    x = rs.randn(3, 4, 2).astype("float32")
    lens = np.array([2, 4, 3], "int64")

    def build(fluid):
        L = fluid.layers
        d = L.data("x", [2], lod_level=1, stop_gradient=False)
        table = L.lod_rank_table(d)
        h = L.fc(L.reorder_lod_tensor_by_rank(d, table), 2,
                 num_flatten_dims=2,
                 param_attr=fluid.ParamAttr(name="lod.w"), bias_attr=False)
        arr = L.lod_tensor_to_array(h, table)
        back = L.array_to_lod_tensor(arr, table)
        mem = L.shrink_memory(L.reduce_sum(back, dim=1),
                              L.fill_constant([1], "int64", 2), table)
        cond = L.less_than(L.reduce_sum(mem, dim=1, keep_dim=True),
                           L.fill_constant([3, 1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(ie.input(mem), scale=3.0))
        with ie.false_block():
            ie.output(L.square(ie.input(mem)))
        (out,) = ie()
        loss = L.mean(out)
        fluid.append_backward(loss)
        return [loss.name, out.name, "x@GRAD", "lod.w@GRAD"]

    want, got = _parity(build, {"x": x, "x@LEN": lens})
    for name, a, b in zip(("loss", "out", "x@GRAD", "lod.w@GRAD"), got,
                          want):
        np.testing.assert_allclose(a, b, err_msg=name, **LOD_GRAD_TOL)
    assert np.abs(got[2]).max() > 0 and np.abs(got[3]).max() > 0


def _nested_corpus():
    """tests/test_lod_machinery.py:134: 2 samples, sample0 = 2 sentences
    (3, 1 words), sample1 = 1 sentence (2 words); 2-d word vectors."""
    words = np.arange(12, dtype=np.float32).reshape(6, 2) + 1.0
    return words, [2, 1], [3, 1, 2]


def test_lod_tensor_apis_match_reference():
    """create_lod_tensor at level 1 and 2 (packed rows, row lists, and
    re-lod of a LoDTensor), recursive_sequence_lengths, lod, the padded
    data and lengths, create_random_int_lodtensor's shapes, and the
    reference's errors (tests/test_lod_machinery.py:143, :224)."""
    words, outer, inner = _nested_corpus()
    for data, lens in ((words, [outer, inner]),
                       ([[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]], [[2, 1, 3]]),
                       (words, [[2, 4]])):
        a = jfluid.create_lod_tensor(data, lens, None)
        b = tfluid.create_lod_tensor(data, lens, None)
        assert b.recursive_sequence_lengths() == \
            a.recursive_sequence_lengths() == [list(v) for v in lens]
        assert b.lod() == a.lod() and b.shape() == a.shape()
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.seq_lens, a.seq_lens)
        if a.inner_lens is not None:
            np.testing.assert_array_equal(b.inner_lens, a.inner_lens)
        again = tfluid.create_lod_tensor(b, lens, None)
        np.testing.assert_array_equal(again.data, b.data)
    lt = tfluid.create_lod_tensor(words, [outer, inner], None)
    assert lt.lod() == [[0, 2, 3], [0, 3, 4, 6]]
    assert tfluid.Tensor is tfluid.LoDTensor
    r = tfluid.create_random_int_lodtensor([[2, 3]], [1], None, 0, 9)
    assert r.data.shape == jfluid.create_random_int_lodtensor(
        [[2, 3]], [1], None, 0, 9).data.shape
    with pytest.raises(ValueError, match="level-1 and level-2"):
        tfluid.create_lod_tensor([[1.0]], [[1], [1], [1]], None)
    with pytest.raises(ValueError, match="sum\\(lens\\)"):
        tfluid.create_lod_tensor(np.zeros((3, 1)), [[1, 1]], None)


def _feeder(fluid, Program, guard, unique, lod_level):
    main, startup = Program(), Program()
    with guard(main, startup), unique.guard():
        d = fluid.layers.data("doc", [2], lod_level=lod_level)
        return fluid.DataFeeder(feed_list=[d], program=main)


FEEDER_CASES = {
    "level1": (1, [(np.arange(6.0).reshape(3, 2),),
                   (np.arange(4.0).reshape(2, 2),)]),
    # tests/test_lod_machinery.py:299: [[s0 (3 words), s1 (1 word)],
    # [s0 (2 words)]], and a zero-word sentence
    "level2": (2, [([np.arange(6.0).reshape(3, 2), np.ones((1, 2))],),
                   ([np.zeros((2, 2))],), ([np.ones((2, 2)), []],)]),
    # tests/test_lod_machinery.py:329: every sentence empty
    "level2_all_empty": (2, [([[], []],), ([[]],)]),
}


@pytest.mark.parametrize("case", sorted(FEEDER_CASES))
def test_data_feeder_matches_reference(case):
    """DataFeeder.feed gives the reference's keys, shapes, dtypes and
    values: level 1 ([B, T, ...] + @LEN), level 2 ([B, S, W, ...] +
    @LEN/@LEN2, bit-identical to the LoDTensor path), and a batch whose
    sentences are all empty keeps the declared feature shape."""
    level, batch = FEEDER_CASES[case]
    want = _feeder(jfluid, JProgram, j_guard, j_unique, level).feed(batch)
    got = _feeder(tfluid, TProgram, t_guard, t_unique, level).feed(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if level == 2:
        assert got["doc"].ndim == 4 and got["doc"].shape[-1] == 2
