"""The book models (``models/book.py``) through ``layers.*`` ->
``SGD.minimize`` -> ``Executor.run``: the port against the JAX
reference from the same copied starting values, at the sizes of
``tests/test_book_models.py``.

For each of the five cases (fit_a_line, word2vec dense and sparse,
recommender, label_semantic_roles): the port builds the reference's
programs byte for byte; the first step's loss and every dense
parameter gradient agree (loss 1e-5 relative, gradients 1e-4 relative
and 2e-6 absolute, as the other training parities: float32 in two
frameworks); the losses of a few SGD steps agree at 1e-4 relative and
the parameters after them at 1e-5 absolute.  SRL's LSTM stack (four ops
at this size) runs the plain K6/K7 versions on the CPU, so their launch
counters do not move; its ``emb`` table is ``trainable=False`` and stays bit for bit
as it was copied.  Sparse word2vec looks ``shared_w`` up four times, so
its gradient reaches ``sum`` as four ``SelectedRows``: it must match the
dense program and the reference.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import book as j_book
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import rnn as TR
from paddle_tpu_torch.models import book as t_book

STEPS = 4
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
PARAM_ATOL = 1e-5


def _w2v_feed(B, V):
    def feed(rs):
        return {n: rs.randint(0, V, (B, 1)).astype("int64")
                for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")}
    return feed


def _fit_feed(rs):
    w_true = np.arange(1, 14, dtype="float32") / 13.0
    x = rs.randn(64, 13).astype("float32")
    return {"x": x, "y": (x @ w_true)[:, None].astype("float32")}


def _rec_feed(rs):
    B = 32
    return {
        "user_id": rs.randint(0, 100, (B, 1)).astype("int64"),
        "gender_id": rs.randint(0, 2, (B, 1)).astype("int64"),
        "age_id": rs.randint(0, 7, (B, 1)).astype("int64"),
        "job_id": rs.randint(0, 21, (B, 1)).astype("int64"),
        "movie_id": rs.randint(0, 200, (B, 1)).astype("int64"),
        "category_id": rs.randint(0, 19, (B, 4, 1)).astype("int64"),
        "category_id@LEN": rs.randint(1, 5, (B,)).astype("int64"),
        "movie_title": rs.randint(0, 500, (B, 10, 1)).astype("int64"),
        "movie_title@LEN": rs.randint(3, 11, (B,)).astype("int64"),
        "score": rs.randint(1, 6, (B, 1)).astype("float32"),
    }


def _srl_feed(rs):
    B, T = 8, 20
    lens = rs.randint(5, T + 1, (B,)).astype("int64")
    lens[0] = 1
    d = {}
    for n in ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
              "ctx_p1_data", "ctx_p2_data"):
        d[n] = rs.randint(0, 100, (B, T, 1)).astype("int64")
        d[n + "@LEN"] = lens
    d["verb_data"] = rs.randint(0, 20, (B, T, 1)).astype("int64")
    d["mark_data"] = rs.randint(0, 2, (B, T, 1)).astype("int64")
    d["target"] = rs.randint(0, 15, (B, T, 1)).astype("int64")
    for n in ("verb_data", "mark_data", "target"):
        d[n + "@LEN"] = lens
    return d


# name: (build function, kwargs, feed)
CASES = {
    "fit_a_line": ("build_fit_a_line", dict(lr=0.03), _fit_feed),
    "word2vec": ("build_word2vec", dict(dict_size=200, hidden_size=64,
                                        lr=0.05), _w2v_feed(64, 200)),
    "word2vec_sparse": ("build_word2vec", dict(
        dict_size=100, hidden_size=32, lr=0.05, is_sparse=True),
        _w2v_feed(32, 100)),
    "recommender": ("build_recommender", dict(lr=0.05), _rec_feed),
    "label_semantic_roles": ("build_label_semantic_roles", dict(lr=0.02),
                             _srl_feed),
}


def _build(Program, guard, unique, module, case):
    fn, kw, _ = CASES[case]
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 3
    with guard(main, startup), unique.guard():
        feeds, loss, _ = getattr(module, fn)(**kw)
    params = sorted(p.name for p in main.all_parameters())
    # dense gradients only: a sparse table's is a SelectedRows
    grads = [p for p in params if p + "@GRAD" in main.global_block.vars
             and not (kw.get("is_sparse") and p == "shared_w")]
    persist = [v.name for v in startup.global_block.vars.values()
               if v.persistable]
    return dict(main=main, startup=startup, feeds=feeds, loss=loss,
                params=params, grads=grads, persist=persist)


def _feed(case):
    return CASES[case][2](np.random.RandomState(0))


def _reference(case):
    b = _build(JProgram, j_guard, j_unique, j_book, case)
    fetch = [b["loss"].name] + [p + "@GRAD" for p in b["grads"]]
    exe, scope = JExecutor(), JScope()
    feed = _feed(case)
    assert set(feed) == set(b["feeds"])
    with j_scope_guard(scope):
        exe.run(b["startup"])
        init = {n: np.array(scope.find_var(n)) for n in b["persist"]}
        steps = [[np.array(x) for x in exe.run(b["main"], feed=feed,
                                               fetch_list=fetch, sync=True)]
                 for _ in range(STEPS)]
        final = {n: np.array(scope.find_var(n)) for n in b["params"]}
    return dict(init=init, steps=steps, final=final, grads=b["grads"],
                params=b["params"],
                program=(b["main"].serialize(), b["startup"].serialize()))


def _port(case, init):
    b = _build(TProgram, t_guard, t_unique, t_book, case)
    fetch = [b["loss"].name] + [p + "@GRAD" for p in b["grads"]]
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    scope.load_numpy(init, device="cpu")
    counts = (t_lowering.grad_recomputes, TR.lstm_fused.launches,
              TR.lstm_fused_grad.launches)
    feed = _feed(case)
    with tfluid.scope_guard(scope):
        steps = [[np.asarray(x) for x in exe.run(b["main"], feed=feed,
                                                 fetch_list=fetch, sync=True)]
                 for _ in range(STEPS)]
    return dict(steps=steps, final=scope.to_numpy(b["params"]),
                counts=(counts, (t_lowering.grad_recomputes,
                                 TR.lstm_fused.launches,
                                 TR.lstm_fused_grad.launches)),
                types=[op.type for op in b["main"].global_block.ops],
                program=(b["main"].serialize(), b["startup"].serialize()))


_RUNS = {}


def _runs(case):
    if case not in _RUNS:
        ref = _reference(case)
        _RUNS[case] = (ref, _port(case, ref["init"]))
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_same_program(case):
    """The port's layers (fc, embedding, sums, dynamic_lstm, the
    sequence and CRF layers, cos_sim, nets.sequence_conv_pool) build the
    reference's programs byte for byte."""
    ref, got = _runs(case)
    assert got["program"] == ref["program"]


@pytest.mark.parametrize("case", list(CASES))
def test_first_step_loss_and_gradients_match(case):
    ref, got = _runs(case)
    np.testing.assert_allclose(got["steps"][0][0], ref["steps"][0][0],
                               rtol=1e-5)
    assert ref["grads"], case
    for name, a, b in zip(ref["grads"], got["steps"][0][1:],
                          ref["steps"][0][1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sgd_steps_match_from_copied_starts(case):
    ref, got = _runs(case)
    losses = [float(s[0]) for s in got["steps"]]
    np.testing.assert_allclose(losses, [float(s[0]) for s in ref["steps"]],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(losses)), losses
    # no grad op re-ran its forward
    assert got["counts"][0][0] == got["counts"][1][0]
    for name in ref["params"]:
        np.testing.assert_allclose(got["final"][name], ref["final"][name],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_srl_runs_eight_lstm_ops_on_their_plain_versions():
    """SRL builds its LSTM stack of ``depth`` ops (4 at the test's size)
    and, on the CPU, runs them without a K6/K7 launch; the frozen
    ``emb`` table is left exactly as it was copied."""
    ref, got = _runs("label_semantic_roles")
    assert got["types"].count("lstm") == 4
    assert got["types"].count("lstm_grad") == 4
    assert got["types"].count("linear_chain_crf") == 1
    assert got["types"].count("crf_decoding") == 1
    (_, f0, g0), (_, f1, g1) = got["counts"]
    assert (f1 - f0, g1 - g0) == (0, 0)
    np.testing.assert_array_equal(got["final"]["emb"], ref["init"]["emb"])
    np.testing.assert_array_equal(ref["final"]["emb"], ref["init"]["emb"])
    assert not np.array_equal(got["final"]["crfw"], ref["init"]["crfw"])


def test_word2vec_sparse_matches_dense_and_reference():
    """Sparse word2vec's four ``SelectedRows`` gradients of ``shared_w``
    meet in ``sum`` (the row concatenation of the reference's rule):
    the port's sparse run matches its own dense run from the same start
    and the reference's sparse run."""
    ref, sparse = _runs("word2vec_sparse")
    assert "sum" in sparse["types"]
    b = _build(TProgram, t_guard, t_unique, t_book, "word2vec_sparse")
    _, kw, feed_fn = CASES["word2vec_sparse"]
    main, startup = TProgram(), TProgram()
    main.random_seed = startup.random_seed = 3
    with t_guard(main, startup), t_unique.guard():
        _, loss, _ = t_book.build_word2vec(**dict(kw, is_sparse=False))
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    scope.load_numpy(ref["init"], device="cpu")
    feed = feed_fn(np.random.RandomState(0))
    with tfluid.scope_guard(scope):
        dense = [float(np.asarray(exe.run(main, feed=feed,
                                          fetch_list=[loss.name],
                                          sync=True)[0]))
                 for _ in range(STEPS)]
    np.testing.assert_allclose([float(s[0]) for s in sparse["steps"]],
                               dense, rtol=1e-5)
    np.testing.assert_allclose(sparse["final"]["shared_w"],
                               scope.to_numpy(["shared_w"])["shared_w"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sparse["final"]["shared_w"],
                               ref["final"]["shared_w"], atol=PARAM_ATOL,
                               rtol=0)
    assert b["params"] == ref["params"]
