"""Beam-search inference of machine translation on the port against the
JAX reference: the oracle's flow (tests/test_model_zoo.py:27) at its
small size (vocab 50, emb = hid = 32, T = 8, beam 3).

The reference trains a few Adam steps and saves its parameters with
``io.save_params``; both packages build ``mode="infer"`` (byte for
byte the same program), load that directory with their own
``io.load_params`` and beam-decode the first source sentence, once with
a full mask and once ragged.  The ids and candidate lengths must be
equal and the scores within rtol 1e-5.  The reference also decodes
along the port's path: each step's ``beam_search`` computes the
reference's own selection, then hands on the port's, with the
reference's own scores for it.  At every step the reference's scores
for the port's picks must equal its own selected scores within 1e-5 |s|
(where the two select differently, a near tie on the reference's own
scores), and the port's selected scores must equal the reference's for
the same picks within rtol 1e-5 at every step.  On
the CPU the encoder's two ``gru`` ops run K8a's plain version
(``gru_fused`` -> ``gru_ref``) and launch no kernel; no grad op is in
the program, so K8b is never reached.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jfluid
from chip_smoke import judge_beam_step
from paddle_tpu.core import registry as j_registry
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import machine_translation as j_mt
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import rnn as TR
from paddle_tpu_torch.models import machine_translation as t_mt

V, T, B, BEAM = 50, 8, 4, 3
SMALL = dict(src_vocab=V, tgt_vocab=V, emb_dim=32, hid=32, max_len=T)
TRAIN_STEPS = 5
SCORE_RTOL = 1e-5
TIE_REL = 1e-5


def _train_feed():
    rng = np.random.RandomState(0)
    src = rng.randint(3, V, (B, T)).astype("int64")
    tgt = np.concatenate([np.full((B, 1), 1), src[:, :-1] % V],
                         axis=1).astype("int64")
    return {"src_ids": src, "src_mask": np.ones((B, T), "float32"),
            "tgt_ids": tgt, "lbl_ids": src,
            "tgt_mask": np.ones((B, T), "float32")}


def _infer(Program, guard, unique, module):
    """(main, startup, fetch): the decode's ids, scores, lengths, source
    lengths and final beam scores, then the per-step Ids, Parents and
    Scores arrays."""
    main, startup = Program(), Program()
    with guard(main, startup), unique.guard():
        _, decode, scores = module.build(beam_size=BEAM, mode="infer",
                                         **SMALL)
    (bsd,) = [op for op in main.global_block.ops
              if op.type == "beam_search_decode"]
    return main, startup, [decode.ids.name, decode.scores.name,
                           decode.cand_len.name, decode.src_len.name,
                           scores.name] + [
        bsd.input(s)[0] for s in ("Ids", "Parents", "Scores")]


@contextlib.contextmanager
def _reference_along(sel_ids, sel_parents, judged):
    """Run the reference eagerly with its ``beam_search`` rule computing
    its own selection at step t, judging the port's (``sel_ids[t]``,
    ``sel_parents[t]``) on its own scores, and handing on the port's
    picks with its own scores for them; (step, differs, gap) go to
    ``judged``."""
    opdef = j_registry.get("beam_search")
    rule = opdef.lower

    def forced(ctx, ins, attrs):
        t = len(judged)
        outs = rule(ctx, ins, attrs)
        own = [np.asarray(outs[s][0]).reshape(-1)
               for s in ("SelectedIds", "ParentIdx", "SelectedScores")]
        ids = np.asarray(sel_ids[t]).reshape(-1)
        par = np.asarray(sel_parents[t]).reshape(-1)
        scores, gap, differs = judge_beam_step(
            {k: np.asarray(v[0]) for k, v in ins.items()},
            int(attrs["beam_size"]), int(attrs["end_id"]), own, (ids, par))
        judged.append((t, differs, gap))
        like = {k: outs[k][0] for k in outs}
        return {"SelectedIds": [jnp.asarray(ids.reshape(
                    like["SelectedIds"].shape), like["SelectedIds"].dtype)],
                "SelectedScores": [jnp.asarray(scores.reshape(
                    like["SelectedScores"].shape),
                    like["SelectedScores"].dtype)],
                "ParentIdx": [jnp.asarray(par, like["ParentIdx"].dtype)]}

    opdef.lower = forced
    try:
        with jax.disable_jit():
            yield
    finally:
        opdef.lower = rule


def _infer_feeds():
    src = _train_feed()["src_ids"][:1]
    seed = np.array([[0.0]] + [[-1e9]] * (BEAM - 1), "float32")
    iota = np.tile(np.arange(V, dtype="int64"), (BEAM, 1))
    ragged = (np.arange(T) < 5).astype("float32")[None]
    return {name: {"src_ids": src, "src_mask": mask, "cand_ids": iota,
                   "beam_seed": seed}
            for name, mask in (("full", np.ones((1, T), "float32")),
                               ("ragged", ragged))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mt") / "params")
    train, startup = JProgram(), JProgram()
    with j_guard(train, startup), j_unique.guard():
        _, loss = j_mt.build(mode="train", lr=5e-3, **SMALL)
    exe, scope = JExecutor(), JScope()
    exe.run(startup, scope=scope)
    for _ in range(TRAIN_STEPS):
        exe.run(train, feed=_train_feed(), fetch_list=[loss], scope=scope)
    with j_scope_guard(scope):
        jfluid.io.save_params(exe, ckpt, main_program=train)

    j_main, j_start, fetch = _infer(JProgram, j_guard, j_unique, j_mt)
    jscope = JScope()
    exe.run(j_start, scope=jscope)
    with j_scope_guard(jscope):
        jfluid.io.load_params(exe, ckpt, main_program=j_main)
    want = {k: [np.asarray(v) for v in
                exe.run(j_main, feed=f, fetch_list=fetch, scope=jscope)]
            for k, f in _infer_feeds().items()}

    t_main, t_start, t_fetch = _infer(TProgram, t_guard, t_unique, t_mt)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    texe.run(t_start, scope=tscope)
    with tfluid.scope_guard(tscope):
        tfluid.io.load_params(texe, ckpt, main_program=t_main)
    plain_calls = []
    gru_ref = TR.gru_ref

    def counted(*a, **k):
        plain_calls.append(a[0].shape)
        return gru_ref(*a, **k)

    launches = (TR.gru_fused.launches, TR.gru_fused_grad.launches)
    TR.gru_ref = counted
    try:
        got = {k: texe.run(t_main, feed=f, fetch_list=t_fetch, scope=tscope)
               for k, f in _infer_feeds().items()}
    finally:
        TR.gru_ref = gru_ref
    launches = tuple(b - a for a, b in zip(
        launches, (TR.gru_fused.launches, TR.gru_fused_grad.launches)))
    along, judged = {}, {}
    for k, f in _infer_feeds().items():
        judged[k] = []
        with _reference_along(got[k][5], got[k][6], judged[k]):
            along[k] = [np.asarray(v) for v in exe.run(
                j_main, feed=f, fetch_list=fetch, scope=jscope)]
    return dict(want=want, got=got, along=along, judged=judged,
                fetch=fetch, t_fetch=t_fetch,
                programs=(j_main.serialize(), t_main.serialize()),
                plain_calls=plain_calls, launches=launches)


def test_infer_program_is_the_references(runs):
    j_prog, t_prog = runs["programs"]
    assert t_prog == j_prog and runs["t_fetch"] == runs["fetch"]


@pytest.mark.parametrize("mask", ["full", "ragged"])
def test_beam_decode_matches_reference(runs, mask):
    want, along = runs["want"][mask], runs["along"][mask]
    ids, scores, cand_len, src_len, pre_scores = runs["got"][mask][:5]
    steps = runs["got"][mask][7]
    assert ids.shape == (BEAM, T) and scores.shape == (BEAM, T)
    assert np.isfinite(scores).all() and (ids >= 0).all() and (ids < V).all()
    # along the port's path, each step judged on the reference's scores
    judged = runs["judged"][mask]
    assert [t for t, _, _ in judged] == list(range(T))
    for t, differs, gap in judged:
        assert gap <= TIE_REL, (
            f"step {t}: the port selects differently and it is no near "
            f"tie on the reference's scores ({gap} of |s|)")
    np.testing.assert_array_equal(ids, along[0])
    np.testing.assert_array_equal(cand_len, along[2])
    np.testing.assert_allclose(steps, along[7], rtol=SCORE_RTOL)
    if any(d for _, d, _ in judged):
        return
    # the same selections at every step: the reference's own decode
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(cand_len, want[2])
    np.testing.assert_array_equal(src_len, [BEAM])
    np.testing.assert_allclose(scores, want[1], rtol=SCORE_RTOL)
    np.testing.assert_allclose(pre_scores, want[4], rtol=SCORE_RTOL)
    # beams are score-ordered (tests/test_model_zoo.py:59)
    assert pre_scores[0, 0] >= pre_scores[1, 0] >= pre_scores[2, 0]


def test_encoder_runs_k8a_plain_version_and_launches_nothing(runs):
    """Two gru ops a decode, each K8a's plain version at B=1 (CPU
    tensors), and no K8a/K8b launch."""
    assert runs["plain_calls"] == [(1, T, 3 * SMALL["hid"])] * 4
    assert runs["launches"] == (0, 0)
