"""Training DeepFM's sparse embeddings through ``models.deepfm.build`` →
``Adam.minimize`` → ``Executor.run``: the port against the JAX reference
from the same copied starting values, with ``FLAGS_sparse_fused_kernel``
off (the masked-dense update) and on (the K9 gather and the K10 update,
whose plain versions the CPU runs).

DeepFM at the reference's own analysis size (sparse_dim 512, B=8, 26
fields, MLP 400-400-400) with the bench configuration's Adam lr 1e-4.  The reference builds the program;
the port runs ``Program.deserialize`` of it (and builds a byte-identical
one itself).  Tolerances: the loss and every dense gradient within 1e-5
relative after one step, with an absolute floor of 1e-6 of the
parameter's largest gradient for entries that cancel to near zero
(float32 GEMMs through a 3-layer MLP in two frameworks), the sparse
gradients' rows equal and values within the same bound; after 3 Adam
steps the tables and all their moments within rtol 1e-5 / atol 1e-6 of
the reference's.  Within the port, flag-on and
flag-off tables within rtol 1e-6 / atol 1e-7 (the reference's own bound
for the two paths, ``tests/test_sparse.py``).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import deepfm as j_deepfm
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.kernels import sparse as TS
from paddle_tpu_torch.models import deepfm as t_deepfm

ROWS, B, STEPS = 512, 8, 3
LR = 1e-4                   # the bench configuration's (bench.py)
TABLES = ("ctr.sparse_emb", "ctr.sparse_w1")


def _feed():
    rs = np.random.RandomState(0)
    sparse = rs.randint(0, ROWS, (B, 26)).astype("int64")
    sparse[:, 1] = sparse[:, 0]          # in-batch duplicates
    return {"dense": rs.rand(B, 13).astype("float32"), "sparse": sparse,
            "label": (rs.rand(B, 1) > 0.5).astype("float32")}


def _build(Program, guard, unique, module):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 3
    with guard(main, startup), unique.guard():
        _, loss, _ = module.build(sparse_dim=ROWS, lr=LR)
    params = sorted(p.name for p in main.all_parameters())
    persist = sorted(v.name for v in startup.global_block.vars.values()
                     if v.persistable)
    return main, startup, loss, params, persist


def _reference(flag):
    jflags.set_flags({"sparse_fused_kernel": flag})
    try:
        main, startup, loss, params, persist = _build(
            JProgram, j_guard, j_unique, j_deepfm)
        fetch = [loss.name] + [p + "@GRAD" for p in params]
        exe, scope = JExecutor(), JScope()
        with j_scope_guard(scope):
            exe.run(startup)
            init = {n: np.array(scope.find_var(n)) for n in persist}
            steps = [exe.run(main, feed=_feed(), fetch_list=fetch,
                             return_numpy=False) for _ in range(STEPS)]
            final = {n: np.array(scope.find_var(n)) for n in persist}
    finally:
        jflags.set_flags({"sparse_fused_kernel": False})
    return dict(init=init, params=params, persist=persist, steps=steps,
                final=final, program=main.serialize(), loss=loss.name)


def _port(ref, flag):
    main = TProgram.deserialize(ref["program"])
    fetch = [ref["loss"]] + [p + "@GRAD" for p in ref["params"]]
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    scope.load_numpy(ref["init"], device="cpu")
    recomputes = t_lowering.grad_recomputes
    launches = (TS.fused_gather.launches, TS.rowwise_update.launches)
    sorts = TS.sorted_segments.launches
    tflags.set_flags({"sparse_fused_kernel": flag})
    try:
        with tfluid.scope_guard(scope):
            steps = [exe.run(main, feed=_feed(), fetch_list=fetch)
                     for _ in range(STEPS)]
    finally:
        tflags.set_flags({"sparse_fused_kernel": False})
    # no forward re-run; the CPU takes the plain versions, not K9/K10
    assert t_lowering.grad_recomputes == recomputes
    assert (TS.fused_gather.launches, TS.rowwise_update.launches) == \
        launches
    # the two tables' updates share one sort of the step's ids
    assert TS.sorted_segments.launches - sorts == (STEPS if flag else 0)
    return dict(steps=steps, final=scope.to_numpy(ref["persist"]))


def _table_state(names):
    """The two tables and their Adam moments and powers.  The MLP's
    weights are left out: Adam's first step is about lr * sign(g) for a
    gradient entry near zero, so float noise of 1e-9 in such an entry
    (two frameworks' GEMM orders) moves it by up to lr."""
    names = [n for n in names if n.startswith(TABLES)]
    assert len(names) == 2 * 5
    return names


@pytest.fixture(scope="module")
def runs():
    out = {}
    for flag in (False, True):
        ref = _reference(flag)
        out[flag] = (ref, _port(ref, flag))
    return out


def test_same_program():
    """The port's layers (embedding(is_sparse), square, elementwise_sub,
    concat, sigmoid_cross_entropy_with_logits) build the reference's
    programs byte for byte."""
    j = _build(JProgram, j_guard, j_unique, j_deepfm)
    t = _build(TProgram, t_guard, t_unique, t_deepfm)
    assert t[0].serialize() == j[0].serialize()
    assert t[1].serialize() == j[1].serialize()
    assert t[3] == j[3] and t[4] == j[4]
    types = [op.type for op in t[0].global_block.ops]
    assert types.count("lookup_table") == 2
    assert types.count("lookup_table_grad") == 2
    assert types.count("adam") == len(t[3])


@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "flag_on"])
def test_first_step_loss_and_gradients_match(runs, flag):
    ref, got = runs[flag]
    np.testing.assert_allclose(got["steps"][0][0],
                               np.asarray(ref["steps"][0][0]), rtol=1e-5)
    for name, a, b in zip(ref["params"], got["steps"][0][1:],
                          ref["steps"][0][1:]):
        if name in TABLES:
            assert isinstance(a, SelectedRows) and a.height == ROWS
            np.testing.assert_array_equal(a.rows.numpy(),
                                          np.asarray(b.rows))
            a, b = a.values.numpy(), b.values
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "flag_on"])
def test_three_adam_steps_match(runs, flag):
    ref, got = runs[flag]
    np.testing.assert_allclose([float(s[0]) for s in got["steps"]],
                               [float(np.asarray(s[0]))
                                for s in ref["steps"]], rtol=1e-5)
    for name in _table_state(ref["persist"]):
        np.testing.assert_allclose(got["final"][name], ref["final"][name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in TABLES:
        assert not np.array_equal(got["final"][name], ref["init"][name])
        # lazy: rows the batch never looked up are untouched
        seen = np.unique(_feed()["sparse"])
        untouched = np.setdiff1d(np.arange(ROWS), seen)
        np.testing.assert_array_equal(got["final"][name][untouched],
                                      ref["init"][name][untouched])


def test_flag_on_and_off_agree_in_the_port(runs):
    on, off = runs[True][1]["final"], runs[False][1]["final"]
    for name in _table_state(on):
        np.testing.assert_allclose(on[name], off[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def _two_table_program(fluid, Program, guard, unique, adam_lr):
    """The reference suite's two-table model (tests/test_sparse.py)."""
    prog, startup = Program(), Program()
    prog.random_seed = startup.random_seed = 5
    with guard(prog, startup), unique.guard():
        ids = fluid.layers.data("ids", [5], dtype="int64")
        label = fluid.layers.data("label", [1])
        emb = fluid.layers.embedding(
            ids, [50, 8], is_sparse=True,
            param_attr=fluid.ParamAttr(
                name="t.emb", initializer=fluid.initializer.Uniform(-.5, .5)))
        emb1 = fluid.layers.embedding(
            ids, [50, 1], is_sparse=True,
            param_attr=fluid.ParamAttr(
                name="t.w1", initializer=fluid.initializer.Uniform(-.5, .5)))
        pooled = fluid.layers.reduce_sum(emb, dim=1)
        first = fluid.layers.reduce_sum(emb1, dim=1)
        pred = fluid.layers.fc(pooled, 1,
                               param_attr=fluid.ParamAttr(name="t.fc"))
        pred = fluid.layers.elementwise_add(pred, first)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, label))
        fluid.optimizer.Adam(adam_lr).minimize(loss)
    persist = sorted(v.name for v in startup.global_block.vars.values()
                     if v.persistable)
    return prog, startup, loss, persist


@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "flag_on"])
def test_two_table_program_trains_like_the_reference(flag):
    rng = np.random.RandomState(7)
    feed = {"ids": rng.randint(0, 50, (3, 5)).astype("int64"),
            "label": rng.randn(3, 1).astype("float32")}
    feed["ids"][:, 0] = feed["ids"][:, 1]
    jprog, jstart, jloss, persist = _two_table_program(
        jfluid, JProgram, j_guard, j_unique, 0.01)
    tprog, _, tloss, _ = _two_table_program(tfluid, TProgram, t_guard,
                                            t_unique, 0.01)
    assert tprog.serialize() == jprog.serialize()
    exe, scope = JExecutor(), JScope()
    jflags.set_flags({"sparse_fused_kernel": flag})
    tflags.set_flags({"sparse_fused_kernel": flag})
    try:
        with j_scope_guard(scope):
            exe.run(jstart)
            init = {n: np.array(scope.find_var(n)) for n in persist}
            want = [float(np.asarray(exe.run(jprog, feed=feed,
                                             fetch_list=[jloss])[0]))
                    for _ in range(4)]
            final = {n: np.array(scope.find_var(n)) for n in persist}
        tscope = tfluid.Scope()
        tscope.load_numpy(init, device="cpu")
        texe = tfluid.Executor("cpu")
        got = [float(texe.run(tprog, feed=feed, fetch_list=[tloss],
                              scope=tscope)[0]) for _ in range(4)]
    finally:
        jflags.set_flags({"sparse_fused_kernel": False})
        tflags.set_flags({"sparse_fused_kernel": False})
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, val in tscope.to_numpy(persist).items():
        np.testing.assert_allclose(val, final[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
