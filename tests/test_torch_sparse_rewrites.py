"""The training rewrites over sparse tables: weight decay and gradient
clipping of a ``SelectedRows`` gradient (``lookup_table(is_sparse=
True)``).

- Port copies of the reference's ``tests/test_sparse.py`` cases: the
  sparse path trains the dense path's table under L2 decay and a
  global-norm clip, and rows never looked up keep their values, bit for
  bit, under both.
- The same programs, and the three programs that failed in the port
  before its ``clip``/``regularizer`` ops had rules (an fc over a sparse
  embedding, Adam; a global-norm clip; L2 decay of the sparse table; L1
  decay, dense and sparse), run 3 steps in both packages from one copied
  startup scope: losses and every persistable within 1e-5 relative, of
  the element or of the array's largest magnitude.
- With ``FLAGS_sparse_fused_kernel`` on (K9/K10's path; their plain
  versions on the CPU), DeepFM's two tables under L2 decay still update
  behind one sort a step: the decay's merge and the ``sum`` of gradient
  and decay share their row vectors through the run's memo.
- ``elementwise_mul``/``_div`` of a SelectedRows by a 0-d tensor (the
  global-norm clip's scaling of a sparse gradient), against the
  reference's rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import registry as j_registry
from paddle_tpu.core import unique_name as ju
from paddle_tpu.core.selected_rows import SelectedRows as JRows
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as t_registry
from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows
from paddle_tpu_torch.core import unique_name as tu
from paddle_tpu_torch.kernels import sparse as S

V, D = 50, 8
REL = 1e-5


def _close(got, want, rel=REL, err_msg=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale, err_msg=err_msg)


def _batches(steps, cover_all, seed=0):
    """The reference's _train feeds: with ``cover_all`` every row in
    every batch (60 slots over V=50 rows), else [3, 6] ids with a
    duplicate in each row."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        if cover_all:
            flat = np.concatenate([rng.permutation(V), rng.randint(0, V, 10)])
            idb = flat.reshape(10, 6).astype("int64")
            lb = rng.randn(10, 1).astype("float32")
        else:
            idb = rng.randint(0, V, (3, 6)).astype("int64")
            idb[:, 0] = idb[:, 1]
            lb = rng.randn(3, 1).astype("float32")
        out.append({"ids": idb, "label": lb})
    return out


def _build(fluid, is_sparse, opt, reg=None, clip=None, dense_reg=None):
    """The reference's _train model: a [V, D] table summed over 6 ids,
    an fc to one output, squared error."""
    ids = fluid.layers.data("ids", [6], dtype="int64")
    label = fluid.layers.data("label", [1])
    emb = fluid.layers.embedding(
        ids, [V, D], is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(
            name="emb.w", initializer=fluid.initializer.Uniform(-0.5, 0.5),
            regularizer=reg(fluid) if reg else None))
    pooled = fluid.layers.reduce_sum(emb, dim=1)
    pred = fluid.layers.fc(pooled, 1, param_attr=fluid.ParamAttr(
        name="fc.w", regularizer=dense_reg(fluid) if dense_reg else None))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, label))
    if clip is not None:
        fluid.clip.set_gradient_clip(clip(fluid))
    try:
        opt(fluid).minimize(loss)
    finally:
        fluid.clip.set_gradient_clip(None)
    return loss


def _persistables(prog):
    return sorted(v.name for v in prog.global_block.vars.values()
                  if v.persistable)


def _run(fluid, unique, kw, feeds, init=None, flag=False):
    """Build and run in one package; ``init`` (name -> array) replaces
    the startup's values.  Returns (losses, persistables, startup
    values, main)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), unique.guard():
        loss = _build(fluid, **kw)
    flags = jflags if fluid is jf else tflags
    exe = fluid.Executor() if fluid is jf else fluid.Executor("cpu")
    scope = fluid.Scope()
    flags.set_flags({"sparse_fused_kernel": flag})
    try:
        with fluid.scope_guard(scope):
            if init is None:
                exe.run(startup)
                init = {n: np.asarray(scope.find_var(n)).copy()
                        for n in _persistables(startup)}
            else:
                scope.load_numpy(init, device="cpu")
            losses = [float(np.asarray(exe.run(
                main, feed=f, fetch_list=[loss], sync=True)[0]))
                for f in feeds]
            state = {n: np.asarray(scope.find_var(n)).copy()
                     for n in _persistables(main)}
    finally:
        flags.set_flags({"sparse_fused_kernel": False})
    return losses, state, init, main


def _both(kw, feeds, flag=False):
    jl, js, init, jm = _run(jf, ju, kw, feeds, flag=flag)
    tl, ts, _, tm = _run(tf, tu, kw, feeds, init=init, flag=flag)
    assert tm.serialize() == jm.serialize()
    _close(tl, jl, err_msg="losses")
    assert sorted(ts) == sorted(js)
    for n in js:
        _close(ts[n], js[n], err_msg=n)
    return ts, init


ADAM = lambda f: f.optimizer.Adam(0.05)   # noqa: E731
L2 = lambda f: f.regularizer.L2Decay(0.05)   # noqa: E731
GNORM = lambda f: f.clip.GradientClipByGlobalNorm(0.7)   # noqa: E731


def test_sparse_parity_with_l2_and_global_norm_clip():
    """Port copy of the reference's test_sparse.py:131: the sparse path
    trains the dense path's table under L2 decay (lazy: every row is
    touched every step) and a global-norm clip."""
    feeds = _batches(4, cover_all=True)
    tables = []
    for is_sparse in (False, True):
        _, state, _, _ = _run(tf, tu, dict(is_sparse=is_sparse, opt=ADAM,
                                           reg=L2, clip=GNORM), feeds)
        tables.append(state["emb.w"])
    np.testing.assert_allclose(tables[1], tables[0], rtol=1e-5, atol=1e-6)


def _touch_program(fluid):
    ids = fluid.layers.data("ids", [4], dtype="int64")
    emb = fluid.layers.embedding(
        ids, [V, D], is_sparse=True, param_attr=fluid.ParamAttr(
            name="emb.w", regularizer=fluid.regularizer.L2Decay(0.1)))
    loss = fluid.layers.mean(emb)
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(0.5))
    try:
        fluid.optimizer.Adam(0.5).minimize(loss)
    finally:
        fluid.clip.set_gradient_clip(None)
    return loss


def test_sparse_update_touches_only_looked_up_rows():
    """Port copy of the reference's test_sparse.py:143, and the same
    program against the reference: rows never looked up keep their
    values under L2 decay and a global-norm clip, whose intermediate
    gradients stay SelectedRows end to end."""
    idb = np.array([[1, 2, 3, 1], [2, 4, 5, 5]], "int64")
    out = {}
    for fluid, unique in ((jf, ju), (tf, tu)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), unique.guard():
            loss = _touch_program(fluid)
        exe = fluid.Executor() if fluid is jf else fluid.Executor("cpu")
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            if fluid is jf:
                exe.run(startup)
                init = {n: np.asarray(scope.find_var(n)).copy()
                        for n in _persistables(startup)}
            else:
                scope.load_numpy(init, device="cpu")
            w0 = np.asarray(scope.find_var("emb.w")).copy()
            exe.run(main, feed={"ids": idb}, fetch_list=[loss], sync=True)
            out[fluid.__name__] = (w0, np.asarray(scope.find_var(
                "emb.w")).copy())
    types = {v.name: v.type for v in main.global_block.vars.values()}
    sparse = [n for n in types
              if n.startswith("emb.w@GRAD") and "SQSUM" not in n]
    assert len(sparse) >= 4 and all(
        types[n] == tf.core.types.VarType.SELECTED_ROWS for n in sparse), types
    touched = sorted(set(idb.ravel().tolist()))
    untouched = [i for i in range(V) if i not in touched]
    w0, w1 = out["paddle_tpu_torch"]
    assert not np.allclose(w1[touched], w0[touched]), "touched rows unchanged"
    np.testing.assert_array_equal(w1[untouched], w0[untouched])
    _close(w1, out["paddle_tpu"][1])


# the three programs that failed in the port at their first run before
# its clip/regularizer ops had rules (an fc over a sparse embedding,
# Adam), and the two reference programs above
PROGRAMS = {
    "global_norm_clip": dict(is_sparse=True, opt=ADAM,
                             clip=lambda f: f.clip.GradientClipByGlobalNorm(
                                 1.0)),
    "l2_sparse_table": dict(is_sparse=True, opt=ADAM,
                            reg=lambda f: f.regularizer.L2Decay(1e-4)),
    "l1_dense_and_sparse": dict(
        is_sparse=True, opt=ADAM,
        reg=lambda f: f.regularizer.L1Decay(1e-4),
        dense_reg=lambda f: f.regularizer.L1Decay(1e-4)),
    "l1_dense_table": dict(is_sparse=False, opt=ADAM,
                           reg=lambda f: f.regularizer.L1Decay(1e-4)),
    "l2_global_norm_sparse": dict(is_sparse=True, opt=ADAM, reg=L2,
                                  clip=GNORM),
    "l2_global_norm_momentum": dict(
        is_sparse=True, opt=lambda f: f.optimizer.Momentum(0.1, 0.9),
        reg=L2, clip=GNORM),
    "clip_by_value_sparse": dict(
        is_sparse=True, opt=lambda f: f.optimizer.Adagrad(0.1),
        clip=lambda f: f.clip.GradientClipByValue(0.01)),
    "clip_by_norm_sparse": dict(
        is_sparse=True, opt=lambda f: f.optimizer.SGD(0.1),
        clip=lambda f: f.clip.GradientClipByNorm(0.05)),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_reference_three_steps(name):
    _both(PROGRAMS[name], _batches(3, cover_all=False, seed=1))


@pytest.mark.parametrize("name", ["l2_sparse_table", "l2_global_norm_sparse"])
def test_fused_flag_matches_reference(name):
    """With FLAGS_sparse_fused_kernel on, the decayed (and clipped)
    SelectedRows go through the fused update in both packages (the
    reference's interpreted kernel, the port's plain K10)."""
    _both(PROGRAMS[name], _batches(3, cover_all=False, seed=2), flag=True)


def test_two_decayed_tables_update_behind_one_sort():
    """DeepFM at a small width, Adam with L2 decay and a global-norm
    clip, flag on: one sort a step for the two tables' fused updates
    (the decay's merge and the sum share their rows), the same tables
    as with the flag off."""
    from paddle_tpu_torch.models import deepfm
    rs = np.random.RandomState(0)
    feed = {"dense": rs.randn(16, 13).astype("float32"),
            "sparse": rs.randint(0, 200, (16, 26)).astype("int64"),
            "label": rs.randint(0, 2, (16, 1)).astype("float32")}
    tables = {}
    for flag in (True, False):
        main, startup = tf.Program(), tf.Program()
        main.random_seed = startup.random_seed = 3
        with tf.program_guard(main, startup), tu.guard():
            _, loss, _ = deepfm.build(sparse_dim=200, embed_dim=4,
                                      with_optimizer=False)
            tf.clip.set_gradient_clip(tf.clip.GradientClipByGlobalNorm(5.0))
            try:
                tf.optimizer.Adam(1e-2, regularization=tf.regularizer.L2Decay(
                    1e-4)).minimize(loss)
            finally:
                tf.clip.set_gradient_clip(None)
        exe, scope = tf.Executor("cpu"), tf.Scope()
        old = tflags.get_flags("sparse_dense_update_max_elems")
        tflags.set_flags({"sparse_fused_kernel": flag,
                          "sparse_dense_update_max_elems": 0})
        try:
            with tf.scope_guard(scope):
                exe.run(startup)
                w0 = scope.to_numpy(["ctr.sparse_emb"])["ctr.sparse_emb"]
                n0 = S.sorted_segments.launches
                for _ in range(3):
                    exe.run(main, feed=feed, fetch_list=[loss], sync=True)
                sorts = S.sorted_segments.launches - n0
                tables[flag] = scope.to_numpy(["ctr.sparse_emb",
                                               "ctr.sparse_w1"])
        finally:
            tflags.set_flags({"sparse_fused_kernel": False,
                              "sparse_dense_update_max_elems": old})
        if flag:
            assert sorts == 3, sorts
    for n in tables[True]:
        _close(tables[True][n], tables[False][n], err_msg=n)
    never = np.setdiff1d(np.arange(200), feed["sparse"])
    np.testing.assert_array_equal(tables[True]["ctr.sparse_emb"][never],
                                  w0[never])


def test_regularized_grad_of_a_sparse_table_is_selected_rows():
    """The decay's output and the sum with the gradient stay
    SELECTED_ROWS in the program (so the optimizer takes its lazy
    path), as the reference's regularizer declares them."""
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tu.guard():
        _build(tf, is_sparse=True, opt=ADAM, reg=L2)
    ops = [op.type for op in main.global_block.ops]
    assert "sparse_decay" in ops
    rows = tf.core.types.VarType.SELECTED_ROWS
    reg = [v for v in main.global_block.vars.values()
           if v.name.startswith("emb.w@GRAD@")]
    assert reg and all(v.type == rows for v in reg), [
        (v.name, v.type) for v in reg]


def _rows_pair(rows, vals, height):
    return (JRows(jnp.asarray(rows), jnp.asarray(vals), height),
            TRows(torch.from_numpy(rows), torch.from_numpy(vals), height))


@pytest.mark.parametrize("op", ["elementwise_mul", "elementwise_div"])
def test_selected_rows_times_a_scalar(op):
    """F2: ``elementwise_mul``/``_div`` of a SelectedRows X by a 0-d Y
    keep the rows (and the merged flag) and scale the values, as the
    reference's ``sparse_scalar_ok`` branch (``GradientClipByGlobalNorm``
    scales a sparse table's gradient so); a Y with a shape raises with
    the reference's message."""
    rows = np.array([4, 0, 4, 2], "int64")
    vals = np.random.RandomState(3).randn(4, 3).astype("float32")
    y = np.array(0.375, "float32")
    j, t = _rows_pair(rows, vals, 6)
    want = j_registry.get(op).lower(None, {"X": [j], "Y": [jnp.asarray(y)]},
                                    {})["Out"][0]
    got = t_registry.get(op).lower(None, {"X": [t], "Y": [
        torch.from_numpy(y)]}, {})["Out"][0]
    assert isinstance(got, TRows) and got.merged == want.merged is False
    assert got.height == want.height == 6
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    _close(got.values.numpy(), np.asarray(want.values), 1e-6)
    name = {"elementwise_mul": "multiply", "elementwise_div": "divide"}[op]
    for rule, x, yv in ((j_registry.get(op).lower, j, jnp.ones((3,))),
                        (t_registry.get(op).lower, t, torch.ones(3))):
        with pytest.raises(NotImplementedError,
                           match=f"elementwise op '{name}.*SelectedRows"):
            rule(None, {"X": [x], "Y": [yv]}, {})


def test_elementwise_add_refuses_selected_rows():
    """Only mul/div may skip a SelectedRows' absent (zero) rows."""
    _, t = _rows_pair(np.array([1], "int64"), np.ones((1, 2), "float32"), 3)
    with pytest.raises(NotImplementedError, match="SelectedRows"):
        t_registry.get("elementwise_add").lower(
            None, {"X": [t], "Y": [torch.tensor(1.0)]}, {})
