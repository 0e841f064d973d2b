"""``Executor.run_steps``, the deferred fetches (``LazyFetch``, ``sync=``)
and the LoD feed shim on the port, against the JAX reference and against
the port's own ``run`` (``tests/test_executor.py:143, :197, :222, :269,
:301``).

Tolerances: the reference against the port within ``STEPS_RTOL`` = 1e-5
(the reference's own ``run_steps`` bar, float32 through a few optimizer
steps in two frameworks); the port's ``run_steps`` against K of its own
``run`` calls, and a deferred fetch against a synced one, bit for bit
(the same ops on the same values).
"""
import sys
import threading

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
from paddle_tpu_torch.core.executor import RNG_STATE_VAR, LazyFetch
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard

STEPS_RTOL = 1e-5
K = 6


def _momentum(fluid):
    """tests/test_executor.py:143's program."""
    x = fluid.layers.data("x", [5])
    y = fluid.layers.data("y", [1])
    p = fluid.layers.fc(x, 1, param_attr=fluid.ParamAttr(name="w"))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
    fluid.optimizer.Momentum(0.05, 0.9).minimize(loss)
    return loss


def _dropout(fluid):
    """A program that draws from the scope's generator every step."""
    x = fluid.layers.data("x", [5])
    y = fluid.layers.data("y", [1])
    h = fluid.layers.dropout(fluid.layers.fc(
        x, 8, act="relu", param_attr=fluid.ParamAttr(name="h.w")), 0.3)
    p = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(name="w"))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
    fluid.optimizer.Adam(0.01).minimize(loss)
    return loss


def _stacked(seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(K, 8, 5).astype("float32")
    return {"x": xs, "y": xs.sum(2, keepdims=True).astype("float32")}


def _port(build, seed=11):
    main, startup = TProgram(), TProgram()
    main.random_seed = startup.random_seed = seed
    with t_guard(main, startup), t_unique.guard():
        loss = build(tfluid)
    return main, startup, loss


def _persistables(main, scope):
    return {v.name: np.array(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


def test_run_steps_matches_reference_run_steps():
    """The reference's run_steps (one lax.scan) and the port's from
    copied starts: the K stacked losses and the parameter."""
    feed = _stacked()
    jm, js = JProgram(), JProgram()
    jm.random_seed = 11
    with j_guard(jm, js), j_unique.guard():
        jl = _momentum(jfluid)
    scope, exe = JScope(), JExecutor()
    with j_scope_guard(scope):
        exe.run(js)
        init = _persistables(jm, scope)
        (want,) = exe.run_steps(jm, feed=feed, fetch_list=[jl.name])
        want_w = np.array(scope.find_var("w"))
    main, _, loss = _port(_momentum)
    assert main.serialize() == jm.serialize()
    t_scope = tfluid.Scope()
    t_scope.load_numpy(init, device="cpu")
    (got,) = tfluid.Executor("cpu").run_steps(
        main, feed=feed, fetch_list=[loss.name], scope=t_scope)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL)
    np.testing.assert_allclose(t_scope.to_numpy(["w"])["w"], want_w,
                               rtol=STEPS_RTOL)


@pytest.mark.parametrize("build", [_momentum, _dropout],
                         ids=["momentum", "dropout"])
def test_run_steps_equals_k_runs_bit_for_bit(build):
    """K steps in one run_steps call against K run calls from the same
    start: every stacked fetch, every persistable after the last step
    and the generator's next draw, bit for bit (the dropout program
    draws from the scope's generator each step)."""
    feed = _stacked(3)
    main, startup, loss = _port(build)
    exe = tfluid.Executor("cpu")
    start = tfluid.Scope()
    exe.run(startup, scope=start)
    init = start.to_numpy()
    fetch = [loss.name, "w@GRAD"]

    one = tfluid.Scope()
    one.load_numpy(init, device="cpu")
    steps = [exe.run(main, feed={n: v[i] for n, v in feed.items()},
                     fetch_list=fetch, scope=one, sync=True)
             for i in range(K)]
    many = tfluid.Scope()
    many.load_numpy(init, device="cpu")
    stacked = exe.run_steps(main, feed=feed, fetch_list=fetch, scope=many)
    for j, name in enumerate(fetch):
        assert stacked[j].shape == (K,) + steps[0][j].shape
        np.testing.assert_array_equal(
            stacked[j], np.stack([s[j] for s in steps]), err_msg=name)
    a, b = _persistables(main, one), _persistables(main, many)
    assert sorted(a) == sorted(b) and a
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    if build is _dropout:
        ga, gb = one.find_var(RNG_STATE_VAR), many.find_var(RNG_STATE_VAR)
        assert ga is not None and gb is not None
        np.testing.assert_array_equal(ga.get_state().numpy(),
                                      gb.get_state().numpy())


def test_run_steps_errors_match_reference():
    """The reference's errors: a LoDTensor feed is TypeError, feeds that
    disagree on K and an empty feed are ValueError."""
    lt = tfluid.create_lod_tensor([[1.0], [2.0, 3.0]], [[1, 2]], None)
    jl = jfluid.create_lod_tensor([[1.0], [2.0, 3.0]], [[1, 2]], None)
    bad = {"x": np.zeros((3, 8, 5), "float32"),
           "y": np.zeros((2, 8, 1), "float32")}
    jm, js = JProgram(), JProgram()
    with j_guard(jm, js), j_unique.guard():
        _momentum(jfluid)
    main, startup, _ = _port(_momentum)
    for exe, prog, lod in ((JExecutor(), jm, jl),
                           (tfluid.Executor("cpu"), main, lt)):
        with pytest.raises(TypeError, match="LoDTensor"):
            exe.run_steps(prog, feed={"x": lod})
        with pytest.raises(ValueError, match="disagree"):
            exe.run_steps(prog, feed=bad)
        with pytest.raises(ValueError, match="at least one"):
            exe.run_steps(prog, feed={})


def _sgd(fluid):
    """tests/test_executor.py:222's program, with a reshaped view of the
    parameter fetched under another name."""
    x = fluid.layers.data("x", [4])
    y = fluid.layers.data("y", [1])
    p = fluid.layers.fc(x, 1, param_attr=fluid.ParamAttr(name="w"))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
    w_flat = fluid.layers.reshape(
        fluid.default_main_program().global_block.var("w"), [-1])
    fluid.optimizer.SGD(0.1).minimize(loss)
    return loss, w_flat


def _sgd_feeds(n=5):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        xb = rng.randn(8, 4).astype("float32")
        out.append({"x": xb, "y": xb.sum(1, keepdims=True)
                    .astype("float32")})
    return out


def test_deferred_fetches_match_synced_and_reference():
    """tests/test_executor.py:222: run() defers its fetches by default;
    nothing is read before the first access, which reads every pending
    fetch in one batch; the values equal sync=True's bit for bit and the
    reference's within STEPS_RTOL; the ndarray surface (ufuncs,
    float(), indexing, format, repr, shape/dtype without a read)."""
    feeds = _sgd_feeds()
    jm, js = JProgram(), JProgram()
    jm.random_seed = 5
    with j_guard(jm, js), j_unique.guard():
        jl, _ = _sgd(jfluid)
    scope, exe = JScope(), JExecutor()
    with j_scope_guard(scope):
        exe.run(js)
        init = _persistables(jm, scope)
        want = [exe.run(jm, feed=f, fetch_list=[jl.name], sync=True)[0]
                for f in feeds]
    main, _, (loss, _) = _port(_sgd, seed=5)
    assert main.serialize() == jm.serialize()
    out = {}
    for sync in (False, True):
        t_scope = tfluid.Scope()
        t_scope.load_numpy(init, device="cpu")
        exe = tfluid.Executor("cpu")
        out[sync] = [exe.run(main, feed=f, fetch_list=[loss.name],
                             scope=t_scope, sync=sync)[0] for f in feeds]
    lazy, plain = out[False], out[True]
    assert all(isinstance(v, LazyFetch) and v.pending for v in lazy)
    assert all(type(v) is np.ndarray for v in plain)
    assert lazy[0].shape == plain[0].shape and lazy[0].dtype == np.float32
    assert lazy[0].ndim == plain[0].ndim and lazy[0].size == plain[0].size
    assert all(v.pending for v in lazy)          # metadata read nothing
    batches = LazyFetch.batches
    assert float(lazy[0]) == float(plain[0])
    assert LazyFetch.batches == batches + 1
    assert not any(v.pending for v in lazy)      # one batch read them all
    np.testing.assert_array_equal(np.asarray(lazy), np.asarray(plain))
    np.testing.assert_allclose(np.asarray(plain), np.asarray(want),
                               rtol=STEPS_RTOL)
    assert float(lazy[-1]) < float(lazy[0])
    assert f"{lazy[1]:.3f}" == f"{float(plain[1]):.3f}"
    assert repr(lazy[1]) == repr(plain[1]) and str(lazy[1]) == str(plain[1])
    np.testing.assert_array_equal(np.sqrt(lazy[2]), np.sqrt(plain[2]))
    np.testing.assert_array_equal(lazy[2] + 1, plain[2] + 1)
    assert bool(lazy[2] > 0) and int(lazy[2] * 0) == 0
    assert lazy[3].reshape(1)[0] == plain[3].reshape(1)[0]
    # one mutable array a fetch, seen by later reads of the same fetch
    np.asarray(lazy[4])[...] = 7.0
    assert float(lazy[4]) == 7.0 and float(lazy[3]) != 7.0


def test_persistable_and_parameter_view_fetches_are_read_at_once():
    """tests/test_executor.py:269, and the port's own rule: the run
    writes persistables in place, so a fetch of one (``w``) or of a view
    of one under another name (``reshape(w)``) is copied before the
    state is written, and keeps its step's value; a fresh tensor is
    deferred."""
    feeds = _sgd_feeds(3)
    main, startup, (loss, w_flat) = _port(_sgd)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    seen, flats, losses = [], [], []
    for f in feeds:
        seen.append(scope.to_numpy(["w"])["w"].reshape(-1))
        l, w, flat = exe.run(main, feed=f, scope=scope,
                             fetch_list=[loss.name, "w", w_flat.name])
        assert isinstance(l, LazyFetch) and l.pending
        assert not isinstance(w, LazyFetch)
        assert not isinstance(flat, LazyFetch)
        flats.append(flat)
        losses.append(l)
    for before, flat in zip(seen, flats):
        np.testing.assert_array_equal(flat, before)
    assert not np.array_equal(flats[0], flats[-1])
    assert np.isfinite(np.asarray(losses)).all()


def test_pending_backstop_keeps_every_value():
    """tests/test_executor.py:301: past _MAX_PENDING unread fetches the
    constructor reads the batch, and every value is still right."""
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        x = tfluid.layers.data("x", [2])
        out = tfluid.layers.scale(x, scale=3.0)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    n = LazyFetch._MAX_PENDING + 40
    batches = LazyFetch.batches
    fetched = [exe.run(main, feed={"x": np.full((1, 2), float(i),
                                                "float32")},
                       fetch_list=[out.name], scope=scope)[0]
               for i in range(n)]
    assert LazyFetch.batches == batches + 1      # the backstop, once
    assert sum(f.pending for f in fetched) == n - LazyFetch._MAX_PENDING
    for i, o in enumerate(fetched):
        np.testing.assert_array_equal(np.asarray(o), np.full((1, 2), 3.0 * i))


def test_a_failed_fetch_costs_no_other():
    """When the batch's copy fails, each fetch is read alone: the good
    ones get their values and the bad one raises when read."""
    import torch
    good = [LazyFetch(torch.full((2,), float(i))) for i in range(3)]
    bad = LazyFetch(object())
    assert float(good[1][0]) == 1.0
    assert [float(g[1]) for g in good] == [0.0, 1.0, 2.0]
    with pytest.raises(RuntimeError, match="deferred fetch failed"):
        float(bad)


def test_two_threads_read_at_once():
    """Two threads read disjoint halves of 64 pending fetches at once,
    each starting with a fetch the other holds in the same batch: every
    value arrives once, and both threads finish."""
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        x = tfluid.layers.data("x", [3])
        out = tfluid.layers.scale(x, scale=2.0)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    fetched = [exe.run(main, feed={"x": np.full((1, 3), float(i),
                                                "float32")},
                       fetch_list=[out.name], scope=scope)[0]
               for i in range(64)]
    got, errors = {}, []
    start = threading.Barrier(2)

    def read(idx):
        try:
            start.wait(timeout=30)
            for i in idx:
                got[i] = float(fetched[i][0, 0])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read, args=(range(k, 64, 2),))
                   for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == {i: 2.0 * i for i in range(64)}


def test_lod_tensor_feed_shim_and_program_cache_flag():
    """tests/test_executor.py:197: a fed LoDTensor becomes its padded
    array and @LEN, against the reference; use_program_cache=False
    analyzes the program anew and gives the same result."""
    def build(fluid):
        d = fluid.layers.data("seq", [1], dtype="float32", lod_level=1)
        return fluid.layers.sequence_pool(d, "sum")

    rows, lens = [[1.0, 2.0], [3.0], [4.0, 5.0, 6.0]], [[2, 1, 3]]
    jm, js = JProgram(), JProgram()
    with j_guard(jm, js), j_unique.guard():
        jp = build(jfluid)
    with j_scope_guard(JScope()):
        (want,) = JExecutor().run(
            jm, feed={"seq": jfluid.create_lod_tensor(rows, lens, None)},
            fetch_list=[jp.name], sync=True)
    main, _, pooled = _port(build)
    exe = tfluid.Executor("cpu")
    lt = tfluid.create_lod_tensor(rows, lens, None)
    for cache in (True, False):
        (got,) = exe.run(main, feed={"seq": lt}, fetch_list=[pooled.name],
                         scope=tfluid.Scope(), use_program_cache=cache)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(got).reshape(-1),
                                      [3.0, 3.0, 15.0])
    assert len(exe._plans) == 1
