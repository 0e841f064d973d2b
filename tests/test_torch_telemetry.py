"""The port executor's run telemetry against the JAX package's, on the
CPU (``tests/test_telemetry.py:172-258``).

Both packages run the same sequences: ``run`` over feed-shape buckets,
a one-slot cache, ``FLAGS_runtime_stats`` off, ``run_steps``, and
``run_callable`` over two signatures.  Their ``executor.*`` counter
deltas (steps, cache hits and misses, shape recompiles, evictions, feed
and fetch bytes), their ``StepStats`` cache-hit sequences, byte counts
and key shapes are equal; the port's plan build stands where the
reference compiles, so a miss has ``lowering_ms`` and ``compile_ms``
above 0 and a hit both at 0.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import observability as JObs
from paddle_tpu.core import unique_name as JU
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu_torch import observability as TObs
from paddle_tpu_torch.core import unique_name as TU
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.executor import Scope as TScope
from paddle_tpu_torch.core.executor import scope_guard as t_scope_guard
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.observability.step_stats import approx_nbytes

PKG = {
    "ref": dict(fluid=jfluid, Program=JProgram, guard=j_guard, unique=JU,
                Executor=lambda: JExecutor(), Scope=JScope,
                scope_guard=j_scope_guard, obs=JObs),
    "port": dict(fluid=tfluid, Program=TProgram, guard=t_guard, unique=TU,
                 Executor=lambda: TExecutor("cpu"), Scope=TScope,
                 scope_guard=t_scope_guard, obs=TObs),
}
COUNTERS = ("steps", "cache_hits", "cache_misses", "shape_recompiles",
            "cache_evictions", "feed_bytes", "fetch_bytes")


def _tiny(pkg):
    p = PKG[pkg]
    fluid = p["fluid"]
    prog, startup = p["Program"](), p["Program"]()
    with p["guard"](prog, startup), p["unique"].guard():
        x = fluid.layers.data("x", [4])
        h = fluid.layers.fc(x, 8, act="tanh")
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(0.1).minimize(loss)
    scope, exe = p["Scope"](), p["Executor"]()
    with p["scope_guard"](scope):
        exe.run(startup)
    return prog, loss, scope, exe


def _counters(pkg):
    snap = PKG[pkg]["obs"].snapshot()
    return {k: snap.get(f"executor.{k}", 0) or 0 for k in COUNTERS}


def _delta(before, after):
    return {k: after[k] - before[k] for k in COUNTERS}


def _record(pkg, runs):
    """Counter deltas and the StepStats of ``runs(prog, loss, exe)``."""
    prog, loss, scope, exe = _tiny(pkg)
    obs = PKG[pkg]["obs"]
    obs.reset()
    before = _counters(pkg)
    with PKG[pkg]["scope_guard"](scope):
        n = runs(prog, loss, exe)
    tail = obs.step_stats.last_n(n)
    return _delta(before, _counters(pkg)), tail, exe


def _shape_buckets(prog, loss, exe):
    for bs in (2, 2, 6):
        exe.run(prog, feed={"x": np.ones((bs, 4), "float32")},
                fetch_list=[loss.name], sync=True)
    return 3


def test_executor_records_cache_hits_misses_and_shape_recompiles():
    got = {pkg: _record(pkg, _shape_buckets) for pkg in PKG}
    (td, ttail, _), (jd, jtail, _) = got["port"], got["ref"]
    assert td == jd
    assert td["steps"] == 3 and td["cache_hits"] == 1
    assert td["cache_misses"] == 2 and td["shape_recompiles"] == 1
    assert [s.cache_hit for s in ttail] == [s.cache_hit for s in jtail] \
        == [False, True, False]
    assert [(s.feed_bytes, s.fetch_bytes) for s in ttail] == \
        [(s.feed_bytes, s.fetch_bytes) for s in jtail]
    miss, hit = ttail[0], ttail[1]
    assert miss.compile_ms > 0 and miss.lowering_ms > 0
    assert hit.compile_ms == 0 and hit.lowering_ms == 0
    assert hit.wall_ms > 0 and hit.feed_bytes == 2 * 4 * 4
    # the key: <program uid>v<version>:<hash>, one a cache entry
    for tail in (ttail, jtail):
        keys = [s.program_key for s in tail]
        assert keys[0] == keys[1] != keys[2]
        assert all(k.split(":")[0].split("v")[1].isdigit() for k in keys)
    snap = TObs.snapshot()
    assert snap["lowering.analyze_ms"]["count"] >= 2
    assert "executor_cache_misses 2" in TObs.to_prometheus_text()


def test_executor_cache_eviction_counted():
    def runs(prog, loss, exe):
        for bs in (2, 3, 2):
            exe.run(prog, feed={"x": np.ones((bs, 4), "float32")},
                    fetch_list=[loss.name], sync=True)
        return 3
    jfluid.set_flags({"executor_cache_capacity": 1})
    tfluid.core.flags.set_flags({"executor_cache_capacity": 1})
    try:
        got = {pkg: _record(pkg, runs) for pkg in PKG}
    finally:
        jfluid.set_flags({"executor_cache_capacity": 256})
        tfluid.core.flags.set_flags({"executor_cache_capacity": 256})
    assert got["port"][0] == got["ref"][0]
    assert got["port"][0]["cache_evictions"] >= 2
    assert got["port"][0]["cache_misses"] == 3
    assert len(got["port"][2]._plans) <= 1


def test_runtime_stats_flag_disables_collection():
    for pkg, set_flags in (("ref", jfluid.set_flags),
                           ("port", tfluid.core.flags.set_flags)):
        prog, loss, scope, exe = _tiny(pkg)
        obs = PKG[pkg]["obs"]
        set_flags({"runtime_stats": False})
        try:
            obs.reset()
            with PKG[pkg]["scope_guard"](scope):
                exe.run(prog, feed={"x": np.ones((2, 4), "float32")},
                        fetch_list=[loss.name], sync=True)
            assert len(obs.step_stats.recorder()) == 0
            assert obs.snapshot().get("executor.steps") in (None, 0)
        finally:
            set_flags({"runtime_stats": True})


def test_run_steps_records_step_stats():
    K = 3

    def runs(prog, loss, exe):
        exe.run_steps(prog, feed={"x": np.ones((K, 2, 4), "float32")},
                      fetch_list=[loss.name])
        return 1
    got = {pkg: _record(pkg, runs) for pkg in PKG}
    assert got["port"][0] == got["ref"][0]
    (t,), (j,) = got["port"][1], got["ref"][1]
    assert not t.cache_hit and not j.cache_hit
    assert t.compile_ms > 0
    assert t.feed_bytes == j.feed_bytes == K * 2 * 4 * 4
    assert t.fetch_bytes == j.fetch_bytes
    assert got["port"][0]["cache_misses"] == 1


def _callables(pkg):
    """Three dispatches of one callable key over two feed signatures."""
    exe = PKG[pkg]["Executor"]()
    if pkg == "ref":
        import jax.numpy as jnp

        def build():
            return lambda feed, state, const: (
                [feed[0] * 2.0], list(state))
        feeds = [jnp.ones((2,), "float32"), jnp.ones((2,), "float32"),
                 jnp.ones((3,), "float32")]
    else:
        def build():
            return lambda feed, state, const: [feed[0] * 2.0]
        feeds = [torch.ones(2), torch.ones(2), torch.ones(3)]
    PKG[pkg]["obs"].reset()
    before = _counters(pkg)
    for f in feeds:
        exe.run_callable("tele/double", build, [f])
    tail = PKG[pkg]["obs"].step_stats.last_n(3)
    return _delta(before, _counters(pkg)), tail


def test_run_callable_records_its_key_and_signatures():
    (td, ttail), (jd, jtail) = _callables("port"), _callables("ref")
    for k in ("steps", "cache_hits", "cache_misses", "shape_recompiles"):
        assert td[k] == jd[k], k
    assert (td["cache_misses"], td["shape_recompiles"]) == (2, 1)
    assert [(s.program_key, s.cache_hit, s.feed_bytes, s.fetch_bytes)
            for s in ttail] == \
        [(s.program_key, s.cache_hit, s.feed_bytes, s.fetch_bytes)
         for s in jtail]
    assert ttail[0].program_key == "callable:tele/double"


def test_approx_nbytes_counts_tensors_from_metadata():
    assert approx_nbytes(torch.zeros(4, 8)) == 128
    assert approx_nbytes(torch.zeros(3, dtype=torch.bfloat16)) == 6
    assert approx_nbytes(np.zeros((4, 8), "float32")) == 128
    assert approx_nbytes(object()) == 0


def test_statusz_lists_live_executors():
    prog, loss, scope, exe = _tiny("port")
    with t_scope_guard(scope):
        exe.run(prog, feed={"x": np.ones((2, 4), "float32")},
                fetch_list=[loss.name], sync=True)
    srv = TObs.debug_server.start(port=0)
    try:
        st = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/statusz", timeout=10).read())
    finally:
        TObs.debug_server.stop()
    card = st["executors"]
    assert card["cache_capacity"] == 256
    assert any(e["cache_entries"] >= 1 and e["training"]
               for e in card["executors"])
    jst = JObs.debug_server._statusz()
    assert set(card) == set(jst["executors"])


@pytest.fixture(autouse=True)
def _reset():
    yield
    TObs.reset()
    JObs.reset()
