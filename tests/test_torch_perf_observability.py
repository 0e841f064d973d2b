"""The port's perf plane, run log and numerics sentinel against the JAX
package's, on the CPU (``tests/test_perf_observability.py``'s cases).

- Perf records: the port prices a plan by a cost walk over its ops'
  shapes (``observability/perf.py``) where the reference reads XLA's
  ``cost_analysis``.  Their FLOPs agree within ``XLA_FLOP_REL`` = 4%
  (measured here: LeNet's train step -1.65%, the FC stack's -0.46%, a
  non-causal ``fused_attention`` forward at D=64 -3.00%: the walk
  prices attention by K1's bound formula, 4·D a pair, and XLA adds the
  softmax's ~8 elementwise flops a pair, 8 / 256 at D=64; elsewhere XLA
  prices the elementwise tail a little higher).  The record's key joins the
  ``/stepz`` ring, ``run_steps`` records cover K steps, ``/profilez``
  and ``/memz`` serve over HTTP (and through ``tools/dump_metrics.py``)
  with the reference's keys, and ``roofline_numbers`` is the
  reference's on the same inputs.
- The run log: both packages run the same steps from the same start,
  and their records are equal field for field but the walls (``ts``,
  ``step_ms``, ``samples_per_sec``); ``tools/runlog_report.py`` reads
  the port's file; rotation, ``watch`` and the deferred cases hold.
- The sentinel: warn, inf, fatal and ``run_steps`` give the reference's
  verdicts and counters and leave the same state, bit for bit; on a
  DeepFM-style program whose sparse Adam (K10's rule) writes the tables
  in place before the commit, ``fatal`` restores every table.
- Flags off: no record, no file, no shape walk.
"""
import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import observability as JObs
from paddle_tpu.core import flags as JF
from paddle_tpu.core import unique_name as JU
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.observability import perf as JPerf
from paddle_tpu_torch import observability as TObs
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.core import unique_name as TU
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.executor import Scope as TScope
from paddle_tpu_torch.core.executor import scope_guard as t_scope_guard
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.observability import perf as TPerf
from paddle_tpu_torch.observability import runlog as TRunlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import dump_metrics  # noqa: E402
import runlog_report  # noqa: E402

XLA_FLOP_REL = 0.04
WALL_FIELDS = ("ts", "step_ms", "samples_per_sec")
OFF = {"perf_attribution": False, "run_log_dir": "", "numerics_check": "",
       "flight_record_dir": "", "sparse_fused_kernel": False}

PKG = {
    "ref": dict(fluid=jfluid, Program=JProgram, guard=j_guard, unique=JU,
                Executor=lambda: JExecutor(), Scope=JScope,
                scope_guard=j_scope_guard, flags=JF, obs=JObs),
    "port": dict(fluid=tfluid, Program=TProgram, guard=t_guard, unique=TU,
                 Executor=lambda: TExecutor("cpu"), Scope=TScope,
                 scope_guard=t_scope_guard, flags=TF, obs=TObs),
}


@pytest.fixture(autouse=True)
def _clean_planes():
    """Every test leaves both packages' perf flags off and their module
    state empty."""
    yield
    for p in PKG.values():
        p["flags"].set_flags(OFF)
        p["flags"].set_flags({"debug_server_port": 0})
        p["obs"].perf.reset()
        p["obs"].runlog.reset()
        p["obs"].flight.clear_events()
        p["obs"].debug_server.stop()


def _set(**kw):
    for p in PKG.values():
        p["flags"].set_flags(kw)


def _fc(fluid):
    x = fluid.layers.data("x", [6])
    y = fluid.layers.data("y", [1])
    pred = fluid.layers.fc(x, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(0.05).minimize(loss)
    return loss


def _fc_stack(fluid):
    x = fluid.layers.data("x", [64])
    y = fluid.layers.data("y", [1])
    h = fluid.layers.fc(x, 128, act="relu")
    h = fluid.layers.fc(h, 128, act="relu")
    loss = fluid.layers.mean(fluid.layers.square_error_cost(
        fluid.layers.fc(h, 1), y))
    fluid.optimizer.SGD(0.05).minimize(loss)
    return loss


def _lenet(fluid):
    mnist = (__import__("paddle_tpu.models.mnist", fromlist=["build"])
             if fluid is jfluid else
             __import__("paddle_tpu_torch.models.mnist", fromlist=["build"]))
    return mnist.build()[1]


def _attention(fluid):
    """One non-causal ``fused_attention`` over fed q, k, v [B, H, T, D]
    with a key mask, forward only."""
    q, k, v = (fluid.layers.data(n, [2, 32, 64]) for n in "qkv")
    mask = fluid.layers.data("mask", [32])
    helper = fluid.layer_helper.LayerHelper("fa")
    out = helper.create_variable_for_type_inference("float32",
                                                    shape=q.shape)
    helper.append_op("fused_attention",
                     {"Q": [q], "K": [k], "V": [v], "KvMask": [mask]},
                     {"Out": [out]},
                     {"impl": "xla" if fluid is jfluid else "pallas",
                      "causal": False, "scale": 0.125,
                      "dropout_rate": 0.0})
    return fluid.layers.mean(out)


def _fc_feed(seed=0, poison=None, batch=8, feature=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, feature).astype("float32")
    if poison is not None:
        x[0, 0] = poison
    return {"x": x, "y": rng.randn(batch, 1).astype("float32")}


def _lenet_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"pixel": rng.randn(16, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (16, 1)).astype("int64")}


def _attention_feed(seed=0):
    rng = np.random.RandomState(seed)
    m = np.ones((4, 32), "float32")
    m[1, 20:] = 0
    return {**{n: rng.randn(4, 2, 32, 64).astype("float32") for n in "qkv"},
            "mask": m}


class _Run:
    """One package's program, startup state and executor; the port
    starts from the reference's startup values when given them."""

    def __init__(self, pkg, build, start=None):
        p = self.p = PKG[pkg]
        self.main, startup = p["Program"](), p["Program"]()
        with p["guard"](self.main, startup), p["unique"].guard():
            self.loss = build(p["fluid"])
        self.scope, self.exe = p["Scope"](), p["Executor"]()
        with p["scope_guard"](self.scope):
            self.exe.run(startup)
        if start is not None:
            self.scope.load_numpy(start, device="cpu")

    def run(self, feed, **kw):
        with self.p["scope_guard"](self.scope):
            return self.exe.run(self.main, feed=feed,
                                fetch_list=[self.loss], **kw)

    def run_steps(self, feed):
        with self.p["scope_guard"](self.scope):
            return self.exe.run_steps(self.main, feed=feed,
                                      fetch_list=[self.loss])

    def state(self):
        names = [v.name for v in self.main.global_block.vars.values()
                 if v.persistable and self.scope.find_var(v.name) is not None
                 and not v.name.startswith("@")]
        return {n: np.array(np.asarray(self.scope.find_var(n)))
                for n in names}


def _pair(build):
    """The reference's and the port's run of ``build`` from the same
    starting values."""
    ref = _Run("ref", build)
    return ref, _Run("port", build, start=ref.state())


def _observed(perf):
    return [r for r in perf.records() if r.steps > 0]


# ---------------------------------------------------------------------------
# perf records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["lenet", "fc_stack", "attention"])
def test_cost_walk_flops_match_xla_cost_analysis(case):
    build, feed = {"lenet": (_lenet, _lenet_feed()),
                   "fc_stack": (_fc_stack, _fc_feed(batch=32, feature=64)),
                   "attention": (_attention, _attention_feed())}[case]
    _set(perf_attribution=True)
    ref, port = _pair(build)
    for _ in range(2):
        ref.run(feed, sync=True)
        port.run(feed, sync=True)
    want = max(_observed(JPerf), key=lambda r: r.flops)
    got = max(_observed(TPerf), key=lambda r: r.flops)
    assert got.flops == pytest.approx(want.flops, rel=XLA_FLOP_REL)
    assert got.bytes_accessed > 0 and got.source == "compile"
    assert got.memory["argument_bytes"] > 0
    assert got.memory["peak_bytes"] > 0
    s = got.summary()
    assert s["intensity_flops_per_byte"] == pytest.approx(
        got.flops / got.bytes_accessed, rel=1e-3)
    assert s["achieved_gflops"] > 0 and s["achieved_gbps"] > 0
    assert s["bound"] in ("compute", "memory")
    # rounded to 4 places: the small programs' fraction of the nominal
    # CPU peak can round to 0 on a loaded host; LeNet's does not
    assert s["roofline_frac"] > 0 if case == "lenet" else \
        s["roofline_frac"] >= 0
    assert s["peaks_nominal"] is True
    assert set(s) == set(want.summary())
    snap = TObs.stats.to_dict()
    assert snap.get("device_mem.host_rss_bytes", 0) > 0
    assert "perf.last_achieved_gflops" in snap
    assert snap["perf.executables"] >= 1


def test_attention_rules_count_the_kernels_work():
    """The ops that reach K1-K3 count PERF.md's bound formulas: 4·D a
    (query, key) pair forward, 6·D + 8·D backward; causal, the lower
    triangle."""
    meta = ("fused_attention", {"causal": True},
            {"Q": [((2, 4, 16, 8), 4, 0)], "K": [((2, 4, 16, 8), 4, 0)]},
            {"Out": [((2, 4, 16, 8), 4, 0)]})
    pairs = 2 * 4 * 16 * 17 // 2
    assert TPerf.op_cost(meta)[0] == 4 * 8 * pairs
    grad = ("fused_attention_grad",) + meta[1:]
    assert TPerf.op_cost(grad)[0] == 14 * 8 * pairs


def test_perf_record_key_joins_step_stats_ring():
    _set(perf_attribution=True)
    for pkg in ("ref", "port"):
        r = _Run(pkg, _fc)
        r.run(_fc_feed(), sync=True)
        obs, perf = PKG[pkg]["obs"], PKG[pkg]["obs"].perf
        ring = {s.program_key for s in obs.step_stats.last_n(8)}
        keys = {r.key for r in _observed(perf)}
        assert keys and keys <= ring
        for k in keys:   # the same key shape: <uid>v<version>:<hash>
            uid, rest = k.split("v", 1)
            assert int(uid, 16) >= 0 and len(rest.split(":")[1]) == 8


def test_run_steps_perf_attribution():
    _set(perf_attribution=True)
    K, B = 4, 8
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(K, B, 6).astype("float32"),
            "y": rng.randn(K, B, 1).astype("float32")}
    port = _Run("port", _fc)
    (stacked,) = port.run_steps(feed)
    assert stacked.shape[0] == K
    port.run({"x": feed["x"][0], "y": feed["y"][0]}, sync=True)
    recs = {r.mode: r for r in _observed(TPerf)}
    assert recs["run_steps"].flops == K * recs["run"].flops > 0


def _get(port, page):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{page}",
                                  timeout=10).read().decode("utf-8")


def test_profilez_memz_served_over_http_with_the_references_keys(capsys):
    _set(perf_attribution=True)
    pages = {}
    for pkg in ("ref", "port"):
        _Run(pkg, _fc).run(_fc_feed(), sync=True)
        srv = PKG[pkg]["obs"].debug_server.start(port=0)
        try:
            pz = json.loads(_get(srv.port, "/profilez"))
            mz = json.loads(_get(srv.port, "/memz"))
            pages[pkg] = (pz, mz)
            assert pz["enabled"] is True
            assert pz["platform_peaks"]["platform"] == "cpu"
            observed = [r for r in pz["records"] if r["steps"] > 0]
            assert observed and "roofline_frac" in observed[0]
            assert any(r["flops"] > 0 for r in pz["records"])
            assert len(mz["devices"]) >= 1 and mz["host_rss_bytes"] > 0
            assert "perf attribution (on)" in _get(srv.port,
                                                   "/profilez?text=1")
            assert "host rss" in _get(srv.port, "/memz?text=1")
            assert "/memz" in _get(srv.port, "/")
            if pkg == "port":
                # the operator CLI (stdlib only) against the port's pages
                assert dump_metrics.main(["--memz", "--profilez",
                                          str(srv.port)]) == 0
                out = capsys.readouterr().out
                assert '"devices"' in out and '"platform_peaks"' in out
                assert dump_metrics.main(["--memz", "--text",
                                          str(srv.port)]) == 0
                assert "host rss" in capsys.readouterr().out
                inv = json.loads(_get(srv.port, "/statusz"))["platform"]
                assert inv["platform"] == "cpu"
                assert inv["local_device_count"] == len(inv["devices"])
                assert {"kind", "memory_limit_bytes"} <= set(
                    inv["devices"][0])
        finally:
            PKG[pkg]["obs"].debug_server.stop()
    (jpz, jmz), (tpz, tmz) = pages["ref"], pages["port"]
    assert set(tpz) == set(jpz)
    assert set(tpz["platform_peaks"]) == set(jpz["platform_peaks"])
    top = [max(pz["records"], key=lambda r: r["flops"]) for pz in (tpz, jpz)]
    assert set(top[0]) == set(top[1])
    assert set(tmz) == set(jmz)
    assert set(jmz["devices"][0]) <= set(tmz["devices"][0])


def test_roofline_numbers_equal_the_references():
    peaks = {"flops": 100e9, "hbm_bytes_per_s": 10e9}
    for args in ((1e9, 1e7, 0.1), (1e6, 1e7, 0.001), (1e6, 1e7, None),
                 (0.0, 5e6, 0.02), (3.3e12, 2.2e9, 0.004)):
        for pk in (peaks, {"flops": None, "hbm_bytes_per_s": None},
                   dict(peaks, nominal=True)):
            assert TPerf.roofline_numbers(*args, peaks=pk) == \
                JPerf.roofline_numbers(*args, peaks=pk)
    r = TPerf.roofline_numbers(1e9, 1e7, 0.1, peaks=peaks)
    assert r["bound"] == "compute" and r["achieved_gflops"] == 10.0


def test_flags_off_zero_io_and_no_shape_walk(tmp_path, monkeypatch):
    walked = []
    monkeypatch.setattr(TPerf, "op_meta",
                        lambda *a: walked.append(a) or None)
    before = set(os.listdir(str(tmp_path)))
    port = _Run("port", _fc)
    port.run(_fc_feed(), sync=True)
    assert not TPerf.enabled() and not TRunlog.enabled()
    assert TPerf.records() == [] and walked == []
    assert set(os.listdir(str(tmp_path))) == before
    entries = list(port.exe._plans.values())
    assert entries and all(e.perf is None for e in entries)


def test_platform_peaks_are_the_cards_numbers():
    from paddle_tpu_torch import platform
    assert platform.PLATFORM_PEAKS["h10080gbhbm3"] == (989e12, 3.35e12)
    cpu = platform.platform_peaks("cpu")
    assert cpu["nominal"] is True and cpu["flops"] == 0.5e12
    assert TPerf.sample_device_memory(set_gauges=False)["devices"][0][
        "kind"] == "cpu"


# ---------------------------------------------------------------------------
# the run log
# ---------------------------------------------------------------------------

def _log_file(d):
    files = [f for f in os.listdir(d) if f.endswith(".jsonl")]
    assert len(files) == 1
    return os.path.join(d, files[0])


def _untimed(recs):
    return [{k: v for k, v in r.items() if k not in WALL_FIELDS}
            for r in recs]


def test_runlog_records_equal_the_references_and_roundtrip(tmp_path,
                                                           capsys):
    ref, port = _pair(_fc)
    logs = {}
    for pkg, run in (("ref", ref), ("port", port)):
        d = str(tmp_path / pkg)
        PKG[pkg]["flags"].set_flags({"run_log_dir": d})
        for i in range(5):
            run.run(_fc_feed(seed=i), sync=True)
        PKG[pkg]["obs"].runlog.reset()
        logs[pkg] = _log_file(d)
    want = runlog_report.load(logs["ref"])
    got = runlog_report.load(logs["port"])
    assert len(got) == len(want) == 5
    for g, w in zip(_untimed(got), _untimed(want)):
        assert g.keys() == w.keys()
        assert g["step"] == w["step"]
        [(name, val)] = g["scalars"].items()
        assert list(w["scalars"]) == [name]
        assert val == pytest.approx(w["scalars"][name], rel=1e-5)
    assert all(r["step_ms"] > 0 and r["samples_per_sec"] > 0 for r in got)
    summary = runlog_report.summarize(got)
    st = summary["scalars"][name]
    assert st["n"] == 5 and st["nonfinite"] == 0
    assert runlog_report.main([logs["port"]]) == 0
    assert f"scalar {name}" in capsys.readouterr().out
    assert runlog_report.main([logs["port"], "--csv"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 6
    assert runlog_report.main([logs["port"], "--compare", logs["ref"]]) \
        == 0


def test_runlog_rotation_atomic_and_watch(tmp_path):
    path = str(tmp_path / "rot.jsonl")
    log = TRunlog.RunLog(path, max_bytes=400)
    for i in range(40):
        log.log({"scalars": {"loss": float(i)}})
    log.close()
    assert os.path.exists(path + ".1")
    gens = [TRunlog.RunLog.read(f"{path}.{k}")
            for k in range(1, TRunlog.RunLog.KEEP_ROTATIONS + 1)]
    main = TRunlog.RunLog.read(path)
    every = sorted(r["step"] for recs in [main] + gens for r in recs)
    assert every == list(range(1, 41))
    got = list(TRunlog.RunLog(path).watch(poll_interval=0.01, timeout=0.2))
    assert [r["step"] for r in got] == [r["step"] for r in main]


class _FakeDeferred:
    """A LazyFetch stand-in: read before it materializes = a sync."""

    def __init__(self, val):
        self._np = None
        self._err = None
        self._done = threading.Event()
        self._val = val
        self.shape = ()
        self.dtype = np.dtype("float32")

    def materialize(self):
        self._np = np.asarray(self._val, dtype="float32")
        self._done.set()

    def __array__(self, dtype=None, copy=None):
        assert self._np is not None, "deferred fetch forced a device sync"
        return self._np if dtype is None else self._np.astype(dtype)


class _Event:
    """A ``torch.cuda.Event`` stand-in: ``query()`` without a wait."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_runlog_defers_pending_and_unready_fetches(tmp_path):
    """A LazyFetch still pending, and a raw tensor whose step's event
    has not fired, queue their records; they land in order once ready
    and ``flush()`` writes the tail."""
    TF.set_flags({"run_log_dir": str(tmp_path / "rl")})
    f1 = _FakeDeferred(1.5)
    TRunlog.log_run(["loss"], [f1], wall_ms=1.0)
    lg = TRunlog.default_log()
    assert TRunlog.RunLog.read(lg.path) == []
    f1.materialize()
    ev = _Event()
    TRunlog.log_run(["loss"], [torch.tensor(2.5)], wall_ms=1.0, ready=ev)
    assert [r["scalars"]["loss"]
            for r in TRunlog.RunLog.read(lg.path)] == [1.5]
    ev.done = True
    TRunlog.log_run(["loss"], [torch.tensor(3.5)], wall_ms=1.0)
    assert [r["scalars"]["loss"]
            for r in TRunlog.RunLog.read(lg.path)] == [1.5, 2.5, 3.5]


def test_runlog_is_ready_duck_type_and_unreadable_stamp(tmp_path):
    class _Arr:
        shape = ()
        dtype = np.dtype("float32")
        ready = False

        def is_ready(self):
            return self.ready

        def __array__(self, dtype=None, copy=None):
            assert self.ready, "blocked on an unready device array"
            return np.asarray(7.0, dtype="float32")

    class _Dead(_Arr):
        ready = True

        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("buffer was overwritten")

    TF.set_flags({"run_log_dir": str(tmp_path / "rl")})
    a = _Arr()
    TRunlog.log_run(["loss"], [a], wall_ms=1.0)
    lg = TRunlog.default_log()
    assert TRunlog.RunLog.read(lg.path) == []
    a.ready = True
    TRunlog.flush()
    TRunlog.log_run(["loss"], [_Dead()], wall_ms=1.0)
    recs = TRunlog.RunLog.read(lg.path)
    assert recs[0]["scalars"] == {"loss": 7.0}
    assert recs[1]["unreadable_fetches"] == 1 and recs[1]["scalars"] == {}


def test_runlog_async_and_raw_paths_drain_on_reset(tmp_path):
    """The default deferred fetches and ``return_numpy=False`` tensors:
    nothing is forced mid-loop, ``reset()`` lands every record."""
    d = str(tmp_path / "rl")
    TF.set_flags({"run_log_dir": d})
    port = _Run("port", _fc)
    outs = [port.run(_fc_feed(seed=i)) for i in range(3)]
    outs += [port.run(_fc_feed(seed=9), return_numpy=False)]
    TRunlog.reset()
    # the startup run logs a record without scalars, as the reference's
    recs = [r for r in TRunlog.RunLog.read(_log_file(d)) if r["scalars"]]
    assert len(recs) == 4
    assert all(np.isfinite(list(r["scalars"].values())[0]) for r in recs)
    del outs


def test_runlog_batch_of_and_grad_norm(tmp_path):
    assert TRunlog.batch_of([torch.zeros(1), torch.zeros(256, 3, 8)]) == 256
    assert TRunlog.batch_of([np.zeros((4, 256, 7))], axis=1) == 256
    assert TRunlog.batch_of([]) is None
    path = str(tmp_path / "g.jsonl")
    log = TRunlog.RunLog(path)
    K = 3
    grads = torch.arange(K * 4, dtype=torch.float32).reshape(K, 2, 2)
    losses = torch.tensor([1.0, 2.0, 3.0])
    log.defer(("steps", ["loss", "w@GRAD"], [losses, grads], K, 30.0, 8))
    log.log({"scalars": {"loss": float("nan")}})
    log.close()
    recs = TRunlog.RunLog.read(path)
    for i, r in enumerate(recs[:K]):
        want = float(np.sqrt((grads[i].double() ** 2).sum()))
        assert r["grad_global_norm"] == pytest.approx(want, rel=1e-6)
        assert r["scalars"]["loss"] == losses[i].item()
    assert runlog_report.summarize(recs)["scalars"]["loss"][
        "nonfinite"] == 1


def test_run_steps_emits_k_records_like_the_reference(tmp_path):
    K, B = 3, 8
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(K, B, 6).astype("float32"),
            "y": rng.randn(K, B, 1).astype("float32")}
    ref, port = _pair(_fc)
    recs = {}
    for pkg, run in (("ref", ref), ("port", port)):
        d = str(tmp_path / pkg)
        PKG[pkg]["flags"].set_flags({"run_log_dir": d})
        (stacked,) = run.run_steps(feed)
        PKG[pkg]["obs"].runlog.reset()
        recs[pkg] = TRunlog.RunLog.read(_log_file(d))
        logged = [list(r["scalars"].values())[0] for r in recs[pkg]]
        np.testing.assert_allclose(logged, np.asarray(stacked).reshape(K),
                                   rtol=1e-6)
        assert all(r["k_steps"] == K for r in recs[pkg])
    assert [sorted(r) for r in _untimed(recs["port"])] == \
        [sorted(r) for r in _untimed(recs["ref"])]


# ---------------------------------------------------------------------------
# the numerics sentinel
# ---------------------------------------------------------------------------

def _numerics(pkg):
    snap = PKG[pkg]["obs"].stats.to_dict()
    return {k: snap.get(f"numerics.{k}", 0)
            for k in ("nan", "inf", "checked_steps")}


def _sentinel_run(pkg, run, feed, mode):
    """(counter deltas, flight note or None, raised?) of one step."""
    PKG[pkg]["flags"].set_flags({"numerics_check": mode})
    PKG[pkg]["obs"].flight.clear_events()
    before = _numerics(pkg)
    raised = None
    try:
        run.run(feed, sync=True)
    except FloatingPointError as e:
        raised = str(e)
    after = _numerics(pkg)
    notes = [e for e in PKG[pkg]["obs"].flight.events()
             if e["msg"] == "numerics_sentinel"]
    note = ({k: notes[-1][k] for k in ("mode", "nan_vars", "inf_vars")}
            if notes else None)
    return {k: after[k] - before[k] for k in after}, note, raised


@pytest.mark.parametrize("mode,poison", [("warn", np.nan),
                                         ("warn", np.inf),
                                         ("fatal", np.nan),
                                         ("", np.nan)])
def test_sentinel_gives_the_references_verdicts(mode, poison, tmp_path):
    _set(flight_record_dir=str(tmp_path / "fl"))
    ref, port = _pair(_fc)
    for run in (ref, port):
        run.run(_fc_feed(seed=3), sync=True)
    got = {}
    for pkg, run in (("ref", ref), ("port", port)):
        before = run.state()
        got[pkg] = _sentinel_run(pkg, run, _fc_feed(seed=3, poison=poison),
                                 mode)
        after = run.state()
        if mode == "fatal":
            assert got[pkg][2] and ref.loss.name in got[pkg][2]
            for n in before:
                np.testing.assert_array_equal(before[n], after[n])
            # training carries on from the restored state
            PKG[pkg]["flags"].set_flags({"numerics_check": ""})
            (lv,) = run.run(_fc_feed(seed=4), sync=True)
            assert np.isfinite(float(lv))
    assert got["port"][:2] == got["ref"][:2]
    assert bool(got["port"][2]) == bool(got["ref"][2])
    if mode == "fatal":
        assert any("numerics_fatal" in f
                   for f in os.listdir(str(tmp_path / "fl")))
    if mode == "warn":
        assert ref.loss.name in (got["port"][1]["nan_vars"]
                                 + got["port"][1]["inf_vars"])
    if not mode:
        assert got["port"][0]["checked_steps"] == 0


def test_sentinel_fatal_run_steps_restores_like_the_reference():
    K, B = 3, 8
    rng = np.random.RandomState(5)
    x = rng.randn(K, B, 6).astype("float32")
    x[1, 0, 0] = np.nan   # poison step 2
    feed = {"x": x, "y": rng.randn(K, B, 1).astype("float32")}
    _set(numerics_check="fatal")
    ref, port = _pair(_fc)
    start = ref.state()
    for run in (ref, port):
        with pytest.raises(FloatingPointError):
            run.run_steps(feed)
        for n, v in run.state().items():
            np.testing.assert_array_equal(start[n], v)


def _deepfm(fluid):
    mod = (__import__("paddle_tpu.models.deepfm", fromlist=["build"])
           if fluid is jfluid else
           __import__("paddle_tpu_torch.models.deepfm", fromlist=["build"]))
    return mod.build(sparse_dim=64, sparse_fields=4, embed_dim=4,
                     dense_dim=3, lr=0.01)[1]


def _deepfm_feed(seed, poison=None):
    """A batch; ``poison`` puts a NaN in one ``label`` (it enters
    through the loss's gradient) or one ``dense`` input (it goes through
    ``relu``, whose gradient at a NaN input is the reference's 0)."""
    rng = np.random.RandomState(seed)
    feed = {"dense": rng.randn(8, 3).astype("float32"),
            "sparse": rng.randint(0, 64, (8, 4)).astype("int64"),
            "label": rng.randint(0, 2, (8, 1)).astype("float32")}
    if poison is not None:
        feed[poison][2, 0] = np.nan
    return feed


@pytest.mark.parametrize("poison", ["label", "dense"])
def test_sentinel_fatal_restores_tables_written_in_place(poison):
    """DeepFM-style: sparse Adam's rule (K10's plain version here)
    writes the embedding tables and their moments in place, before the
    commit.  A fatal verdict puts every persistable back, bit for bit,
    and the reference names the same variables."""
    _set(sparse_fused_kernel=True)
    ref, port = _pair(_deepfm)
    for run in (ref, port):
        run.run(_deepfm_feed(0), sync=True)
    tables = [n for n in port.state() if "emb" in n or "w1" in n]
    assert tables
    verdicts = {}
    for pkg, run in (("ref", ref), ("port", port)):
        before = run.state()
        PKG[pkg]["flags"].set_flags({"numerics_check": "fatal"})
        with pytest.raises(FloatingPointError) as ei:
            run.run(_deepfm_feed(1, poison=poison), sync=True)
        verdicts[pkg] = str(ei.value).split(" — ")[0]
        after = run.state()
        assert before.keys() == after.keys()
        for n in before:
            np.testing.assert_array_equal(before[n], after[n])
    assert verdicts["port"] == verdicts["ref"]
    # without the sentinel the same step does poison the tables in place
    TF.set_flags({"numerics_check": ""})
    port.run(_deepfm_feed(1, poison=poison), sync=True)
    assert any(not np.isfinite(port.state()[n]).all() for n in tables)


def test_fleet_merge_includes_perf_gauges():
    a = {"labels": {}, "metrics": {"device_mem.host_rss_bytes": {
        "kind": "gauge", "value": 111.0}}}
    b = {"labels": {}, "metrics": {"device_mem.host_rss_bytes": {
        "kind": "gauge", "value": 222.0}}}
    for agg in (TObs.aggregate, JObs.aggregate):
        g = agg.merge_snapshots({"w0": a, "w1": b})["gauges"][
            "device_mem.host_rss_bytes"]
        assert g["per_worker"] == {"w0": 111.0, "w1": 222.0}

