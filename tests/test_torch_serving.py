"""The port's serving plane on the CPU: ``DynamicBatcher`` and
``ModelManager`` (the reference's ``tests/test_serving.py`` cases that
do not need the wire).

- the bucket ladder and ``_pad_rows``;
- pad-to-bucket parity: a coalesced batch at a bucket boundary equals
  ``Predictor.run`` of the same rows bit for bit; past it, the padded
  dispatch equals a run of the identically padded batch bit for bit,
  and each request's own run within 1e-5 (another batch size may sum in
  another order);
- load / activate / infer through ``ModelManager`` from a saved model
  directory, with the ladder warmed; concurrent submits from several
  threads answered with ``Predictor.run``'s rows;
- a hot swap under load drops nothing, and every reply is the old or
  the new version's answer (within 1e-5: its batch may be another
  size);
- drain and close; a malformed request refused alone; typed
  ``Overloaded`` (queue bound and queue-delay SLO) and
  ``RequestTooLong``;
- an int8 predictor (a small Transformer through ``enable_int8()``)
  served by the manager: every request answered, the replies finite.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.core.executor import Executor, Scope, scope_guard
from paddle_tpu_torch.core.program import Program, program_guard
from paddle_tpu_torch.inference import AnalysisConfig, Predictor
from paddle_tpu_torch.serving import (BucketLadder, DynamicBatcher,
                                      ModelManager, Overloaded,
                                      RequestTooLong)
from paddle_tpu_torch.serving.batcher import _pad_rows

L = tfluid.layers
CPU = tfluid.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp_program(seed):
    prog, startup = Program(), Program()
    prog.random_seed = seed
    with program_guard(prog, startup), unique_name.guard():
        x = L.data("x", [8])
        h = L.fc(x, 16, act="relu")
        y = L.fc(h, 4, act="softmax")
    return prog, startup, y


def _mlp_predictor(seed=1):
    prog, startup, y = _mlp_program(seed)
    scope, exe = Scope(), Executor(CPU)
    with scope_guard(scope):
        exe.run(startup)
    return Predictor(prog, ["x"], [y.name], scope, CPU)


def _save_mlp(dirname, seed=1):
    prog, startup, y = _mlp_program(seed)
    scope, exe = Scope(), Executor(CPU)
    with scope_guard(scope):
        exe.run(startup)
        tfluid.io.save_inference_model(dirname, ["x"], [y], exe,
                                       main_program=prog)


def _cpu_config(d, int8=False):
    cfg = AnalysisConfig(d)
    cfg.disable_gpu()
    if int8:
        cfg.enable_int8()
    return cfg


class _StubPredictor:
    """Batcher-surface stub with a controllable service time."""

    feed_names = ["x"]
    fetch_names = ["y"]

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.calls = []

    def run(self, feed):
        if self.delay_s:
            time.sleep(self.delay_s)
        x = np.asarray(feed["x"])
        self.calls.append(x.shape[0])
        return [x * 2.0]


def test_bucket_ladder_and_pad_rows():
    lad = BucketLadder((8, 1, 4, 2))
    assert lad.sizes == (1, 2, 4, 8) and lad.max == 8
    assert [lad.snap(n) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    with pytest.raises(ValueError):
        lad.snap(9)
    a = np.arange(6, dtype="float32").reshape(3, 2)
    p = _pad_rows(a, 2)
    assert p.shape == (5, 2)
    np.testing.assert_array_equal(p[3:], np.repeat(a[-1:], 2, axis=0))
    assert _pad_rows(a, 0) is a


def _serve_batch(pred, reqs, buckets):
    b = DynamicBatcher(pred, name="parity", buckets=buckets,
                       max_delay_ms=150.0, max_queue_rows=1024)
    try:
        futs = [b.submit(r) for r in reqs]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        b.close()
    assert b.stats.batches == 1, "the requests did not coalesce"
    return outs


def test_pad_parity_at_and_past_a_bucket_boundary():
    pred = _mlp_predictor(3)
    rng = np.random.RandomState(0)
    reqs = [{"x": rng.randn(1, 8).astype("float32")} for _ in range(4)]
    outs = _serve_batch(pred, reqs, buckets=(4,))
    direct = pred.run({"x": np.concatenate([r["x"] for r in reqs])})[0]
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o[0], direct[i:i + 1])

    reqs5 = [{"x": rng.randn(1, 8).astype("float32")} for _ in range(5)]
    outs5 = _serve_batch(pred, reqs5, buckets=(8,))
    rows = np.concatenate([r["x"] for r in reqs5])
    padded = pred.run({"x": _pad_rows(rows, 3)})[0]
    for i, o in enumerate(outs5):
        np.testing.assert_array_equal(o[0], padded[i:i + 1])
    for r, o in zip(reqs5, outs5):
        np.testing.assert_allclose(o[0], pred.run(r)[0], **TOL)


def test_manager_load_warm_and_concurrent_infer(tmp_path):
    d = str(tmp_path / "mlp")
    _save_mlp(d, seed=5)
    mgr = ModelManager()
    try:
        sm = mgr.load("mlp", "1", model_dir=d, config=_cpu_config(d),
                      buckets=(1, 2, 4, 8), activate=True, max_delay_ms=3.0)
        assert sm.warm_info["buckets"] == [1, 2, 4, 8]
        assert sm.warm_info["warmed"] == 4 and not sm.warm_info["skipped"]
        pred = sm.predictor
        rng = np.random.RandomState(1)
        feeds = [{"x": rng.randn(int(rng.randint(1, 4)), 8)
                  .astype("float32")} for _ in range(32)]
        results, errs = {}, []

        def client(k):
            try:
                for i in range(k, len(feeds), 4):
                    results[i] = mgr.infer("mlp", feeds[i], timeout=60)
            except Exception as e:  # pragma: no cover - the assertion
                errs.append(repr(e))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs
        assert sorted(results) == list(range(len(feeds)))
        for i, f in enumerate(feeds):
            got = results[i][0]
            assert got.shape == (f["x"].shape[0], 4)
            np.testing.assert_allclose(got, pred.run(f)[0], **TOL)
        z = mgr.servingz()
        assert z["active"] == {"mlp": "1"}
        snap = z["models"]["mlp@1"]
        assert snap["requests"] == 32 and snap["errors"] == 0
        assert snap["rows"] == sum(f["x"].shape[0] for f in feeds)
        assert snap["state"] == "SERVING" and snap["batches"] >= 4
        assert mgr.fetch_names("mlp") == pred.fetch_names
    finally:
        mgr.close()


def test_hot_swap_under_load_drops_nothing():
    pred1, pred2 = _mlp_predictor(1), _mlp_predictor(2)
    mgr = ModelManager()
    mgr.load("mlp", "1", predictor=pred1, buckets=(1, 2, 4),
             activate=True, max_delay_ms=2.0)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(1, 8).astype("float32")} for _ in range(8)]
    want1 = [pred1.run(f)[0] for f in feeds]
    want2 = [pred2.run(f)[0] for f in feeds]
    stop = threading.Event()
    errs, results = [], []
    lock = threading.Lock()

    def client():
        i = 0
        while not stop.is_set():
            try:
                out = mgr.infer("mlp", feeds[i % 8], timeout=60)
            except Exception as e:  # pragma: no cover - the assertion
                errs.append(repr(e))
                return
            with lock:
                results.append((i % 8, out[0]))
            i += 1

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.15)
    info = mgr.swap("mlp", "2", predictor=pred2, buckets=(1, 2, 4),
                    max_delay_ms=2.0)
    time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    assert info["drained"] and info["previous"] == "1"
    assert mgr.active_version("mlp") == "2"
    assert results
    for idx, got in results:
        assert (np.allclose(got, want1[idx], **TOL)
                or np.allclose(got, want2[idx], **TOL))
    np.testing.assert_allclose(mgr.infer("mlp", feeds[0], timeout=60)[0],
                               want2[0], **TOL)
    with pytest.raises(ValueError, match="ACTIVE"):
        mgr.retire("mlp", "2")
    z = mgr.servingz()["models"]
    assert z["mlp@1"]["state"] == "RETIRED" and z["mlp@1"]["errors"] == 0
    mgr.close()


def test_drain_close_and_malformed_requests():
    pred = _mlp_predictor(4)
    b = DynamicBatcher(pred, name="guard", buckets=(4,), max_delay_ms=60.0)
    rng = np.random.RandomState(0)
    good = [b.submit({"x": rng.randn(1, 8).astype("float32")})
            for _ in range(2)]
    with pytest.raises(ValueError, match="sample shape"):
        b.submit({"x": np.zeros((1, 9), "float32")})
    with pytest.raises(ValueError, match="missing feed"):
        b.submit({"z": np.zeros((1, 8), "float32")})
    with pytest.raises(ValueError, match="top bucket"):
        b.submit({"x": np.zeros((5, 8), "float32")})
    f64 = b.submit({"x": rng.randn(1, 8)})          # float64: cast
    assert b.drain(timeout=60)
    for f in good + [f64]:
        out = f.result(timeout=1)[0]
        assert out.dtype == np.float32 and out.shape == (1, 4)
    assert b.queue_rows() == 0
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit({"x": np.zeros((1, 8), "float32")})


def test_admission_bounded_queue_sheds_typed():
    stub = _StubPredictor(delay_s=0.25)
    b = DynamicBatcher(stub, buckets=(1,), max_delay_ms=0.0,
                       max_queue_rows=2)
    try:
        first = b.submit({"x": np.zeros((1, 2), "float32")})
        time.sleep(0.05)          # the scheduler took it: queue empty
        b.submit({"x": np.zeros((1, 2), "float32")})
        b.submit({"x": np.zeros((1, 2), "float32")})
        with pytest.raises(Overloaded) as ei:
            b.submit({"x": np.zeros((1, 2), "float32")})
        e = ei.value
        assert e.limit_rows == 2 and e.queue_rows == 2
        assert e.est_delay_ms is None
        assert Overloaded.from_dict(e.to_dict()).limit_rows == 2
        assert b.stats.snapshot()["shed"] == 1
        first.result(timeout=30)
    finally:
        b.close()


def test_admission_queue_delay_slo_sheds():
    stub = _StubPredictor(delay_s=0.12)
    b = DynamicBatcher(stub, buckets=(1,), max_delay_ms=0.0,
                       max_queue_rows=1024, queue_delay_slo_ms=10.0)
    try:
        b.submit({"x": np.zeros((1, 2), "float32")}).result(timeout=30)
        ok = b.submit({"x": np.zeros((1, 2), "float32")})   # idle: admitted
        time.sleep(0.02)
        with pytest.raises(Overloaded) as ei:
            b.submit({"x": np.zeros((1, 2), "float32")})
        assert ei.value.est_delay_ms is not None
        assert ei.value.slo_ms == 10.0
        ok.result(timeout=30)
        assert b.drain(timeout=30)
    finally:
        b.close()


def test_request_too_long_is_refused_alone():
    b = DynamicBatcher(_StubPredictor(), buckets=(2,), max_delay_ms=1.0,
                       max_seq_len=4)
    try:
        with pytest.raises(RequestTooLong) as ei:
            b.submit({"x": np.zeros((1, 5), "float32")})
        assert ei.value.limit == 4 and ei.value.length == 5
        assert RequestTooLong.from_dict(ei.value.to_dict()).feed == "x"
        out = b.infer({"x": np.ones((1, 4), "float32")}, timeout=30)
        np.testing.assert_array_equal(out[0], np.full((1, 4), 2.0))
        assert b.stats.snapshot()["shed"] == 1
    finally:
        b.close()


def test_manager_serves_an_int8_transformer(tmp_path):
    """A small Transformer through create_predictor -> enable_int8() ->
    ModelManager: every request answered with finite logits, the
    predictor's program stamped, and the f32 replies equal to
    Predictor.run of the row alone."""
    from paddle_tpu_torch.models.transformer import transformer
    T, V = 8, 64
    prog, startup = Program(), Program()
    prog.random_seed = 2
    with program_guard(prog, startup), unique_name.guard():
        src = L.data("src_ids", [T], dtype="int64")
        tgt = L.data("tgt_ids", [T], dtype="int64")
        smk = L.data("src_mask", [T])
        tmk = L.data("tgt_mask", [T])
        logits = transformer(src, tgt, smk, tmk, src_vocab=V, tgt_vocab=V,
                             max_len=T, d_model=32, n_head=2, d_ffn=64,
                             n_layer=1, dropout=0.1)
    scope, exe = Scope(), Executor(CPU)
    d = str(tmp_path / "tfm")
    with scope_guard(scope):
        exe.run(startup)
        tfluid.io.save_inference_model(
            d, ["src_ids", "tgt_ids", "src_mask", "tgt_mask"], [logits], exe,
            main_program=prog)
    rng = np.random.RandomState(3)
    feeds = []
    for _ in range(12):
        n = int(rng.randint(2, T + 1))
        mask = (np.arange(T) < n).astype("float32")[None]
        feeds.append({"src_ids": rng.randint(0, V, (1, T)).astype("int64"),
                      "tgt_ids": rng.randint(0, V, (1, T)).astype("int64"),
                      "src_mask": mask, "tgt_mask": mask.copy()})
    mgr = ModelManager()
    try:
        for name, int8 in (("f32", False), ("int8", True)):
            sm = mgr.load(name, "1", model_dir=d,
                          config=_cpu_config(d, int8), buckets=(1, 2, 4, 8),
                          activate=True, max_delay_ms=5.0)
            stamped = [op for op in sm.predictor.program().global_block.ops
                       if op.attrs.get("quant_int8")]
            assert len(stamped) == (4 + 8 + 2 + 2 + 1 if int8 else 0)
            futs = [mgr.submit(name, f) for f in feeds]
            outs = [f.result(timeout=120)[0] for f in futs]
            for f, o in zip(feeds, outs):
                assert o.shape == (1, T, V) and np.all(np.isfinite(o))
                if not int8:
                    np.testing.assert_allclose(
                        o, sm.predictor.run(f)[0], **TOL)
            snap = mgr.servingz()["models"][f"{name}@1"]
            assert snap["requests"] == 12 and snap["errors"] == 0
    finally:
        mgr.close()
