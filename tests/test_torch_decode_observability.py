"""The port's observability and fault hooks against the JAX package's,
on the CPU.

The copied ``phase``, ``tenant``, ``capacity``, ``flight``, ``audit``,
``faults`` and ``trace`` modules give the JAX modules' snapshots on the
same calls (clocks and random ids pinned).  With the phase, memory,
tenant and capacity flags on, the port's DecodeEngine and
DynamicBatcher give the JAX engine's and batcher's counters on the same
traffic.  The memory ledger's identity holds exactly on the host,
``is_oom`` recognises ``torch.cuda.OutOfMemoryError`` and the injected
error, and an injected ``oom:decode_step`` is recovered through
preemption with the streams token-exact.
"""
import random
import time

import numpy as np
import pytest
import torch

from paddle_tpu import decode as J
from paddle_tpu import profiler as JP
from paddle_tpu.core import flags as JF
from paddle_tpu.distributed import faults as JFa
from paddle_tpu.observability import (audit as JAu, capacity as JCap,
                                      flight as JFl, memory as JMem,
                                      phase as JPh, tenant as JTen,
                                      trace as JTr)
from paddle_tpu.serving import batcher as JB
from paddle_tpu_torch import decode as T
from paddle_tpu_torch import profiler as TP
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.distributed import faults as TFa
from paddle_tpu_torch.observability import (audit as TAu, capacity as TCap,
                                            flight as TFl, memory as TMem,
                                            phase as TPh, tenant as TTen,
                                            trace as TTr)
from paddle_tpu_torch.serving import batcher as TB

TINY = dict(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
            max_seq_len=32)
ENGINE = dict(max_slots=3, block_tokens=4, prefill_buckets=(8,),
              num_blocks=9, overcommit=True)
PROMPTS = [np.arange(1 + 7 * i, 7 + 7 * i, dtype=np.int32)
           for i in range(3)]
TENANTS = ["acme", "beta", "acme"]
HOOK_FLAGS = dict(phase_attribution=True, memory_attribution=True,
                  tenant_accounting=True, capacity_attribution=True,
                  memory_audit_interval_s=0.0)

J_MODS = dict(phase=JPh, tenant=JTen, capacity=JCap, flight=JFl,
              audit=JAu, faults=JFa, trace=JTr, profiler=JP, flags=JF,
              memory=JMem)
T_MODS = dict(phase=TPh, tenant=TTen, capacity=TCap, flight=TFl,
              audit=TAu, faults=TFa, trace=TTr, profiler=TP, flags=TF,
              memory=TMem)


@pytest.fixture
def flags():
    """Set flags on both packages; restore them and the process-wide
    recorders after the test."""
    saved = (JF.all_flags(), TF.all_flags())

    def set_both(**kw):
        JF.set_flags(kw)
        TF.set_flags(kw)

    def clear_recorders():
        # before the test too: a worker that ran other files first may
        # have left events and records in either package's recorders
        for mods in (J_MODS, T_MODS):
            mods["tenant"].reset()
            mods["capacity"].reset()
            mods["memory"].reset()
            mods["faults"].clear()
            mods["flight"].clear_events()
    clear_recorders()
    yield set_both
    for mods, old in ((J_MODS, saved[0]), (T_MODS, saved[1])):
        mods["flags"].set_flags(old)
    clear_recorders()


def _drop(x, keys=("ts",)):
    """``x`` without the wall-clock fields, recursively."""
    if isinstance(x, dict):
        return {k: _drop(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, list):
        return [_drop(v, keys) for v in x]
    return x


# ---------------------------------------------------------------------------
# the copied modules: the same calls, the same snapshots
# ---------------------------------------------------------------------------

def _phase(m, clock):
    rec = m["phase"].PhaseRecorder("obs.phase", ("queue", "prefill",
                                                 "decode"))
    for i, (q, p, d) in enumerate(((2.0, 8.0, 40.0), (0.5, 3.0, 700.0),
                                   (9.0, 1.0, 12.0))):
        tl = m["phase"].PhaseTimeline(t0=100.0)
        tl.stamp("queue", t=100.0 + q / 1e3)
        tl.stamp("prefill", t=100.0 + (q + p) / 1e3)
        tl.stamp("decode", t=100.0 + (q + p + d) / 1e3)
        rec.observe(tl, trace_id=0xABC + i, rid=i, tokens=3)
    return [rec.snapshot(), rec.phase_p99_ms()]


def _tenant(m, clock):
    t = m["tenant"].TenantMeter(k=2)
    t.account("acme", requests=1, prefill_tokens=6, device_ms=1.25)
    t.account("beta", requests=2, decode_tokens=4, latency_ms=3.0)
    t.account("acme", resident_kv_bytes=4096, latency_ms=5.0)
    t.account("gamma", requests=1, cancellations=1)   # evicts the lightest
    t.account(None, rows=3)
    return t.snapshot()


def _capacity(m, clock):
    tr = m["capacity"].CapacityTracker("obs.cap", ("prefill", "decode"))
    for k in range(5):
        clock[0] += 0.01
        tr.note("prefill", 2.0 + k, bucket=16, work=1)
        tr.note("decode", 6.0, work=3)
        tr.note_done(1)
    clock[0] += 0.05
    return [tr.snapshot(window_s=10.0), tr.headroom()]


def _flight(m, clock):
    m["flight"].clear_events()
    m["flight"].note("failover", site="decode_step", n=3)
    m["flight"].note("oom_forensics", top_holder="decode_kv.x")
    return [m["flight"].events(), sorted(m["flight"].snapshot("t"))]


def _audit(m, clock):
    A = m["audit"]
    h = A.fnv1a64(b"")
    for t in (3, -1, 47, 2 ** 31 - 1):
        h = A.fold_token(h, t)
    feeds = {"x": np.arange(6, dtype=np.int32).reshape(2, 3),
             "y": np.float32([0.5, -2.0])}
    ring = A.AuditRing()
    ring.note("lm", "", A.request_hash(feeds), format(h, "016x"))
    return [h, A.request_hash(feeds), A.request_hash(np.arange(5)),
            A.digest_pairs([(1, 2), (3, 4)]), ring.recent(),
            ring.snapshot()]


def _faults(m, clock):
    F = m["faults"]
    F.clear()
    rules = F.inject("delay:decode_step:ms=0;oom:decode_step:n=2,times=1;"
                     "kill_after:decode_preempt:n=99")
    fired = []
    for _ in range(4):
        try:
            F.event("decode_step")
            F.oom_fault("decode_step")
            fired.append(None)
        except F.InjectedResourceExhausted as e:
            fired.append(str(e))
    out = [rules, fired, F.list_rules(), F.active()]
    F.clear()
    return out + [F.active()]


def _trace(m, clock):
    Tr = m["trace"]
    ctx = Tr.SpanContext(0x1234, 0x99, True)
    wire = Tr.ctx_to_wire(ctx)
    Tr.clear_spans()
    with Tr.start_span("serving::dispatch", cat="serving", root=False):
        pass                                 # no context: a no-op
    with Tr.start_span("root", tags={"k": 1}):
        with Tr.start_span("child", cat="serving"):
            pass
    spans = [dict(s, tid=0) for s in Tr.spans()]
    out = [wire, Tr.ctx_from_wire(wire), Tr.ctx_from_wire(b"xx"), spans,
           Tr.total_spans_recorded()]
    Tr.clear_spans()
    return out


SCENARIOS = dict(phase=_phase, tenant=_tenant, capacity=_capacity,
                 flight=_flight, audit=_audit, faults=_faults, trace=_trace)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_copied_modules_give_the_reference_snapshots(name, flags,
                                                     monkeypatch):
    flags(trace_sample_rate=1.0, runtime_stats=True)
    out = []
    for mods in (J_MODS, T_MODS):
        clock = [1000.0]
        ns = [5_000_000_000]

        def tick_ns():
            ns[0] += 1000
            return ns[0]
        monkeypatch.setattr(time, "monotonic", lambda: clock[0])
        monkeypatch.setattr(time, "time", lambda: 1.7e9)
        monkeypatch.setattr(time, "time_ns", tick_ns)
        monkeypatch.setattr(mods["trace"], "_rng", random.Random(11))
        out.append(SCENARIOS[name](mods, clock))
        monkeypatch.undo()
    ref, got = out
    assert got == ref
    assert got                                 # the scenario observed


# ---------------------------------------------------------------------------
# the engine and the batcher with the hooks on
# ---------------------------------------------------------------------------

def _engine(pkg, name, **kw):
    kw = {**ENGINE, **kw}
    if pkg is J:
        lm = J.TransformerLM(J.LMConfig(**TINY))
        return J.DecodeEngine(lm, lm.init_params(seed=5), name=name, **kw)
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    return T.DecodeEngine(lm, lm.init_params(seed=5), name=name,
                          device="cpu", **kw)


def _hooked_run(pkg, mods, name):
    eng = _engine(pkg, name)
    try:
        # submitted under the engine's lock, so the scheduler thread sees
        # all prompts at once and the schedule depends on the traffic only
        with eng._lock:
            hs = [eng.submit(p, pkg.SamplingParams(max_new_tokens=10),
                             tenant=t)
                  for p, t in zip(PROMPTS, TENANTS)]
        res = [h.result(timeout=120) for h in hs]
        assert eng.drain(timeout=30)
        z = eng.decodez()
        ten = mods["tenant"].meter().snapshot()
        events = [(e["kind"], e["pool"], e["bytes"])
                  for e in mods["memory"].events()]
        led = mods["memory"].ledger()
        pool = led["pools"][f"decode_kv.{name}"]
        cap = z["capacity"]
        out = dict(
            tokens=[r["tokens"] for r in res],
            goodput=z["goodput"],
            phases_observed=z["phases"]["observed"],
            phase_names=sorted(z["phases"]["phases"]),
            samples=[_drop(s, ("ts", "phases", "total_ms"))
                     for s in z["phases"]["recent"]],
            preemption=z["preemption"], block_pool=z["block_pool"],
            tenants={t: {k: v for k, v in d.items()
                         if k not in ("device_ms", "p99_ms")}
                     for t, d in ten["tenants"].items()},
            events=events,
            pool={k: v for k, v in pool.items() if k != "device"},
            capacity=(sorted(cap["components"]), cap["completed"],
                      {c: {b: f["count"] for b, f in v.items()}
                       for c, v in cap["bucket_fits"].items()}))
        return out, z, led, eng
    except BaseException:
        eng.close()
        raise


def test_engine_hooks_give_the_jax_engines_counters(flags):
    flags(**HOOK_FLAGS)
    ref, _, _, jeng = _hooked_run(J, J_MODS, "obs_lm")
    jeng.close()
    got, z, led, eng = _hooked_run(T, T_MODS, "obs_lm")
    try:
        assert got == ref
        assert got["preemption"]["preempts"] >= 1
        # the three phases of every request sum to its wall
        for s in z["phases"]["recent"]:
            assert list(s["phases"]) == ["queue", "prefill", "decode"]
            assert abs(sum(s["phases"].values()) - s["total_ms"]) < 5e-3
        assert z["goodput"]["live_slot_steps"] > 0
        # every tenant's resident KV returns to 0 once its streams end
        assert all(d["resident_kv_bytes"] == 0
                   for d in TTen.meter().snapshot()["tenants"].values())
        # the memory identity, exactly, on the host
        pool = led["pools"]["decode_kv.obs_lm"]
        assert pool["reserved"] == eng.cache.nbytes
        dev = led["devices"]["cpu"]
        assert dev["attributed"] + dev["unattributed_bytes"] == \
            dev["bytes_in_use"]
        assert dev["bytes_in_use"] == eng.cache.nbytes
        assert dev["unattributed_bytes"] == 0
        assert TMem.run_audit() == {}
    finally:
        eng.close()
    assert "decode_kv.obs_lm" not in TMem.pools()


def test_memory_identity_counts_each_storage_once(flags):
    flags(memory_attribution=True)
    base = torch.zeros(64, 8)
    TMem.pool("obs.views", "device", lambda: {"reserved": base.nbytes},
              device="cpu", tensors=lambda: [base, base[:16], base[3]])
    TMem.pool("obs.other", "device", lambda: {"used": 100},
              device="cpu", tensors=lambda: [torch.ones(25)])
    led = TMem.ledger()
    dev = led["devices"]["cpu"]
    assert dev["bytes_in_use"] == base.nbytes + 100
    assert dev["attributed"] == base.nbytes + 100
    assert dev["attributed"] + dev["unattributed_bytes"] == \
        dev["bytes_in_use"]
    assert TMem.device_key("cuda:1") == "d1" and TMem.device_key(0) == "d0"


def test_is_oom_recognises_card_and_injected_errors():
    card = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")
    assert TMem.is_oom(card)
    assert TMem.is_oom(TFa.InjectedResourceExhausted("decode_step"))
    assert JMem.is_oom(JFa.InjectedResourceExhausted("decode_step"))
    assert not TMem.is_oom(RuntimeError("CUDA error: illegal address"))
    assert not TMem.is_oom(ValueError("out of range"))


def _oom_counters(mods, name):
    """The package's OOM counters: its engine's and ``memory.oom_dumps``."""
    sc = f"decode.{name}"
    return {k: v for k, v in
            mods["memory"]._stats.default_registry().to_dict().items()
            if k.startswith(sc + ".oom") or k == "memory.oom_dumps"}


def _oom_run(pkg, mods, name):
    # the counters are process-wide and outlive a test file: a worker
    # that ran other files first may hold earlier OOM dumps, so the run
    # is judged by what it added
    before = _oom_counters(mods, name)
    mods["faults"].inject("oom:decode_step:n=3,times=1")
    eng = _engine(pkg, name)
    try:
        with eng._lock:                  # one schedule, as in _hooked_run
            hs = [eng.submit(p, pkg.SamplingParams(max_new_tokens=10))
                  for p in PROMPTS]
        res = [h.result(timeout=120) for h in hs]
        rec = mods["memory"].last_oom()
        reg = {k: v - before.get(k, 0)
               for k, v in _oom_counters(mods, name).items()}
        return ([r["tokens"] for r in res], [r["finish"] for r in res],
                eng.decodez()["preemption"], reg,
                rec["site"], rec["top_holders"][0]["pool"],
                eng.cache.allocator.leaked())
    finally:
        eng.close()
        mods["faults"].clear()


def test_injected_oom_is_recovered_through_preemption(flags):
    flags(memory_attribution=True, memory_audit_interval_s=0.0)
    ref = _oom_run(J, J_MODS, "obs_oom")
    got = _oom_run(T, T_MODS, "obs_oom")
    assert got == ref
    toks, finish, pre, reg, site, top, leaked = got
    assert finish == ["length"] * 3 and leaked == 0
    assert site == "decode_step" and top == "decode_kv.obs_oom"
    assert any(v == 1 for k, v in reg.items() if k.endswith("oom_recovered"))
    # still the tokens of an engine that never ran out
    full = _engine(T, "obs_oom_full", num_blocks=None, overcommit=False)
    try:
        want = [full.generate(p, max_new_tokens=10)["tokens"]
                for p in PROMPTS]
    finally:
        full.close()
    assert toks == want


class _Stub:
    """A predictor: y = 2x + 1 on a [B, 3] float32 feed."""
    feed_names = ["x"]
    fetch_names = ["y"]

    def run(self, feed):
        return [feed["x"] * 2.0 + 1.0]


def _batcher_run(B, mods, name):
    b = B.DynamicBatcher(_Stub(), name=name, buckets=(1, 2, 4),
                         max_delay_ms=0.0)
    try:
        outs = []
        for i, (rows, t) in enumerate(((1, "acme"), (3, "beta"),
                                       (2, "acme"), (4, None))):
            x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3) + i
            outs.append(b.infer({"x": x}, timeout=30, tenant=t)[0].tolist())
        snap = b.stats.snapshot()
        ten = mods["tenant"].meter().snapshot()["tenants"]
        pool = mods["memory"].ledger()["pools"][f"serving_staging.{name}"]
        return dict(
            outs=outs,
            counts={k: snap[k] for k in ("requests", "rows", "batches",
                                         "padded_rows", "errors")},
            phases=(snap["phases"]["observed"],
                    sorted(snap["phases"]["phases"])),
            capacity=(sorted(snap["capacity"]["components"]),
                      snap["capacity"]["completed"]),
            tenants={t: {k: d[k] for k in ("requests", "rows")}
                     for t, d in ten.items()},
            pool=(pool["kind"], pool["used"])), snap
    finally:
        b.close()


def test_batcher_hooks_give_the_jax_batchers_counters(flags):
    flags(**HOOK_FLAGS)
    ref, _ = _batcher_run(JB, J_MODS, "obs_srv")
    got, snap = _batcher_run(TB, T_MODS, "obs_srv")
    assert got == ref
    assert got["phases"] == (4, sorted(TB.SERVING_PHASES))
    for s in snap["phases"]["recent"]:
        assert abs(sum(s["phases"].values()) - s["total_ms"]) < 5e-3
    assert "serving_staging.obs_srv" not in TMem.pools()


def test_injected_dispatch_oom_reaches_the_futures(flags):
    flags(memory_attribution=True)
    TFa.inject("oom:serving_dispatch:n=1,times=1")
    b = TB.DynamicBatcher(_Stub(), name="obs_srv_oom", buckets=(1,),
                          max_delay_ms=0.0)
    try:
        with pytest.raises(TFa.InjectedResourceExhausted):
            b.infer({"x": np.zeros((1, 3), np.float32)}, timeout=30)
        assert TMem.last_oom()["site"] == "serving_dispatch"
        assert b.infer({"x": np.ones((1, 3), np.float32)},
                       timeout=30)[0].tolist() == [[3.0, 3.0, 3.0]]
    finally:
        b.close()


def test_profiler_spans_and_device_trace(tmp_path, flags):
    """``trace.enabled()`` follows the port's profiler; a device trace
    armed by ``enable_device_trace`` writes torch.profiler's Chrome
    trace (CPU activity here)."""
    flags(runtime_stats=True)
    assert not TTr.enabled()
    TP.reset_profiler()
    TP.enable_device_trace(str(tmp_path))
    TP.start_profiler("All")
    assert TTr.enabled()
    with TTr.span("decode::step"):
        torch.ones(4).sum()
    TP.stop_profiler(sorted_key=None)
    assert not TTr.enabled()
    assert [e["name"] for e in TP.events()] == ["runtime::decode::step"]
    assert (tmp_path / "device_trace.json").exists()
