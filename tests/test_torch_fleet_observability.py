"""The port's fleet observability plane against the JAX package's, on
the CPU.

- ``HealthTable`` transitions, thresholds and retention, and the
  registry's leases (sweep, lazy reap, expiry and goodbye over
  sockets), mirroring ``tests/test_fleet_observability.py``, each also
  run through the reference's modules with the same calls;
- STATS_PULL answered by any port ``RPCServer``, merged by both
  packages' ``FleetAggregator``;
- SLO rules over a port decode engine's metrics give the reference's
  verdicts on the same traffic; the golden canary replays the reference
  engine's greedy tokens through a port ``DecodeServer``'s submit path;
- the port's debug server gives the reference's JSON for the same state
  on ``/healthz``, ``/statusz``, ``/decodez``, ``/servingz`` and
  ``/quantz``, serves ``observability.export()`` on ``/stepz``, and
  serves ``/memz`` and ``/profilez`` with the reference's keys.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import decode as J
from paddle_tpu import observability as JObs
from paddle_tpu import serving as JSv
from paddle_tpu.core import flags as JF
from paddle_tpu.distributed import registry as JReg
from paddle_tpu.distributed import transport as JT
from paddle_tpu_torch import decode as T
from paddle_tpu_torch import observability as TObs
from paddle_tpu_torch import serving as TSv
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.distributed import registry as TReg
from paddle_tpu_torch.distributed import transport as TT

TINY = dict(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
            max_seq_len=32)
ENGINE = dict(max_slots=3, block_tokens=4, prefill_buckets=(8, 16))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 8]]
PKGS = {"port": (T, TObs, TReg, TT, TF, TSv),
        "ref": (J, JObs, JReg, JT, JF, JSv)}


@pytest.fixture
def flags():
    """Set flags on both packages; restore them afterwards."""
    saved = (JF.all_flags(), TF.all_flags())

    def set_both(**kw):
        JF.set_flags(kw)
        TF.set_flags(kw)
    yield set_both
    JF.set_flags(saved[0])
    TF.set_flags(saved[1])


@pytest.fixture
def debug_servers():
    """Both packages' debug servers on ephemeral ports."""
    out = {"port": TObs.debug_server.start(port=0),
           "ref": JObs.debug_server.start(port=0)}
    yield out
    TObs.debug_server.stop()
    JObs.debug_server.stop()


def _get(srv, page):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{page}",
                                timeout=10) as r:
        return json.loads(r.read().decode("utf-8"))


def _params():
    lm = J.TransformerLM(J.LMConfig(**TINY))
    return {k: np.asarray(v) for k, v in lm.init_params(seed=5).items()}


def _engine(pkg, name, **kw):
    kw = {**ENGINE, **kw}
    if pkg == "ref":
        return J.DecodeEngine(J.TransformerLM(J.LMConfig(**TINY)), _params(),
                              name=name, **kw)
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    lm.load_numpy(_params())
    return T.DecodeEngine(lm, name=name, device="cpu", **kw)


def _traffic(pkg, eng):
    """PROMPTS submitted at once (under the engine's lock: one
    schedule), answered, and the engine drained."""
    mod = PKGS[pkg][0]
    with eng._lock:
        hs = [eng.submit(p, mod.SamplingParams(max_new_tokens=4))
              for p in PROMPTS]
    out = [h.result(timeout=60)["tokens"] for h in hs]
    assert eng.drain(timeout=30)
    return out


def _untimed(x):
    """``x`` without the wall-clock and rate fields, recursively."""
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items()
                if not (k.endswith(("_ms", "_s", "_ts"))
                        or k in ("qps", "ts"))}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# health table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_health_state_transitions(pkg):
    obs = PKGS[pkg][1]
    t = obs.HealthTable(suspect_misses=1.0, dead_misses=3.0)
    t.observe("w0", ttl=0.2, role="TRAINER", step=5, trainer_id=0)
    assert t.status("w0") == obs.health.HEALTHY
    time.sleep(0.3)                        # age in (0.2, 0.6]
    assert t.status("w0") == obs.health.SUSPECT
    time.sleep(0.4)                        # age > 0.6
    assert t.status("w0") == obs.health.DEAD
    assert t.dead_trainers() == {0}
    t.observe("w0", ttl=0.2)               # heartbeat resumes
    assert t.status("w0") == obs.health.HEALTHY
    snap = t.snapshot()
    assert snap["w0"]["role"] == "TRAINER" and snap["w0"]["heartbeats"] == 2
    assert obs.stats.default_registry().get(
        "health.workers_healthy").value == 1
    t.forget("w0")
    assert t.status("w0") is None


def test_health_thresholds_retention_and_roles():
    for pkg in ("port", "ref"):
        obs = PKGS[pkg][1]
        with pytest.raises(ValueError):
            obs.HealthTable(suspect_misses=3.0, dead_misses=2.0)
        with pytest.raises(ValueError):
            obs.HealthTable(suspect_misses=1.0, dead_misses=3.0,
                            forget_misses=2.0)
        assert obs.HealthTable(dead_misses=150.0).forget_misses == 1500.0
        assert obs.HealthTable().forget_misses == 120.0
        t = obs.HealthTable(suspect_misses=1.0, dead_misses=2.0,
                            forget_misses=4.0)
        t.observe("ps-0", ttl=0.1, role="PSERVER", trainer_id=0)
        t.observe("trainer-1", ttl=0.1, role="TRAINER", trainer_id=1)
        time.sleep(0.3)                     # age in (0.2, 0.4]
        assert t.status("ps-0") == obs.health.DEAD
        assert t.dead_trainers() == {1}
        time.sleep(0.3)                     # age > 4 * 0.1: reaped
        assert t.status("ps-0") is None and t.snapshot() == {}


# ---------------------------------------------------------------------------
# registry leases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_reg_set_sweeps_and_reg_get_reaps(pkg):
    reg, tr = PKGS[pkg][2], PKGS[pkg][3]
    svc = reg.RegistryService()

    def body(ep, ttl):
        return json.dumps({"endpoint": ep, "ttl": ttl}).encode()
    svc.handle(reg.REG_SET, 0, "ps-old", body("10.0.0.1:1", 0.05))
    svc.handle(reg.REG_SET, 0, "ps-live", body("10.0.0.2:2", 60.0))
    time.sleep(0.1)
    assert "ps-old" in svc._map
    svc.handle(reg.REG_SET, 0, "ps-new", body("10.0.0.3:3", 60.0))
    assert set(svc._map) == {"ps-live", "ps-new"}
    svc.handle(reg.REG_SET, 0, "ps0", body("10.0.0.1:7000", 0.3))
    assert svc.handle(reg.REG_GET, 0, "ps0", b"") == (tr.OK,
                                                     b"10.0.0.1:7000")
    time.sleep(0.4)
    assert svc.handle(reg.REG_GET, 0, "ps0", b"")[0] == tr.ERR
    assert "ps0" not in svc._map
    svc.handle(reg.REG_SET, 0, "ps0", body("10.0.0.9:7001", 60.0))
    assert svc.handle(reg.REG_GET, 0, "ps0", b"") == (tr.OK,
                                                     b"10.0.0.9:7001")


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("port", "ref"),
                                           ("ref", "port")])
def test_registry_leases_over_sockets(server, client):
    """Expiry, re-registration and a heartbeat's goodbye over sockets,
    across the packages."""
    srv = PKGS[server][2].RegistryServer("127.0.0.1:0")
    srv.start()
    reg, tr, obs = PKGS[client][2], PKGS[client][3], PKGS[client][1]
    try:
        ep = f"127.0.0.1:{srv.port}"
        cli = tr.RPCClient(0)
        reg.register(cli, ep, "ps0", "10.0.0.1:7000", ttl=0.2)
        assert reg.resolve(cli, ep, "ps0") == "10.0.0.1:7000"
        time.sleep(0.3)
        assert reg.resolve(cli, ep, "ps0") is None
        reg.register(cli, ep, "ps0", "10.0.0.2:7001", ttl=30.0)
        assert reg.resolve(cli, ep, "ps0") == "10.0.0.2:7001"
        hb = reg.Heartbeat(ep, "trainer-7", "127.0.0.1:9007", ttl=0.1,
                           trainer_id=7, role="TRAINER")
        hb.start()
        assert reg.fetch_health(cli, ep)["trainer-7"]["state"] == \
            obs.health.HEALTHY
        hb.stop(bye=True)
        assert reg.resolve(cli, ep, "trainer-7") is None
        time.sleep(0.4)                 # past dead_misses * ttl: gone
        assert "trainer-7" not in reg.fetch_health(cli, ep)
        snap = reg.fetch_snapshot(cli, ep)
        assert set(snap["leases"]) == {"ps0"}
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# STATS_PULL and the fleet merge
# ---------------------------------------------------------------------------

def test_stats_pull_from_a_port_server_merges_in_both_packages():
    TObs.stats.counter("wire_test.pulls").inc(3)
    srv = TReg.RegistryServer("127.0.0.1:0")
    srv.start()
    try:
        ep = f"127.0.0.1:{srv.port}"
        payloads = [tr.RPCClient(0)._raw_request(ep, tr.STATS_PULL)
                    for tr in (TT, JT)]
        for payload in payloads:
            merged = []
            for pkg in ("port", "ref"):
                agg = PKGS[pkg][1].aggregate
                snap = agg.parse_snapshot(payload)
                assert snap["metrics"]["wire_test.pulls"]["kind"] == \
                    "counter"
                merged.append(agg.merge_snapshots({"w0": snap}))
            assert merged[0] == merged[1]
            assert merged[0]["counters"]["wire_test.pulls"]["total"] == 3
        with pytest.raises(ValueError):
            TObs.aggregate.parse_snapshot(b'{"version": 99, "metrics": {}}')
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# SLO rules and the golden canary against decode engines
# ---------------------------------------------------------------------------

def test_slo_rules_over_decode_engines_match_the_reference(flags):
    flags(phase_attribution=True)
    verdicts = {}
    for pkg in ("port", "ref"):
        obs = PKGS[pkg][1]
        name = f"slo_{pkg}"
        wd = obs.slo.SloWatchdog(
            f"ttft=decode.{name}.ttft_ms:p99>0:for=0.05;"
            f"q=decode.{name}.queue_depth:value>100;"
            f"tok=decode.{name}.tokens:rate>1e9")
        eng = _engine(pkg, name)
        try:
            _traffic(pkg, eng)
            assert wd.evaluate() == []           # first sighting
            _traffic(pkg, eng)
            assert wd.evaluate() == []           # pending: window open
            time.sleep(0.06)
            _traffic(pkg, eng)
            ev = wd.evaluate()
        finally:
            eng.close()
        verdicts[pkg] = ([(e["rule"], e["event"]) for e in ev],
                         wd.breached(), wd.health_dimension(),
                         [r["state"] for r in wd.sloz()["rules"]])
    assert verdicts["port"] == verdicts["ref"]
    assert verdicts["port"][1] == ["ttft"]
    for pkg in ("port", "ref"):
        with pytest.raises(ValueError):
            PKGS[pkg][1].slo.parse_rules("a=m:p42>1")


def test_canary_replays_reference_goldens_through_a_port_server(
        flags, tmp_path):
    """Goldens recorded from the reference engine's greedy streams pass
    on the port's DecodeServer submit path; a drifted golden fails
    there exactly as it fails on the reference's server."""
    ref_eng = _engine("ref", "gold_rec")
    try:
        want = _traffic("ref", ref_eng)
    finally:
        ref_eng.close()
    enc = TObs.canary.encode_array
    cases = [{"feeds": {"prompt": enc(np.asarray(p, np.int32)),
                        "max_new_tokens": enc(np.asarray([4], np.int32))},
              "expect": [["tokens", enc(np.asarray(w, np.int32))]]}
             for p, w in zip(PROMPTS, want)]
    bad = [dict(c, expect=[["tokens", enc(np.asarray(want[0], np.int32)
                                          + 1)]]) for c in cases[:1]]
    results = {}
    for label, model_cases in (("good", cases), ("drifted", bad)):
        path = tmp_path / f"{label}.json"
        path.write_text(json.dumps({"format_version": 1, "provenance": {},
                                    "models": {"lm": {"cases":
                                                      model_cases}}}))
        flags(canary_probe=True, canary_golden_path=str(path),
              canary_fail_streak=1, canary_interval_s=60.0)
        for pkg in ("port", "ref"):
            mod, obs = PKGS[pkg][0], PKGS[pkg][1]
            obs.canary.reset()
            srv = mod.DecodeServer(engines={"lm": _engine(pkg, "lm")},
                                   replica_id="r0")
            srv.start()
            try:
                res = obs.canary.probe_once()
                streak = obs.canary.prober().streaks()["decode/lm/r0"]
                results[(label, pkg)] = (res, obs.canary.health_dimension(),
                                         streak["fail_streak"])
            finally:
                srv.stop()
                obs.canary.reset()
    assert results[("good", "port")] == results[("good", "ref")] == (
        {"decode/lm/r0": True}, {"canary": "ok"}, 0)
    assert results[("drifted", "port")] == results[("drifted", "ref")]
    assert results[("drifted", "port")][0] == {"decode/lm/r0": False}


# ---------------------------------------------------------------------------
# the debug server's pages
# ---------------------------------------------------------------------------

def test_decodez_healthz_quantz_match_the_reference(debug_servers):
    engines = {pkg: _engine(pkg, "dz", cache_dtype="int8")
               for pkg in ("port", "ref")}
    try:
        toks = {pkg: _traffic(pkg, e) for pkg, e in engines.items()}
        assert toks["port"] == toks["ref"]
        pages = {pkg: {p: _get(debug_servers[pkg], p) for p in
                       ("/decodez", "/healthz", "/quantz", "/statusz")}
                 for pkg in ("port", "ref")}
        dz = {pkg: pages[pkg]["/decodez"]["dz"] for pkg in pages}
        assert _untimed(dz["port"]) == _untimed(dz["ref"])
        assert dz["port"] == json.loads(json.dumps(
            engines["port"].decodez(), default=repr)) | {
            k: v for k, v in dz["port"].items() if k.endswith("_ms")}
        assert dz["port"]["tokens"] == len(PROMPTS) * 4
        hz = {pkg: pages[pkg]["/healthz"] for pkg in pages}
        assert set(hz["port"]) == set(hz["ref"])
        for k in ("status", "role", "runtime_stats"):
            assert hz["port"][k] == hz["ref"][k]
        assert "decode" in hz["port"]["activity_age_s"]
        assert hz["port"]["last_step_age_s"] < 60
        qz = {pkg: pages[pkg]["/quantz"] for pkg in pages}
        assert set(qz["port"]) == set(qz["ref"])
        assert qz["port"]["kv_caches"]["dz"] == qz["ref"]["kv_caches"]["dz"]
        sz = {pkg: pages[pkg]["/statusz"] for pkg in pages}
        assert set(sz["port"]) >= {"role", "pid", "argv", "uptime_s",
                                   "constant_labels", "flags"}
        for k in ("role", "pid", "argv"):
            assert sz["port"][k] == sz["ref"][k]
        assert set(sz["port"]["flags"]) == set(sz["ref"]["flags"])
    finally:
        for e in engines.values():
            e.close()
    # closing an engine takes its /decodez section away
    assert "dz" not in _get(debug_servers["port"], "/decodez")


class _StubPredictor:
    feed_names = ["x"]
    fetch_names = ["y"]

    def run(self, feed):
        return [np.asarray(feed["x"]) * 2.0]


def test_servingz_matches_the_reference(debug_servers):
    cards = {}
    for pkg in ("port", "ref"):
        sv = PKGS[pkg][5]
        srv = sv.ModelServer("127.0.0.1:0")
        srv.load("stub", "1", predictor=_StubPredictor(), warm=False,
                 buckets=(1, 2), activate=True, max_delay_ms=0.0)
        srv.start()
        try:
            cli = sv.ServingClient(endpoints=[srv.endpoint])
            for i in range(4):
                cli.infer("stub", {"x": np.full((1, 3), i, "float32")})
            cards[pkg] = _get(debug_servers[pkg], "/servingz")[srv.endpoint]
            hz = _get(debug_servers[pkg], "/healthz")
            assert "serving" in hz["activity_age_s"]
        finally:
            srv.stop()
        assert srv.endpoint not in _get(debug_servers[pkg], "/servingz")
    assert _untimed(cards["port"]) == _untimed(cards["ref"])
    assert cards["port"]["models"]["stub@1"]["requests"] == 4


def test_stepz_serves_export_and_memz_profilez_serve(debug_servers):
    TObs.reset()
    TObs.stats.counter("executor.steps").inc()
    stz = _get(debug_servers["port"], "/stepz")
    assert stz["stats"]["executor.steps"] >= 1
    assert set(stz) == set(TObs.export())
    assert set(stz["step_stats"]) == set(TObs.export()["step_stats"])
    assert TObs.enabled() == JObs.enabled()
    for page in ("/memz", "/profilez"):
        got = _get(debug_servers["port"], page)
        want = _get(debug_servers["ref"], page)
        assert set(got) == set(want), page
    mz = _get(debug_servers["port"], "/memz")
    assert set(_get(debug_servers["ref"], "/memz")["devices"][0]) <= \
        set(mz["devices"][0])
    pz = _get(debug_servers["port"], "/profilez")
    assert set(pz["platform_peaks"]) == set(
        _get(debug_servers["ref"], "/profilez")["platform_peaks"])
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(debug_servers["port"], "/nope")
    assert ei.value.code == 404
    # the exports the reference's package has
    want = {n for n in dir(JObs) if not n.startswith("_")} - {
        "annotations"}
    assert want <= {n for n in dir(TObs) if not n.startswith("_")}
