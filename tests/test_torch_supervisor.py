"""The port's fleet supervisor (stateless roles) against
``tests/test_supervisor.py``'s cases, and the chaos drill of
``tests/test_decode_prefix.py`` on the port's decode replicas, on the
CPU.

- The worker state machine: spawn, LIVE, a SIGKILLed worker replaced
  (``/fleetz`` history STARTING→LIVE→DEAD→REPLACING→STARTING→LIVE); a
  crash loop held at its budget and resumed; a clean exit of a service
  worker counted as a death; an action deadline; a wedged lease killed.
- Elastic grow and drain through a stub controller, clamped to the
  target; flap damping, with both packages' ``ElasticController`` given
  the same health views (stubbed, and a live registry) and deciding
  alike.
- ``/fleetz`` over HTTP and its admin commands, through
  ``tools/fleet_torch.py``; the spec file round trip and the CLI's
  parser; a spec with rollback roles or checkpoint fields refused when
  it is built, and the ``cut`` command refused.
- The chaos drill: two overcommitted port decode replicas
  (``tests/torch_decode_replica_runner.py`` on the CPU at the
  reference runner's width); r1 armed to die at its first preemption.
  r0's streams, and the respawned r1's, are token-exact against the JAX
  package's uninterrupted engine on the same seeded weights, and each
  surviving pool drains with no leaked block.
"""
import json
import os
import signal
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from paddle_tpu import decode as J
from paddle_tpu.checkpoint.elastic import ElasticController as JElastic
from paddle_tpu_torch.checkpoint.elastic import ElasticController as TElastic
from paddle_tpu_torch.decode import DecodeClient
from paddle_tpu_torch.decode import server as dserver
from paddle_tpu_torch.distributed import registry as reg_mod
from paddle_tpu_torch.distributed import transport
from paddle_tpu_torch.distributed.supervisor import (LIVE, FleetSpec,
                                                     RoleSpec, Supervisor)
from paddle_tpu_torch.observability import debug_server, flight
from paddle_tpu_torch.observability import stats as obs_stats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RUNNER = os.path.join(HERE, "torch_decode_replica_runner.py")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import fleet_torch  # noqa: E402

SLEEPER = [sys.executable, "-c", "import time; time.sleep(120)"]
CRASHER = [sys.executable, "-c", "import sys; sys.exit(3)"]


def _wait(cond, timeout=20.0, poll=0.03, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(poll)
    pytest.fail(f"timed out waiting for {msg}")


def _worker(sup, name):
    return next(w for w in sup.status()["workers"] if w["name"] == name)


def _counter(name):
    return obs_stats.scope("supervisor").counter(name).value


# ---------------------------------------------------------------------------
# the state machine
# ---------------------------------------------------------------------------

def test_spawn_live_replace_and_fleetz_state_machine():
    spec = FleetSpec(roles={"sleeper": RoleSpec(
        count=2, argv=SLEEPER, backoff_s=0.03)}, name="t_sm")
    sup = Supervisor(spec, poll_s=0.03).start()
    try:
        _wait(lambda: all(w["state"] == "LIVE"
                          for w in sup.status()["workers"]),
              msg="both sleepers LIVE")
        os.kill(_worker(sup, "sleeper-0")["pid"], signal.SIGKILL)
        _wait(lambda: _worker(sup, "sleeper-0")["spawns"] == 2
              and _worker(sup, "sleeper-0")["state"] == "LIVE",
              msg="sleeper-0 replaced")
        states = [h["state"] for h in _worker(sup, "sleeper-0")["history"]]
        assert states == ["STARTING", "LIVE", "DEAD", "REPLACING",
                          "STARTING", "LIVE"], states
        assert _worker(sup, "sleeper-1")["spawns"] == 1
    finally:
        sup.stop()


@pytest.mark.chaos_lite
def test_crashloop_exhausts_budget_and_holds():
    budget = 2
    spec = FleetSpec(roles={
        "flaky": RoleSpec(count=1, argv=CRASHER, restart_budget=budget,
                          backoff_s=0.02, restart_window_s=60.0),
        "steady": RoleSpec(count=1, argv=SLEEPER),
    }, name="t_crashloop")
    flight.clear_events()
    sup = Supervisor(spec, poll_s=0.02).start()
    try:
        _wait(lambda: sup.status()["state"] == "HOLD", msg="HOLD")
        time.sleep(0.3)
        flaky = _worker(sup, "flaky-0")
        assert flaky["state"] == "HELD"
        assert flaky["spawns"] <= 1 + budget, flaky
        assert sup.status()["roles"]["flaky"]["hold"]
        assert _worker(sup, "steady-0")["state"] == "LIVE"
        assert obs_stats.scope("supervisor").gauge("crashloop").value == 1
        notes = [e for e in flight.events()
                 if e["msg"] == "supervisor_crashloop"]
        assert notes and notes[0]["role"] == "flaky"
        sup.resume_role("flaky")
        assert sup.status()["state"] == "RUNNING"
        _wait(lambda: _worker(sup, "flaky-0")["spawns"] >= 2 + budget,
              msg="post-resume respawn")
    finally:
        sup.stop()
    assert obs_stats.scope("supervisor").gauge("crashloop").value == 0


def test_clean_exit_of_service_role_is_a_death():
    spec = FleetSpec(roles={"svc": RoleSpec(
        count=1, argv=[sys.executable, "-c", "pass"], restart_budget=1,
        backoff_s=0.02, restart_window_s=60.0)}, name="t_cleanexit")
    sup = Supervisor(spec, poll_s=0.02).start()
    try:
        _wait(lambda: sup.status()["state"] == "HOLD",
              msg="clean-exit crash loop fenced")
        w = _worker(sup, "svc-0")
        assert w["last_rc"] == 0 and w["spawns"] <= 2, w
        assert sup.status()["roles"]["svc"]["deaths_in_window"] >= 2
    finally:
        sup.stop()


def test_action_deadline_bounds_wedged_spawn():
    before = _counter("action_timeouts")
    spec = FleetSpec(roles={"wedge": RoleSpec(
        count=1, argv=SLEEPER, logical="auto", restart_budget=0,
        action_deadline_s=0.3, backoff_s=0.02)}, name="t_wedge")
    sup = Supervisor(spec, poll_s=0.03).start()
    try:
        _wait(lambda: sup.status()["state"] == "HOLD",
              msg="wedged spawn timed out into HOLD")
        assert _counter("action_timeouts") > before
        w = _worker(sup, "wedge-0")
        assert w["last_rc"] is not None and w["last_rc"] != 0, w
    finally:
        sup.stop()


def test_wedged_lease_dead_kills_and_replaces():
    spec = FleetSpec(roles={"ps": RoleSpec(
        count=1, argv=SLEEPER, logical="auto", backoff_s=0.02,
        restart_budget=3)}, name="t_wedged")
    sup = Supervisor(spec, poll_s=0.05, registry_poll_s=0.1).start()
    try:
        logical = sup.status()["workers"][0]["logical"]
        reg_mod.register(transport.RPCClient(0), sup.registry_ep, logical,
                         "127.0.0.1:1", ttl=0.15,
                         health={"role": "PSERVER"})
        _wait(lambda: _worker(sup, "ps-0")["state"] == "LIVE",
              msg="lease-gated LIVE")
        first_pid = _worker(sup, "ps-0")["pid"]
        _wait(lambda: _worker(sup, "ps-0")["spawns"] == 2,
              msg="wedged worker killed + respawned")
        assert _worker(sup, "ps-0")["pid"] != first_pid
        assert _counter("wedged_kills") >= 1
    finally:
        sup.stop()


# ---------------------------------------------------------------------------
# elastic decisions
# ---------------------------------------------------------------------------

class _StubController:
    def __init__(self, alive_n=1):
        self.alive_n = alive_n

    def decide(self, role, target):
        n = self.alive_n
        action = "hold" if n == target else ("grow" if n < target
                                             else "shrink")
        return {"action": action, "delta": abs(target - n),
                "target": target, "alive": []}


def test_elastic_decisions_drive_grow_and_drain_idempotently():
    ctl = _StubController(alive_n=1)
    spec = FleetSpec(roles={"svc": RoleSpec(
        count=1, argv=SLEEPER, target=2, backoff_s=0.02,
        grace_s=0.2)}, name="t_elastic")
    sup = Supervisor(spec, controller=ctl, poll_s=0.03).start()
    try:
        _wait(lambda: any(w["name"] == "svc-1" and w["state"] == "LIVE"
                          for w in sup.status()["workers"]),
              msg="grown to 2")
        time.sleep(0.4)
        st = sup.status()
        assert len(st["workers"]) == 2, st["workers"]
        assert st["roles"]["svc"]["count"] == 2
        ctl.alive_n = 2
        sup.spec.roles["svc"].target = 1
        _wait(lambda: _worker(sup, "svc-1")["state"] == "DEAD",
              msg="svc-1 drained")
        time.sleep(0.4)
        assert _worker(sup, "svc-0")["state"] == "LIVE"
        assert sup.status()["roles"]["svc"]["count"] == 1
        assert _counter("drains") >= 1
    finally:
        sup.stop()


def _damped(cls):
    """``tests/test_supervisor.py``'s flap-damping sequence through one
    package's controller (its ``fleet_view`` stubbed); the decisions."""
    ctl = cls.__new__(cls)
    ctl.poll_ttl = 0.0
    ctl.hysteresis = 3
    ctl._streak = {}
    ctl._snap_cache = {"t": float("inf"), "data": {}}
    views = {"n": 0}

    def fleet_view(refresh=False):
        ctl._cache = {"t": views["n"], "table": views["table"]}
        return views["table"]
    ctl.fleet_view = fleet_view
    out = []

    def observe(states):
        views["n"] += 1
        views["table"] = {f"w{i}": {"role": "PSERVER", "state": s}
                          for i, s in enumerate(states)}
        out.append(ctl.decide("PSERVER", 2))
    observe(["HEALTHY", "DEAD"])
    observe(["HEALTHY", "SUSPECT"])
    for _ in range(3):
        observe(["HEALTHY", "DEAD"])
    ctl._streak.clear()
    views["n"] += 1
    for _ in range(5):
        out.append(ctl.decide("PSERVER", 2))
    return out


def test_elastic_controller_flap_damping_matches_the_reference():
    got, want = _damped(TElastic), _damped(JElastic)
    assert got == want
    assert [(d["action"], d["streak"]) for d in got] == [
        ("hold", 1), ("hold", 0), ("hold", 1), ("hold", 2), ("grow", 3),
        ("hold", 1), ("hold", 1), ("hold", 1), ("hold", 1), ("hold", 1)]


def test_elastic_controllers_decide_alike_on_a_live_registry():
    srv = reg_mod.RegistryServer("127.0.0.1:0")
    srv.start()
    try:
        ep = f"127.0.0.1:{srv.port}"
        reg_mod.register(transport.RPCClient(0), ep, "w0", "127.0.0.1:9",
                         ttl=30.0, health={"role": "DECODE"})
        decisions = [cls(ep, poll_ttl=0.0, hysteresis=1).decide("DECODE", 2)
                     for cls in (TElastic, JElastic)]
    finally:
        srv.stop()
    assert decisions[0] == decisions[1]
    assert decisions[0]["action"] == "grow" and decisions[0]["delta"] == 1


# ---------------------------------------------------------------------------
# /fleetz, the spec file and the CLI
# ---------------------------------------------------------------------------

def test_fleetz_http_status_and_admin():
    spec = FleetSpec(roles={"svc": RoleSpec(
        count=1, argv=SLEEPER, backoff_s=0.02, grace_s=0.2)},
        name="t_httpfleet")
    sup = Supervisor(spec, poll_s=0.03).start()
    srv = debug_server.DebugServer(port=0)
    srv.start()
    try:
        _wait(lambda: _worker(sup, "svc-0")["state"] == "LIVE", msg="LIVE")
        base = f"http://127.0.0.1:{srv.port}/fleetz"
        card = json.loads(urllib.request.urlopen(base).read())
        assert card["t_httpfleet"]["state"] == "RUNNING"
        assert card["t_httpfleet"]["workers"][0]["state"] == "LIVE"
        out = json.loads(urllib.request.urlopen(
            base + "?resize=svc:2").read())
        assert out["t_httpfleet"]["action"] == "grow"
        _wait(lambda: any(w["name"] == "svc-1" and w["state"] == "LIVE"
                          for w in sup.status()["workers"]),
              msg="grown via /fleetz")
        json.loads(urllib.request.urlopen(base + "?drain=svc-1").read())
        _wait(lambda: _worker(sup, "svc-1")["state"] == "DEAD",
              msg="drained via /fleetz")
        ep = f"127.0.0.1:{srv.port}"
        assert "t_httpfleet" in fleet_torch.fleetz_request(ep, {})
        bad = fleet_torch.fleetz_request(ep, {"resize": "nosuch:3"})
        assert "error" in bad
        cut = fleet_torch.fleetz_request(ep, {"cut": "1"})
        assert "checkpoint plane" in cut["error"]
    finally:
        srv.stop()
        sup.stop()


def test_fleet_spec_file_roundtrip_and_cli_parser(tmp_path):
    spec = FleetSpec(
        registry="auto", hysteresis=3, name="rt",
        roles={"decode": RoleSpec(count=2, argv=["x"], logical="auto",
                                  health_role="DECODE",
                                  env={"A": "{logical}"},
                                  env_once={0: {"F": "1"}}),
               "tr": RoleSpec(count=1, argv=["y"], after=["decode"],
                              after_live=False, done_ok=True)})
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(spec.to_dict()))
    back = FleetSpec.from_file(str(path))
    assert back.to_dict() == spec.to_dict()
    with pytest.raises(ValueError):
        FleetSpec.from_dict({"roles": {"a": {"count": 1, "argv": ["x"],
                                             "bogus": 1}}})
    with pytest.raises(ValueError):
        FleetSpec(roles={"a": RoleSpec(1, ["x"], after=["b"])})
    p = fleet_torch.build_parser()
    args = p.parse_args(["launch", str(path), "--debug-port", "8080"])
    assert args.cmd == "launch" and args.debug_port == 8080
    args = p.parse_args(["resize", "127.0.0.1:8080", "decode", "3"])
    assert (args.cmd, args.role, args.count) == ("resize", "decode", "3")
    with pytest.raises(SystemExit):
        p.parse_args(["cut", "127.0.0.1:8080"])


@pytest.mark.parametrize("field,value", [
    ("rollback_roles", ["ps"]), ("checkpoint_root", "/ck"),
    ("checkpoint_every_s", 5.0), ("cut_role", "ps")])
def test_rollback_spec_is_refused_before_anything_starts(field, value):
    roles = {"ps": {"count": 1, "argv": ["x"]}}
    with pytest.raises(NotImplementedError, match="checkpoint plane"):
        FleetSpec.from_dict({"roles": roles, field: value})


# ---------------------------------------------------------------------------
# the chaos drill
# ---------------------------------------------------------------------------

TINY = dict(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
            max_seq_len=32)
PROMPT_A = np.array([1, 2, 3, 4, 5, 6], dtype=np.int32)
PROMPT_B = np.array([7, 8, 9, 10, 11, 12], dtype=np.int32)


def _decode_eps(registry_ep):
    snap = reg_mod.fetch_snapshot(transport.RPCClient(0), registry_ep)
    out = {}
    for logical, lease in (snap.get("leases") or {}).items():
        parsed = dserver.parse_replica_key(logical)
        if parsed is not None and parsed[0] == "lm":
            out[parsed[1]] = lease["endpoint"]
    return out


@pytest.mark.chaos_lite
def test_chaos_kill_mid_preemption_port_replicas(tmp_path):
    """The reference's drill on the port's replicas: r1 hard-dies at its
    first preemption; r0's streams finish token-exact, the supervisor
    respawns r1 (DEAD → REPLACING → STARTING → LIVE), the replacement
    serves token-exact, and both pools drain with no leaked block."""
    lm = J.TransformerLM(J.LMConfig(**TINY))
    ref = J.DecodeEngine(lm, lm.init_params(seed=5), name="t_chaos_ref",
                         max_slots=4, block_tokens=4, prefill_buckets=(8,))
    try:
        refA = ref.generate(PROMPT_A, max_new_tokens=20)["tokens"]
        refB = ref.generate(PROMPT_B, max_new_tokens=20)["tokens"]
    finally:
        ref.close()
    seed_file = tmp_path / "seed.json"
    seed_file.write_text(json.dumps({"seed": 5}))
    keys = [dserver.replica_key("lm", f"r{i}") for i in range(2)]
    spec = FleetSpec(
        roles={"decode": RoleSpec(
            count=2, argv=[sys.executable, RUNNER],
            env={"PADDLE_REGISTRY": "{registry}", "REPLICA_ID": "r{index}",
                 "REPLICA_DEVICE": "cpu", "REPLICA_WIDTH": "tiny",
                 "REPLICA_SEED_FILE": str(seed_file),
                 "REPLICA_REPORT": str(tmp_path / "{name}-{spawn}.json")},
            env_once={1: {"FLAGS_fault_inject":
                          "kill_after:decode_preempt"}},
            logical=keys, health_role="DECODE", grace_s=20.0)},
        hysteresis=2, name="t_chaos")
    sup = Supervisor(spec, poll_s=0.1, registry_poll_s=0.25).start()
    r0_out, r0_errs, r1_errs, r1_done = [], [], [], []
    try:
        _wait(lambda: sum(w.state == LIVE for w in sup.workers.values())
              == 2, timeout=120, msg="2 decode replicas LIVE")
        _wait(lambda: len(_decode_eps(sup.registry_ep)) == 2,
              timeout=60, msg="both decode leases announced")
        eps = _decode_eps(sup.registry_ep)
        ep0, ep1 = eps["r0"], eps["r1"]

        def stream(ep, prompt, out, errs):
            try:
                out.append(DecodeClient(endpoints=[ep]).generate(
                    "lm", prompt, timeout=180, max_new_tokens=20))
            except Exception as e:      # noqa: BLE001 — counted
                errs.append(repr(e))
        threads = [threading.Thread(target=stream,
                                    args=(ep0, PROMPT_A, r0_out, r0_errs))
                   for _ in range(2)]
        # 4 concurrent streams of 6 + 20 tokens need 4 x 7 = 28 blocks
        # of r1's 12: preemption, and so the kill, is certain
        threads += [threading.Thread(target=stream,
                                     args=(ep1, PROMPT_B, r1_done, r1_errs))
                    for _ in range(4)]
        for t in threads:
            t.start()
        _wait(lambda: _decode_eps(sup.registry_ep).get("r1")
              not in (None, ep1), timeout=180,
              msg="r1 killed and respawned")
        for t in threads:
            t.join(timeout=200)
        assert not any(t.is_alive() for t in threads)
        assert r0_errs == [], r0_errs
        assert [o["tokens"] for o in r0_out] == [refA, refA]
        assert len(r1_errs) >= 1, (r1_errs, r1_done)
        new_ep = _decode_eps(sup.registry_ep)["r1"]
        c2 = DecodeClient(endpoints=[new_ep])

        def pool():
            try:
                return c2.status(new_ep)["lm"]["block_pool"]
            except Exception:           # noqa: BLE001 — still booting
                return None
        _wait(lambda: pool() is not None, timeout=60,
              msg="recovered r1 answers admin status")
        assert pool()["leaked"] == 0 and pool()["overcommit"] is True
        assert c2.generate("lm", PROMPT_B, timeout=180,
                           max_new_tokens=20)["tokens"] == refB
        w1 = sup.workers["decode-1"]
        assert w1.state == LIVE
        states = [h["state"] for h in w1.history]
        i = states.index("DEAD")
        assert states[i:i + 4] == ["DEAD", "REPLACING", "STARTING", "LIVE"]
    finally:
        sup.stop(grace_s=20.0)
    # the SIGTERM drains: r0's first spawn and r1's replacement
    for name in ("decode-0-0", "decode-1-1"):
        rep = json.loads((tmp_path / f"{name}.json").read_text())
        assert rep["leaked"] == 0 and rep["decode_steps"] > 0, rep
    assert not (tmp_path / "decode-1-0.json").exists()   # killed, no drain
