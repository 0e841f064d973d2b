"""Self-healing fleet supervisor: detect → decide → act → recover.

The port of ``paddle_tpu/distributed/supervisor.py``, for **stateless
roles** (serving and decode replicas, sleepers).  :class:`Supervisor`
owns worker lifecycle end to end from a declarative :class:`FleetSpec`.

Per worker, a small state machine::

    STARTING ──(lease seen / proc up)──> LIVE ──(shrink)──> DRAINING
       │                                  │                     │
       └──(action deadline)──┐            │ (proc exit != 0,    │(reaped)
                             v            v  or lease DEAD)     v
                 DEAD ──(budget left)──> REPLACING ──> STARTING ...
                   └──(budget blown)──> role HOLD  (crashloop)

Recovery disciplines, as the reference's:

- a death respawns that one worker, after exponential backoff, budget
  permitting;
- **crash loops**: deaths are counted per role inside a sliding window;
  more than ``restart_budget`` respawns in ``restart_window_s`` puts
  the role (and the fleet status) in HOLD — a loud degrade
  (``supervisor.crashloop`` gauge + flight note) instead of a restart
  storm.  ``resume_role`` lifts it;
- **bounded actions**: a spawned worker that never turns LIVE within
  ``action_deadline_s`` is killed and counted (``action_timeouts``); a
  LIVE worker whose health lease goes DEAD while its process runs is
  killed (``wedged_kills``) and replaced; the control loop never
  blocks on a wedged spawn.

Elastic resize grows and drains stateless roles (``resize(role, n)``,
the ``/fleetz?resize=role:n`` admin page, or a standing ``target``
driven through ``ElasticController.decide`` with flap damping), the
actions clamped to the target.  The SLO, canary and divergence
observers read the heartbeat's dimensions and lease data
(``observability/slo.py``, ``canary.py``, ``audit.py``).

The reference's **rollback roles** (a pserver group rolled back to the
newest COMPLETE sharded checkpoint, cut-then-rollback resizes, the
periodic cut ticker) stand on the checkpoint plane and the pserver
stack, which the port does not have: a :class:`FleetSpec` naming
``rollback_roles``, ``checkpoint_root`` or ``checkpoint_every_s``
raises ``NotImplementedError`` when it is built, before anything
starts, and the ``cut`` admin command is refused.

Observability: ``supervisor.*`` counters/gauges, a ``/fleetz`` debug
page (per-worker state machine + history), flight-recorder notes on
every death/replacement/hold, and ``tools/fleet_torch.py`` as the
operator CLI (launch/status/resize/drain from a spec file).
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..observability import audit as _audit
from ..observability import debug_server as _debug_server
from ..observability import flight as _flight
from ..observability import stats as _obs_stats

__all__ = ["free_ports", "RoleSpec", "FleetSpec", "Supervisor"]

# worker states (the /fleetz state machine)
STARTING = "STARTING"
LIVE = "LIVE"
DRAINING = "DRAINING"
DEAD = "DEAD"
REPLACING = "REPLACING"
COMPLETED = "COMPLETED"
HELD = "HELD"


def free_ports(n: int) -> List[int]:
    """Allocate ``n`` distinct free localhost ports (bind-to-0, then
    release).  THE ephemeral-port helper — tests (``dist_model``, the
    chaos runner) and the supervisor all share this one implementation
    so nothing rolls its own colliding allocator.  Note the supervisor
    itself only uses these as stable LOGICAL endpoint ids: supervised
    workers bind ``host:0`` and announce their real port through the
    registry, so two fleets can never race for a released port."""
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _substitute(value: str, subs: Dict[str, str]) -> str:
    """Token substitution over the known placeholder set only (a stray
    ``{`` in a flag value must not explode like str.format would)."""
    for k, v in subs.items():
        value = value.replace("{" + k + "}", str(v))
    return value


class RoleSpec:
    """One role of a fleet: how many workers, how to launch one, and
    the robustness budget that governs restarting it.

    ``argv``/``env`` values may carry placeholders, substituted per
    spawn: ``{index}`` (worker index in the role), ``{spawn}`` (0-based
    incarnation counter), ``{name}`` (worker name ``<role>-<index>``),
    ``{registry}`` (the fleet registry endpoint), ``{logical}`` (this
    worker's logical endpoint id), ``{workdir}``, and
    ``{<role>_logicals}`` (comma list of any role's logical ids).

    ``env_once`` maps a worker index to env entries applied ONLY to
    that worker's FIRST spawn — the chaos suite arms its fault
    injection there, so a replacement comes up clean instead of
    re-arming the kill that created it.

    ``logical="auto"`` allocates one stable logical endpoint id per
    worker (``127.0.0.1:<free port>`` — an identity, not a binding;
    pass ``PADDLE_BIND_ENDPOINT=127.0.0.1:0`` style env so the worker
    binds ephemerally and announces).  ``health_role`` names the fleet
    health-plane role string (``PSERVER``/``TRAINER``/...) this role's
    workers heartbeat as — the key the DEAD-lease watch and the
    ElasticController decisions match on.
    """

    def __init__(self, count: int, argv: Sequence[str],
                 env: Optional[Dict[str, str]] = None,
                 env_once: Optional[Dict[int, Dict[str, str]]] = None,
                 logical: Optional[object] = None,
                 health_role: str = "",
                 after: Sequence[str] = (),
                 after_live: bool = True,
                 restart_budget: int = 3,
                 restart_window_s: float = 120.0,
                 backoff_s: float = 0.25,
                 backoff_max_s: float = 10.0,
                 action_deadline_s: float = 60.0,
                 grace_s: float = 5.0,
                 done_ok: bool = False,
                 target: Optional[int] = None):
        self.count = int(count)
        self.argv = list(argv)
        self.env = dict(env or {})
        self.env_once = {int(k): dict(v)
                         for k, v in (env_once or {}).items()}
        self.logical = logical
        self.health_role = health_role
        self.after = list(after)
        # True: dependents wait for deps to be LIVE (lease-gated) —
        # the safe default.  False: deps need only be SPAWNED, so a
        # restart overlaps the dependents' process/import startup with
        # the deps' (the transport's registry polling absorbs the
        # ordering).
        self.after_live = bool(after_live)
        self.restart_budget = int(restart_budget)
        self.restart_window_s = float(restart_window_s)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.action_deadline_s = float(action_deadline_s)
        self.grace_s = float(grace_s)
        self.done_ok = bool(done_ok)
        self.target = None if target is None else int(target)
        if self.count < 0 or self.restart_budget < 0:
            raise ValueError("count and restart_budget must be >= 0")

    @classmethod
    def from_dict(cls, d: dict) -> "RoleSpec":
        known = {"count", "argv", "env", "env_once", "logical",
                 "health_role", "after", "after_live", "restart_budget",
                 "restart_window_s", "backoff_s", "backoff_max_s",
                 "action_deadline_s", "grace_s", "done_ok", "target"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RoleSpec fields: {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> dict:
        return {"count": self.count, "argv": list(self.argv),
                "env": dict(self.env),
                "env_once": {k: dict(v) for k, v in self.env_once.items()},
                "logical": self.logical, "health_role": self.health_role,
                "after": list(self.after), "after_live": self.after_live,
                "restart_budget": self.restart_budget,
                "restart_window_s": self.restart_window_s,
                "backoff_s": self.backoff_s,
                "backoff_max_s": self.backoff_max_s,
                "action_deadline_s": self.action_deadline_s,
                "grace_s": self.grace_s, "done_ok": self.done_ok,
                "target": self.target}


class FleetSpec:
    """A whole fleet, declaratively: roles × counts × env, the registry
    (``"auto"`` = the supervisor runs one in-process) and the elastic
    knobs (``hysteresis`` = consecutive same-direction ElasticController
    observations required before a grow/shrink acts — the flap damper).

    The reference's checkpoint fields (``checkpoint_root``,
    ``rollback_roles``, ``cut_role``, ``checkpoint_every_s``) are kept
    in the spec's dict form, empty; a spec that sets one raises
    ``NotImplementedError``: rollback recovery needs the checkpoint
    plane, which is not ported."""

    def __init__(self, roles: Dict[str, RoleSpec],
                 registry: str = "auto",
                 checkpoint_root: Optional[str] = None,
                 rollback_roles: Sequence[str] = (),
                 cut_role: Optional[str] = None,
                 checkpoint_every_s: float = 0.0,
                 hysteresis: int = 2,
                 quarantine_on_canary_fail: bool = False,
                 name: str = "fleet"):
        if rollback_roles or checkpoint_root or cut_role \
                or float(checkpoint_every_s):
            raise NotImplementedError(
                "rollback roles, checkpoint_root, cut_role and "
                "checkpoint_every_s need the checkpoint plane "
                "(checkpoint/manifest.py, store.py, reshard.py, "
                "snapshot.py) and the pserver stack, which are not "
                "ported: this supervisor runs stateless roles only")
        self.roles = {r: (s if isinstance(s, RoleSpec)
                          else RoleSpec.from_dict(s))
                      for r, s in roles.items()}
        self.registry = registry
        self.checkpoint_root = checkpoint_root
        self.rollback_roles = list(rollback_roles)
        self.checkpoint_every_s = float(checkpoint_every_s)
        self.hysteresis = max(1, int(hysteresis))
        # correctness quarantine (observability/canary.py): when True, a
        # worker whose heartbeat reports a confirmed canary-fail streak
        # is DRAINED — never killed — so in-flight requests finish while
        # the lying replica leaves the serving set
        self.quarantine_on_canary_fail = bool(quarantine_on_canary_fail)
        self.name = name
        for r, s in self.roles.items():
            for dep in s.after:
                if dep not in self.roles:
                    raise ValueError(
                        f"role {r!r} depends on unknown role {dep!r}")
        self.cut_role = None

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSpec":
        d = dict(d)
        roles = {r: RoleSpec.from_dict(s) if not isinstance(s, RoleSpec)
                 else s for r, s in d.pop("roles").items()}
        return cls(roles=roles, **d)

    @classmethod
    def from_file(cls, path: str) -> "FleetSpec":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return {"name": self.name, "registry": self.registry,
                "checkpoint_root": self.checkpoint_root,
                "rollback_roles": list(self.rollback_roles),
                "cut_role": self.cut_role,
                "checkpoint_every_s": self.checkpoint_every_s,
                "hysteresis": self.hysteresis,
                "quarantine_on_canary_fail": self.quarantine_on_canary_fail,
                "roles": {r: s.to_dict() for r, s in self.roles.items()}}


class _Worker:
    """One supervised worker slot (a stable identity across respawns)."""

    _HISTORY = 16

    def __init__(self, role: str, index: int, logical: Optional[str]):
        self.role = role
        self.index = index
        self.name = f"{role}-{index}"
        self.logical = logical
        self.state = REPLACING          # pending its first spawn
        self.proc: Optional[subprocess.Popen] = None
        self.pid: Optional[int] = None
        self.spawns = 0
        self.last_rc: Optional[int] = None
        self.not_before = 0.0           # backoff gate for the next spawn
        self.deadline = 0.0             # STARTING -> LIVE bound
        self.drain_t0 = 0.0
        self.physical: Optional[str] = None   # last lease endpoint seen
        self.avoid_physical: Optional[str] = None  # dead incarnation's
        self.consecutive_deaths = 0
        self.expected_exit = False      # we killed it (a drain)
        self.since = time.time()
        self.history: List[dict] = []

    def transition(self, state: str, **info) -> None:
        self.state = state
        self.since = time.time()
        self.history.append({"ts": round(self.since, 3), "state": state,
                             **info})
        del self.history[:-self._HISTORY]

    def to_dict(self) -> dict:
        return {"name": self.name, "role": self.role, "index": self.index,
                "state": self.state, "pid": self.pid,
                "spawns": self.spawns, "last_rc": self.last_rc,
                "logical": self.logical, "physical": self.physical,
                "since": round(self.since, 3),
                "history": list(self.history)}


class _SupMetrics:
    def __init__(self):
        sc = _obs_stats.scope("supervisor")
        self.spawns = sc.counter("spawns", "worker processes launched")
        self.deaths = sc.counter(
            "deaths", "unexpected worker exits (nonzero rc, signal, or "
            "DEAD lease) the supervisor acted on")
        self.replacements = sc.counter(
            "replacements", "individual workers respawned after a death")
        self.action_timeouts = sc.counter(
            "action_timeouts", "spawns killed for missing the "
            "STARTING->LIVE action deadline")
        self.wedged_kills = sc.counter(
            "wedged_kills", "processes killed because their health "
            "lease went DEAD while the process was still alive")
        self.drains = sc.counter(
            "drains", "workers gracefully drained (shrink/stop)")
        self.crashloop = sc.gauge(
            "crashloop", "1 while any role is HOLDing after blowing its "
            "restart budget (the anti-restart-storm fence)")
        self.holds = sc.gauge("holds", "roles currently in HOLD")
        self.live = sc.gauge("workers_live", "workers currently LIVE")
        self.slo_breaches = sc.counter(
            "slo_breaches", "sustained worker SLO-breach transitions "
            "the supervisor observed via the heartbeat slo dimension "
            "(observability/slo.py); observed and flight-noted, never "
            "an automatic resize — decisions stay HOLD-safe")
        self.slo_breach_workers = sc.gauge(
            "slo_breach_workers", "workers currently in confirmed "
            "(hysteresis-damped) SLO breach")
        self.canary_fails = sc.counter(
            "canary_fails", "sustained canary-fail transitions observed "
            "via the heartbeat canary dimension (observability/"
            "canary.py) after hysteresis damping")
        self.canary_quarantines = sc.counter(
            "canary_quarantines", "workers DRAINED (never killed) under "
            "spec.quarantine_on_canary_fail after a confirmed "
            "canary-fail streak")
        self.canary_fail_workers = sc.gauge(
            "canary_fail_workers", "workers currently in confirmed "
            "(hysteresis-damped) canary fail")
        self.divergence_named = sc.counter(
            "divergence_named", "divergent replicas the cross-replica "
            "sentinel named from lease-data digests "
            "(observability/audit.py)")


class Supervisor:
    """Owns a fleet per :class:`FleetSpec` (module doc).  Thread-safe
    public surface; one daemon control-loop thread does every check and
    every action as non-blocking state transitions."""

    def __init__(self, spec: FleetSpec, controller=None,
                 poll_s: float = 0.2, registry_poll_s: float = 0.5,
                 workdir: Optional[str] = None):
        self.spec = spec
        self.poll_s = float(poll_s)
        self.registry_poll_s = float(registry_poll_s)
        self.workdir = workdir
        self.lock = threading.RLock()
        self.metrics = _SupMetrics()
        self._own_registry = None
        self.registry_ep: Optional[str] = None
        self.controller = controller     # built at start() when None
        self.workers: Dict[str, _Worker] = {}
        self._role_workers: Dict[str, List[_Worker]] = {}
        self._deaths: Dict[str, List[float]] = {}   # role -> death times
        self._holds: Dict[str, str] = {}            # role -> reason
        self._logicals: Dict[str, List[str]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_reg_poll = 0.0
        self._health: Dict[str, dict] = {}
        self._leases: Dict[str, str] = {}
        # capacity headroom harvested from lease DATA payloads
        # (FLAGS_capacity_attribution at the replicas): {lease key:
        # {headroom_frac, binding_phase, ...}} — empty when no replica
        # publishes it, so flags-off /fleetz is unchanged
        self._headroom: Dict[str, dict] = {}
        # measured memory headroom harvested from the same lease DATA
        # payloads (FLAGS_memory_attribution at the replicas): {lease
        # key: {memory_headroom_frac, memory_bytes, ...}}
        self._mem_headroom: Dict[str, dict] = {}
        # SLO-breach observation (heartbeat slo dimension): per-worker
        # consecutive-poll streaks, and the confirmed-breach set after
        # spec.hysteresis agreeing observations
        self._slo_streak: Dict[str, int] = {}
        self._slo_confirmed: Dict[str, list] = {}
        # canary-fail observation (heartbeat canary dimension), same
        # damping discipline; confirmed entries drive the optional
        # quarantine_on_canary_fail DRAIN policy
        self._canary_streak: Dict[str, int] = {}
        self._canary_confirmed: Dict[str, list] = {}
        # the cross-replica divergence verdict over lease-data digest
        # riders (FLAGS_divergence_check at the replicas); {} when no
        # replica publishes digests, so flags-off /fleetz is unchanged
        self._divergence: dict = {}
        self._divergence_seen: set = set()
        self._started = False
        self._client = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Supervisor":
        from . import registry as _registry_mod
        from . import transport as _transport
        with self.lock:
            if self._started:
                return self
            self._started = True
            if self.spec.registry == "auto":
                self._own_registry = _registry_mod.RegistryServer(
                    "127.0.0.1:0")
                self._own_registry.start()
                self.registry_ep = f"127.0.0.1:{self._own_registry.port}"
            else:
                self.registry_ep = self.spec.registry
            self._client = _transport.RPCClient(0)
            # logical endpoints resolve through THIS fleet's registry
            # (workers bind ephemerally)
            self._client.set_registry(self.registry_ep)
            if self.controller is None:
                from ..checkpoint.elastic import ElasticController
                self.controller = ElasticController(
                    self.registry_ep, poll_ttl=self.registry_poll_s,
                    hysteresis=self.spec.hysteresis)
            for role, rs in self.spec.roles.items():
                logicals = self._alloc_logicals(role, rs)
                self._logicals[role] = logicals
                ws = []
                for i in range(rs.count):
                    w = _Worker(role, i,
                                logicals[i] if i < len(logicals) else None)
                    self.workers[w.name] = w
                    ws.append(w)
                self._role_workers[role] = ws
        _debug_server.register_fleetz(self.spec.name, self.status,
                                      self._admin)
        _flight.note("supervisor_start", fleet=self.spec.name,
                     registry=self.registry_ep,
                     roles={r: s.count for r, s in self.spec.roles.items()})
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"supervisor-{self.spec.name}")
        self._thread.start()
        return self

    def _alloc_logicals(self, role: str, rs: RoleSpec) -> List[str]:
        if rs.logical is None:
            return []
        if rs.logical == "auto":
            return [f"127.0.0.1:{p}" for p in free_ports(rs.count)]
        return [str(x) for x in rs.logical]

    def stop(self, grace_s: Optional[float] = None) -> None:
        """Drain every worker (SIGTERM → grace → SIGKILL) and shut the
        control loop + owned registry down."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        with self.lock:
            workers = list(self.workers.values())
        for w in workers:
            self._terminate(w, hard=False)
        deadline = time.monotonic() + (grace_s if grace_s is not None
                                       else 5.0)
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                try:
                    w.proc.wait(timeout=max(0.0,
                                            deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self._terminate(w, hard=True)
                    w.proc.wait(timeout=10.0)
        _debug_server.unregister_fleetz(self.spec.name)
        if self._own_registry is not None:
            self._own_registry.stop()
        _flight.note("supervisor_stop", fleet=self.spec.name)

    def wait(self, timeout: float = 600.0,
             poll: float = 0.2) -> str:
        """Block until the fleet reaches a terminal condition: every
        ``done_ok`` role fully COMPLETED ("done"), any role HOLDing
        ("hold"), or timeout ("timeout")."""
        deadline = time.monotonic() + timeout
        done_roles = [r for r, s in self.spec.roles.items() if s.done_ok]
        while time.monotonic() < deadline:
            with self.lock:
                if self._holds:
                    return "hold"
                if done_roles and all(
                        all(w.state == COMPLETED
                            for w in self._role_workers[r])
                        for r in done_roles):
                    return "done"
            time.sleep(poll)
        return "timeout"

    # -- public actions ----------------------------------------------------
    def resize(self, role: str, count: int) -> dict:
        """Retarget ``role`` to ``count`` workers: grow by spawning,
        shrink by draining the highest indices."""
        count = int(count)
        with self.lock:
            if role not in self.spec.roles:
                raise KeyError(f"unknown role {role!r}")
            rs = self.spec.roles[role]
            old = rs.count
            if count == old:
                return {"role": role, "count": old, "action": "hold"}
            if count > old:
                self._grow_locked(role, count)
                return {"role": role, "count": count, "from": old,
                        "action": "grow"}
            self._shrink_locked(role, count)
            return {"role": role, "count": count, "from": old,
                    "action": "shrink"}

    def drain_worker(self, name: str) -> dict:
        with self.lock:
            w = self.workers.get(name)
            if w is None:
                raise KeyError(f"unknown worker {name!r}")
            self._drain_locked(w)
            return {"drained": name}

    def resume_role(self, role: Optional[str] = None) -> dict:
        """Lift a HOLD (operator acknowledged the crash loop): clears
        the death window and re-enables respawns."""
        with self.lock:
            roles = [role] if role else list(self._holds)
            for r in roles:
                self._holds.pop(r, None)
                self._deaths.pop(r, None)
                for w in self._role_workers.get(r, ()):
                    w.consecutive_deaths = 0
                    if w.state == HELD:
                        w.transition(REPLACING, why="resumed")
                        w.not_before = 0.0
            self.metrics.holds.set(len(self._holds))
            self.metrics.crashloop.set(1 if self._holds else 0)
        _flight.note("supervisor_resume", roles=roles)
        return {"resumed": roles}

    # -- status / admin ----------------------------------------------------
    def status(self) -> dict:
        with self.lock:
            workers = [w.to_dict() for w in self.workers.values()]
            holds = dict(self._holds)
            roles = {}
            now = time.monotonic()
            headroom = dict(self._headroom)
            mem_headroom = dict(self._mem_headroom)
            canary_streaks = dict(self._canary_streak)
            for r, rs in self.spec.roles.items():
                window = [t for t in self._deaths.get(r, ())
                          if now - t <= rs.restart_window_s]
                roles[r] = {"count": rs.count, "target": rs.target,
                            "restart_budget": rs.restart_budget,
                            "deaths_in_window": len(window),
                            "hold": holds.get(r)}
                # lease-data capacity next to liveness: the tightest
                # replica's headroom, matched by the announce-key
                # prefix of the role's health plane (serving/decode)
                prefix = {"SERVING": "serving/",
                          "DECODE": "decode/"}.get(
                    (rs.health_role or "").upper())
                if prefix:
                    fracs = [v["headroom_frac"]
                             for k, v in headroom.items()
                             if k.startswith(prefix)]
                    if fracs:
                        roles[r]["headroom_frac"] = min(fracs)
                    # measured memory next to modeled capacity: the
                    # tightest replica's byte headroom, plus a leak
                    # flag when any replica's refcount audit failed
                    mfracs = [v["memory_headroom_frac"]
                              for k, v in mem_headroom.items()
                              if k.startswith(prefix)
                              and "memory_headroom_frac" in v]
                    if mfracs:
                        roles[r]["memory_headroom_frac"] = min(mfracs)
                    if any(v.get("memory_leak")
                           for k, v in mem_headroom.items()
                           if k.startswith(prefix)):
                        roles[r]["memory_leak"] = True
                    # the worst live canary-fail streak among this
                    # role's announce keys (absent when all pass, so
                    # flags-off status is unchanged)
                    streaks = [s for k, s in canary_streaks.items()
                               if k.startswith(prefix)]
                    if streaks:
                        roles[r]["canary_fail_streak"] = max(streaks)
        with self.lock:
            slo = {w: list(r) for w, r in self._slo_confirmed.items()}
            canary = {w: list(t)
                      for w, t in self._canary_confirmed.items()}
            divergence = dict(self._divergence)
        out = {"fleet": self.spec.name,
               "state": "HOLD" if holds else "RUNNING",
               "registry": self.registry_ep,
               "roles": roles, "workers": workers,
               "slo_breaches": slo, "canary_fails": canary}
        if divergence.get("divergent") or divergence.get("suspect"):
            out["divergence"] = divergence
        if headroom:
            out["headroom"] = headroom
        if mem_headroom:
            out["memory_headroom"] = mem_headroom
        return out

    def _admin(self, cmd: dict) -> dict:
        """The /fleetz mutation surface (tools/fleet.py drives this)."""
        if "resize" in cmd:
            role, _, n = str(cmd["resize"]).partition(":")
            return self.resize(role, int(n))
        if "drain" in cmd:
            return self.drain_worker(str(cmd["drain"]))
        if "resume" in cmd:
            arg = str(cmd["resume"])
            return self.resume_role(None if arg in ("", "1", "all")
                                    else arg)
        if "cut" in cmd:
            raise NotImplementedError(
                "a fleet checkpoint cut needs the checkpoint plane, which "
                "is not ported")
        raise ValueError(f"fleetz admin: unknown command {cmd!r}")

    # -- spawn machinery ---------------------------------------------------
    def _subs_for(self, w: _Worker) -> Dict[str, str]:
        subs = {"index": w.index, "spawn": w.spawns, "name": w.name,
                "role": w.role, "registry": self.registry_ep or "",
                "logical": w.logical or "",
                "workdir": self.workdir or os.getcwd()}
        for role, logicals in self._logicals.items():
            subs[f"{role}_logicals"] = ",".join(logicals)
        return subs

    def _spawn(self, w: _Worker) -> None:
        """One launch (call with lock held).  Never raises into the
        control loop: a spawn error is a counted death."""
        rs = self.spec.roles[w.role]
        subs = self._subs_for(w)
        argv = [_substitute(a, subs) for a in rs.argv]
        env = dict(os.environ)
        env.update({k: _substitute(v, subs) for k, v in rs.env.items()})
        if w.spawns == 0:
            for k, v in rs.env_once.get(w.index, {}).items():
                env[k] = _substitute(v, subs)
        try:
            w.proc = subprocess.Popen(
                argv, env=env, cwd=self.workdir,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True)
        except OSError as e:
            w.proc = None
            w.transition(DEAD, why=f"spawn failed: {e!r}"[:200])
            self._on_death(w, f"spawn error: {e!r}"[:200])
            return
        w.pid = w.proc.pid
        w.spawns += 1
        w.expected_exit = False
        w.deadline = time.monotonic() + rs.action_deadline_s
        w.transition(STARTING, pid=w.pid, spawn=w.spawns)
        self.metrics.spawns.inc()
        _flight.note("supervisor_spawn", worker=w.name, pid=w.pid,
                     spawn=w.spawns)

    def _terminate(self, w: _Worker, hard: bool) -> None:
        if w.proc is None or w.proc.poll() is not None:
            return
        try:
            w.proc.kill() if hard else w.proc.terminate()
        except OSError:  # pragma: no cover - already reaped
            pass

    def _deps_live(self, role: str) -> bool:
        ok = ((LIVE, COMPLETED) if self.spec.roles[role].after_live
              else (STARTING, LIVE, COMPLETED))
        for dep in self.spec.roles[role].after:
            for w in self._role_workers.get(dep, ()):
                if w.state not in ok:
                    return False
        return True

    # -- the control loop --------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # the loop must survive everything
                _flight.note("supervisor_tick_error",
                             error=repr(e)[:200])
            self._stop.wait(self.poll_s)

    def _tick(self) -> None:
        now = time.monotonic()
        if self.registry_ep and now >= self._next_reg_poll:
            self._next_reg_poll = now + self.registry_poll_s
            self._poll_registry()
        # elastic decisions do registry RPCs (the controller's
        # fleet_view fetch): gather them OUTSIDE the lock so a slow
        # registry can never stall the /fleetz status+admin surface;
        # the actions re-check state under the lock (idempotent)
        decisions = self._elastic_decide()
        with self.lock:
            self._reap_exits()
            self._check_health_dead()
            self._check_deadlines(now)
            self._advance_drains(now)
            self._pending_spawns(now)
            self._elastic_act(decisions)
            self.metrics.live.set(sum(w.state == LIVE
                                      for w in self.workers.values()))

    def _poll_registry(self) -> None:
        """Refresh the lease + health view (outside the lock: one
        bounded RPC round)."""
        from . import registry as _registry_mod
        try:
            snap = _registry_mod.fetch_snapshot(
                self._client, self.registry_ep, connect_timeout=2.0)
            health = _registry_mod.fetch_health(
                self._client, self.registry_ep, connect_timeout=2.0)
        except Exception:
            return              # registry blip: keep the last view
        leases = {k: v["endpoint"]
                  for k, v in (snap.get("leases") or {}).items()}
        headroom = {}
        mem_headroom = {}
        digests = {}
        for key, data in (snap.get("data") or {}).items():
            if not isinstance(data, dict):
                continue
            if "headroom_frac" in data:
                headroom[key] = {k: data[k] for k in
                                 ("headroom_frac", "binding_phase",
                                  "predicted_max_qps") if k in data}
            if "memory_headroom_frac" in data or "memory_bytes" in data:
                mem_headroom[key] = {k: data[k] for k in
                                     ("memory_headroom_frac",
                                      "memory_bytes",
                                      "memory_parked_bytes",
                                      "memory_leak") if k in data}
            if isinstance(data.get("digests"), dict):
                digests[key] = data["digests"]
        # the sentinel proper: group digest riders ACROSS replicas and
        # name a divergent minority (pure function, outside the lock)
        verdict = _audit.name_divergent(digests) if digests else {}
        with self.lock:
            self._leases = leases
            self._headroom = headroom
            self._mem_headroom = mem_headroom
            self._health = health
            self._observe_slo_locked(health)
            # detect (canary streak) is noted before name (divergence
            # verdict) within a poll; the confirm+quarantine fires a
            # hysteresis-damped poll later — so the flight record reads
            # detect → name → drain in order
            self._observe_canary_locked(health)
            self._observe_divergence_locked(verdict)
            for w in self.workers.values():
                if w.logical and w.logical in leases:
                    w.physical = leases[w.logical]

    def _observe_slo_locked(self, health: Dict[str, dict]) -> None:
        """Fold one FRESH health view's slo dimensions into the damped
        breach observation (call with the lock held).  A worker whose
        heartbeat reports ``slo: breach`` for ``spec.hysteresis``
        consecutive polls becomes a CONFIRMED breach: counted, flight-
        noted, gauged and shown on /fleetz — but never an automatic
        resize (a breached-yet-alive fleet is an operator decision;
        killing the only replica that IS serving would make the SLO
        worse).  One non-breach poll resets the streak (the watchdog's
        own sustain window already filtered transients)."""
        need = self.spec.hysteresis
        for worker, info in health.items():
            slo = info.get("slo")
            if slo == "breach":
                streak = self._slo_streak.get(worker, 0) + 1
                self._slo_streak[worker] = streak
                if streak >= need and worker not in self._slo_confirmed:
                    rules = list(info.get("slo_rules") or [])
                    self._slo_confirmed[worker] = rules
                    self.metrics.slo_breaches.inc()
                    _flight.note("supervisor_slo_breach", worker=worker,
                                 rules=rules, streak=streak)
            else:
                self._slo_streak.pop(worker, None)
                if worker in self._slo_confirmed:
                    self._slo_confirmed.pop(worker)
                    _flight.note("supervisor_slo_clear", worker=worker)
        # workers that vanished from the view (deregistered/reaped)
        for worker in list(self._slo_confirmed):
            if worker not in health:
                self._slo_confirmed.pop(worker)
                self._slo_streak.pop(worker, None)
        self.metrics.slo_breach_workers.set(len(self._slo_confirmed))

    def _observe_canary_locked(self, health: Dict[str, dict]) -> None:
        """Fold one FRESH health view's canary dimensions into the
        damped observation (call with the lock held).  Same discipline
        as :meth:`_observe_slo_locked` — ``spec.hysteresis`` agreeing
        polls confirm — but with one extra tooth: under
        ``spec.quarantine_on_canary_fail`` a confirmed replica is
        DRAINED (the PR-13 typed drain: SIGTERM → deregister → finish
        in-flight → reap), never killed.  A canary fail means the
        replica answers WRONG, so leaving it in the serving set is
        worse than losing its capacity; draining quarantines it with
        zero dropped requests.

        Attribution: the canary dimension is process-global, so a
        process serving several announce keys stamps ``fail`` on every
        one of its heartbeats.  When the failing target's OWN announce
        key is present in this same health view, blame lands there and
        its innocent siblings are treated as passing — only a target
        name that maps to no visible key falls back to blaming the
        reporting key."""
        need = self.spec.hysteresis
        for worker, info in health.items():
            failing = info.get("canary") == "fail"
            targets = list(info.get("canary_targets") or [])
            if failing and targets and worker not in targets \
                    and any(t in health for t in targets):
                failing = False
            if failing:
                streak = self._canary_streak.get(worker, 0) + 1
                self._canary_streak[worker] = streak
                if streak == 1:
                    _flight.note("supervisor_canary_detect",
                                 worker=worker, targets=targets)
                if streak >= need and worker not in self._canary_confirmed:
                    self._canary_confirmed[worker] = targets
                    self.metrics.canary_fails.inc()
                    _flight.note("supervisor_canary_fail", worker=worker,
                                 targets=targets, streak=streak)
                    if self.spec.quarantine_on_canary_fail:
                        self._quarantine_locked(worker)
            else:
                self._canary_streak.pop(worker, None)
                if worker in self._canary_confirmed:
                    self._canary_confirmed.pop(worker)
                    _flight.note("supervisor_canary_clear", worker=worker)
        for worker in list(self._canary_confirmed):
            if worker not in health:
                self._canary_confirmed.pop(worker)
                self._canary_streak.pop(worker, None)
        self.metrics.canary_fail_workers.set(len(self._canary_confirmed))

    def _quarantine_locked(self, key: str) -> None:
        """Map a confirmed-failing heartbeat key to its supervised
        worker and drain it.  Serving/decode replicas heartbeat under
        announce keys (``serving/<model>/<replica>``) whose lease
        endpoint matches the worker's announced physical endpoint;
        plain workers heartbeat under their logical id directly.  An
        unmapped key (an unsupervised replica sharing the registry) is
        flight-noted, never guessed at."""
        ep = self._leases.get(key)
        for w in self.workers.values():
            if w.state not in (LIVE, STARTING):
                continue
            if w.logical == key or (ep is not None
                                    and ep in (w.physical, w.logical)):
                self.metrics.canary_quarantines.inc()
                _flight.note("supervisor_canary_quarantine",
                             worker=w.name, key=key)
                self._drain_locked(w)
                return
        _flight.note("supervisor_canary_quarantine_unmapped", key=key)

    def _observe_divergence_locked(self, verdict: dict) -> None:
        """Record the newest sentinel verdict; count + flight-note each
        NEWLY named (replica, group, digest) finding exactly once (the
        same divergence re-observed every poll is one event, not a
        counter storm)."""
        self._divergence = verdict
        for f in verdict.get("divergent") or ():
            fp = (f.get("replica"), f.get("model"), f.get("version"),
                  f.get("request_hash"), f.get("digest"))
            if fp in self._divergence_seen:
                continue
            self._divergence_seen.add(fp)
            self.metrics.divergence_named.inc()
            _flight.note("supervisor_divergence_named", **f)

    def _winding_down(self) -> bool:
        """True when every done_ok worker has finished (state COMPLETED
        or a 0 exit not yet reaped) — the window in which the REST of
        the fleet exiting cleanly is the normal end of the job, not a
        silent capacity loss.  A fleet with no done_ok role never winds
        down: its workers are services, and a clean exit is still an
        unexpected exit."""
        saw_done_role = False
        for role, rs in self.spec.roles.items():
            if not rs.done_ok:
                continue
            saw_done_role = True
            for w in self._role_workers.get(role, ()):
                if w.state == COMPLETED:
                    continue
                if w.proc is not None and w.proc.poll() == 0:
                    continue     # exited clean, reaped later this tick
                return False
        return saw_done_role

    def _reap_exits(self) -> None:
        winding_down = None      # computed lazily, once per tick
        for w in self.workers.values():
            if w.proc is None or w.state in (DEAD, REPLACING, COMPLETED,
                                             HELD):
                continue
            rc = w.proc.poll()
            if rc is None:
                continue
            w.last_rc = rc
            if w.state == DRAINING:
                w.transition(DEAD, rc=rc, why="drained")
                continue
            if w.expected_exit:
                # a supervisor-initiated kill outside a drain
                w.transition(DEAD, rc=rc, why="expected")
                continue
            if rc == 0:
                if self.spec.roles[w.role].done_ok:
                    w.transition(COMPLETED, rc=0)
                    continue
                # a service worker exiting CLEAN is still an unexpected
                # exit — unless the fleet is winding down (every done_ok
                # worker finished): silently reading it as COMPLETED
                # would hide lost capacity
                if winding_down is None:
                    winding_down = self._winding_down()
                if winding_down:
                    w.transition(COMPLETED, rc=0)
                    continue
            w.transition(DEAD, rc=rc)
            self._on_death(w, f"exit rc={rc}")

    def _check_health_dead(self) -> None:
        """A worker whose lease went DEAD while its process still runs
        is wedged (GC death spiral, deadlock, partitioned): kill it so
        the normal death path replaces it."""
        if not self._health:
            return
        for w in self.workers.values():
            if w.state != LIVE or not w.logical or w.proc is None \
                    or w.proc.poll() is not None:
                continue
            ent = self._health.get(w.logical)
            if ent and ent.get("state") == "DEAD":
                self.metrics.wedged_kills.inc()
                _flight.note("supervisor_wedged_kill", worker=w.name,
                             logical=w.logical)
                self._terminate(w, hard=True)
                # reaped as a normal death next tick

    def _check_deadlines(self, now: float) -> None:
        for w in self.workers.values():
            if w.state != STARTING:
                continue
            if self._is_live(w):
                w.consecutive_deaths = 0   # proved itself: reset backoff
                w.transition(LIVE)
                continue
            if now >= w.deadline:
                self.metrics.action_timeouts.inc()
                _flight.note("supervisor_action_timeout", worker=w.name,
                             spawn=w.spawns)
                self._terminate(w, hard=True)
                if w.proc is not None:
                    try:   # SIGKILL reaps near-instantly: no zombie
                        w.last_rc = w.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:  # pragma: no cover
                        pass
                w.transition(DEAD, why="action deadline")
                self._on_death(w, "spawn missed its action deadline")

    def _is_live(self, w: _Worker) -> bool:
        if w.proc is None or w.proc.poll() is not None:
            return False
        if not w.logical:
            return True           # no lease contract: running == live
        phys = self._leases.get(w.logical)
        if phys is None:
            return False
        # a lingering lease from the dead incarnation must not count
        return w.avoid_physical is None or phys != w.avoid_physical

    def _advance_drains(self, now: float) -> None:
        for w in self.workers.values():
            if w.state == DRAINING and w.proc is not None \
                    and w.proc.poll() is None \
                    and now - w.drain_t0 > self.spec.roles[w.role].grace_s:
                self._terminate(w, hard=True)

    # -- death handling ----------------------------------------------------
    def _on_death(self, w: _Worker, why: str) -> None:
        rs = self.spec.roles[w.role]
        self.metrics.deaths.inc()
        w.avoid_physical = w.physical
        _flight.note("supervisor_death", worker=w.name, why=why,
                     spawns=w.spawns)
        now = time.monotonic()
        window = self._deaths.setdefault(w.role, [])
        window.append(now)
        window[:] = [t for t in window if now - t <= rs.restart_window_s]
        if len(window) > rs.restart_budget:
            self._hold_role(w.role,
                            f"{len(window)} deaths in "
                            f"{rs.restart_window_s:.0f}s window "
                            f"(budget {rs.restart_budget}); last: {why}")
            w.transition(HELD, why="restart budget exhausted")
            return
        w.consecutive_deaths += 1
        backoff = min(rs.backoff_max_s,
                      rs.backoff_s * (2 ** (w.consecutive_deaths - 1)))
        self.metrics.replacements.inc()
        w.not_before = now + backoff
        w.transition(REPLACING, backoff_s=round(backoff, 3))

    def _hold_role(self, role: str, reason: str) -> None:
        """Crash-loop fence: stop respawning, say so loudly, keep the
        rest of the fleet serving.  The operator resumes explicitly."""
        if role in self._holds:
            return
        self._holds[role] = reason
        self.metrics.holds.set(len(self._holds))
        self.metrics.crashloop.set(1)
        _flight.note("supervisor_crashloop", role=role, reason=reason)
        print(f"[supervisor {self.spec.name}] role {role!r} is HOLDING: "
              f"{reason}", flush=True)

    def _pending_spawns(self, now: float) -> None:
        # dependency order: a role spawns only when its deps are LIVE
        for role in self.spec.roles:
            if role in self._holds:
                continue
            if not self._deps_live(role):
                continue
            for w in self._role_workers.get(role, ()):
                if w.state == REPLACING and now >= w.not_before:
                    self._spawn(w)

    # -- elastic decisions -------------------------------------------------
    def _elastic_decide(self) -> List[tuple]:
        """Standing targets flow through ElasticController.decide (with
        its flap-damping hysteresis).  Runs OUTSIDE the supervisor lock
        — decide() may fetch the registry health view.  Returns
        ``[(role, decision), ...]`` for :meth:`_elastic_act`."""
        if self.controller is None:
            return []
        out = []
        for role, rs in self.spec.roles.items():
            if rs.target is None or role in self._holds:
                continue
            try:
                d = self.controller.decide(rs.health_role or role,
                                           rs.target)
            except Exception:
                continue          # registry blip: no decision this tick
            if d["action"] != "hold":
                out.append((role, d))
        return out

    def _elastic_act(self, decisions: List[tuple]) -> None:
        """Apply damped decisions (call with the lock held).  Actions
        clamp to ``rs.target`` — never ``count ± delta`` — so the same
        decision re-observed while lagging leases catch up (a respawn
        takes seconds; a drained lease lingers a TTL) is an idempotent
        no-op instead of a runaway grow storm / drain-to-zero."""
        for role, d in decisions:
            rs = self.spec.roles.get(role)
            if rs is None or rs.target is None or role in self._holds:
                continue
            if d["action"] == "grow" and rs.count < rs.target:
                self._note_decision(role, d)
                self._grow_locked(role, rs.target)
            elif d["action"] == "shrink" and rs.count > rs.target:
                self._note_decision(role, d)
                self._shrink_locked(role, rs.target)

    @staticmethod
    def _note_decision(role: str, d: dict) -> None:
        _flight.note("supervisor_elastic_decision", role=role,
                     **{k: d[k] for k in ("action", "delta", "target")})

    def _grow_locked(self, role: str, count: int) -> None:
        rs = self.spec.roles[role]
        ws = self._role_workers[role]
        logicals = self._logicals[role]
        if rs.logical is not None and len(logicals) < count:
            # ONE batch allocation: free_ports holds all sockets open
            # together, which is what makes the ids distinct — minting
            # them one-by-one could hand the same released port back
            logicals.extend(f"127.0.0.1:{p}"
                            for p in free_ports(count - len(logicals)))
        for i in range(len(ws), count):
            w = _Worker(role, i, logicals[i] if i < len(logicals) else None)
            self.workers[w.name] = w
            ws.append(w)
        # re-grow over previously drained slots: a DEAD worker inside
        # the new count comes back (fresh spawn, backoff cleared)
        for w in ws[:count]:
            if w.state == DEAD:
                w.avoid_physical = w.physical
                w.consecutive_deaths = 0
                w.not_before = 0.0
                w.transition(REPLACING, why="regrown")
        rs.count = count
        _flight.note("supervisor_grow", role=role, count=count)

    def _shrink_locked(self, role: str, count: int) -> None:
        rs = self.spec.roles[role]
        ws = self._role_workers[role]
        for w in ws[count:]:
            if w.state in (LIVE, STARTING):
                self._drain_locked(w)
            elif w.state == REPLACING:
                w.transition(DEAD, why="shrunk before respawn")
        rs.count = count
        _flight.note("supervisor_shrink", role=role, count=count)

    def _drain_locked(self, w: _Worker) -> None:
        """Graceful retire: SIGTERM (serving/decode workers deregister
        + finish in-flight), bounded by the role's ``grace_s``, then
        SIGKILL."""
        if w.state not in (LIVE, STARTING):
            return
        self.metrics.drains.inc()
        w.expected_exit = True
        w.drain_t0 = time.monotonic()
        w.transition(DRAINING)
        _flight.note("supervisor_drain", worker=w.name)
        self._terminate(w, hard=False)
