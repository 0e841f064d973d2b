"""Heartbeat-based worker health registry: HEALTHY → SUSPECT → DEAD.

The port's copy of ``paddle_tpu/observability/health.py``.

Borg/Borgmon-style liveness for the fleet: every worker already
refreshes a TTL lease against the discovery registry
(``distributed/registry.py`` — the etcd keepalive analogue), so the
heartbeat piggybacks a small health payload (role, step counter, last
error) on that existing REG_SET instead of adding a second RPC.  The
registry side files each refresh into a :class:`HealthTable`; state is
computed *lazily at read time* from the age of the last heartbeat
measured in missed lease terms:

- ``age <= suspect_misses * ttl``  → ``HEALTHY``
- ``age <= dead_misses * ttl``     → ``SUSPECT`` (lease lapsed; the
  worker may be GC-pausing, swapping, or mid-restart)
- beyond                            → ``DEAD`` (consumers may act:
  ``TaskMaster`` requeues its leases immediately instead of waiting
  out the task-lease timeout)

Thresholds come from ``FLAGS_health_suspect_misses`` /
``FLAGS_health_dead_misses`` (overridable per table).  ``snapshot()``
exports fleet-level ``health.workers_{healthy,suspect,dead}`` gauges
into the default stats registry so ``/metrics`` carries liveness.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from . import stats as _stats

HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DEAD = "DEAD"


def _flag(name: str, default: float) -> float:
    from ..core import flags
    try:
        return float(flags.get_flags(name))
    except KeyError:  # pragma: no cover - flags always defined
        return default


class _WorkerEntry:
    __slots__ = ("name", "role", "step", "last_error", "trainer_id",
                 "ttl", "last_seen", "heartbeats", "standby", "slo",
                 "slo_rules", "canary", "canary_targets", "memory",
                 "memory_pools")

    def __init__(self, name: str):
        self.name = name
        self.role = ""
        self.step = None
        self.last_error = None
        self.trainer_id = None
        self.ttl = 0.0
        self.last_seen = 0.0
        self.heartbeats = 0
        # HA: candidate id while this worker is a STANDBY replica for
        # its logical key (None = primary / not replicated); cleared on
        # promotion, so the fleet view shows who is warm-sparing whom
        self.standby = None
        # SLO watchdog dimension (observability/slo.py): "ok"/"breach"
        # as reported by the worker's own in-process watchdog, riding
        # the same heartbeat payload — liveness says the worker is
        # alive, this says whether it is USEFUL.  None = worker runs no
        # watchdog (the pre-slo wire)
        self.slo = None
        self.slo_rules = None
        # correctness dimension (observability/canary.py): "ok"/"fail"
        # as reported by the worker's own golden-canary prober, plus
        # the replica-qualified targets at/over the fail-streak
        # threshold.  None = worker runs no prober (the pre-canary wire)
        self.canary = None
        self.canary_targets = None
        # memory dimension (observability/memory.py): "ok"/"leak" as
        # reported by the worker's own leak sentinel (refcount audits
        # over its registered pools), plus the leaking pool names.
        # None = worker runs no memory attribution (the pre-memory wire)
        self.memory = None
        self.memory_pools = None


class HealthTable:
    """Last-heartbeat table with miss-threshold state transitions.

    ``observe()`` is called by the registry service on every REG_SET
    that carries a health payload; readers (``snapshot()`` /
    ``dead_trainers()``) never block writers for longer than a dict
    copy.  Thresholds are in units of the *worker's own* lease TTL, so
    a 2 s-lease trainer and a 10 s-lease pserver age out on their own
    clocks.
    """

    _FORGET_AUTO = "auto"

    def __init__(self, suspect_misses: Optional[float] = None,
                 dead_misses: Optional[float] = None,
                 forget_misses=_FORGET_AUTO):
        self.suspect_misses = (suspect_misses if suspect_misses is not None
                               else _flag("health_suspect_misses", 1.0))
        self.dead_misses = (dead_misses if dead_misses is not None
                            else _flag("health_dead_misses", 3.0))
        if self.dead_misses <= self.suspect_misses:
            raise ValueError(
                "dead_misses must exceed suspect_misses (check "
                "FLAGS_health_dead_misses vs FLAGS_health_suspect_misses)")
        # retention bound: entries DEAD for this many lease terms are
        # dropped at read time, so a long-lived registry doesn't report
        # (and remember) every worker of every finished job forever.
        # "auto" scales with dead_misses so a flags-only change (e.g.
        # FLAGS_health_dead_misses=150) can never invert the ordering
        # and crash the registry at construction.  None = keep forever.
        # Workers that exit CLEANLY should send a goodbye instead
        # (registry.deregister / Heartbeat.stop(bye=True)).
        if forget_misses == self._FORGET_AUTO:
            forget_misses = max(120.0, 10.0 * self.dead_misses)
        if forget_misses is not None and forget_misses <= self.dead_misses:
            raise ValueError("forget_misses must exceed dead_misses")
        self.forget_misses = forget_misses
        self._lock = threading.Lock()
        self._workers: Dict[str, _WorkerEntry] = {}

    def observe(self, name: str, ttl: float, role: str = "",
                step: Optional[int] = None,
                last_error: Optional[str] = None,
                trainer_id: Optional[int] = None,
                standby=None, slo=None, slo_rules=None,
                canary=None, canary_targets=None,
                memory=None, memory_pools=None) -> None:
        """File one heartbeat (idempotent re-registration included)."""
        with self._lock:
            e = self._workers.get(name)
            if e is None:
                e = self._workers[name] = _WorkerEntry(name)
            e.ttl = float(ttl)
            if role:
                e.role = role
            if step is not None:
                e.step = int(step)
            e.last_error = last_error
            if trainer_id is not None:
                e.trainer_id = int(trainer_id)
            # always assigned (not only when present): a promoted
            # backup's next heartbeat clears its standby marker, and a
            # cleared SLO breach clears the slo dimension
            e.standby = standby
            e.slo = slo
            e.slo_rules = slo_rules
            e.canary = canary
            e.canary_targets = canary_targets
            e.memory = memory
            e.memory_pools = memory_pools
            e.last_seen = time.monotonic()
            e.heartbeats += 1

    def forget(self, name: str) -> None:
        with self._lock:
            self._workers.pop(name, None)

    def _state(self, e: _WorkerEntry, now: float) -> str:
        age = now - e.last_seen
        if e.ttl <= 0 or age <= self.suspect_misses * e.ttl:
            return HEALTHY
        if age <= self.dead_misses * e.ttl:
            return SUSPECT
        return DEAD

    def _reap_forgotten(self, now: float) -> None:
        """Drop entries past the retention bound (callers hold no lock)."""
        if self.forget_misses is None:
            return
        with self._lock:
            gone = [n for n, e in self._workers.items()
                    if e.ttl > 0 and now - e.last_seen
                    > self.forget_misses * e.ttl]
            for n in gone:
                del self._workers[n]

    def status(self, name: str) -> Optional[str]:
        self._reap_forgotten(time.monotonic())
        with self._lock:
            e = self._workers.get(name)
            return self._state(e, time.monotonic()) if e else None

    def snapshot(self) -> Dict[str, dict]:
        """{worker: {state, role, step, age_s, ...}}; refreshes the
        fleet-level ``health.workers_*`` gauges as a side effect."""
        now = time.monotonic()
        self._reap_forgotten(now)
        with self._lock:
            entries = list(self._workers.values())
        out, tallies = {}, {HEALTHY: 0, SUSPECT: 0, DEAD: 0}
        for e in entries:
            state = self._state(e, now)
            tallies[state] += 1
            ent = {
                "state": state,
                "role": e.role,
                "step": e.step,
                "last_error": e.last_error,
                "trainer_id": e.trainer_id,
                "ttl": e.ttl,
                "age_s": round(now - e.last_seen, 3),
                "heartbeats": e.heartbeats,
                "standby": e.standby,
            }
            if e.slo is not None:
                ent["slo"] = e.slo
                if e.slo_rules:
                    ent["slo_rules"] = e.slo_rules
            if e.canary is not None:
                ent["canary"] = e.canary
                if e.canary_targets:
                    ent["canary_targets"] = list(e.canary_targets)
            if e.memory is not None:
                ent["memory"] = e.memory
                if e.memory_pools:
                    ent["memory_pools"] = list(e.memory_pools)
            out[e.name] = ent
        sc = _stats.scope("health")
        sc.gauge("workers_healthy").set(tallies[HEALTHY])
        sc.gauge("workers_suspect").set(tallies[SUSPECT])
        sc.gauge("workers_dead").set(tallies[DEAD])
        sc.gauge("workers_slo_breach").set(
            sum(1 for e in entries if e.slo == "breach"))
        return out

    def dead_trainers(self) -> set:
        """Trainer ids currently DEAD (the master's requeue predicate).

        Only ``role == "TRAINER"`` entries count: non-trainer workers
        (pserver Heartbeats) carry the default RPC-client trainer_id of
        0, and a dead pserver must never read as "trainer 0 is dead"."""
        now = time.monotonic()
        self._reap_forgotten(now)
        with self._lock:
            entries = list(self._workers.values())
        return {e.trainer_id for e in entries
                if e.trainer_id is not None and e.role == "TRAINER"
                and self._state(e, now) == DEAD}
