"""Elastic resize decisions from the registry's health gauges.

The port of ``paddle_tpu/checkpoint/elastic.py``, in part: only
:class:`ElasticController`, a copy of the reference's, which the fleet
supervisor (``distributed/supervisor.py``) builds when none is passed.
It reads only the discovery registry and ``observability/health``.  The
state half of the reference's module (``save_scope``, ``restore_scope``,
``scope_snapshotter``, ``wait_step_complete``) stands on the checkpoint
store, manifest and reshard planner, which are not ported yet.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

__all__ = ["ElasticController"]


class ElasticController:
    """Resize decisions from the registry's live lease/health gauges.

    Polls the discovery registry's health table (the same one the
    fleet-health plane and the master's dead-requeue consume) and
    reports, per role, who is ALIVE — the input to a grow/shrink
    decision against a target size.  Deciding is cheap and read-only;
    *acting* is the caller's move (the ``distributed.supervisor``
    actuator, or an operator starting workers pointed at the checkpoint
    root / retiring leases), with the checkpoint plane making the
    action safe.

    ``hysteresis``: flap damping — a non-hold decision requires that
    many CONSECUTIVE same-direction observations before it fires.  A
    worker blinking SUSPECT→DEAD→HEALTHY across one missed lease term
    must not trigger a grow (and then a shrink when it reappears): one
    divergent observation resets the streak, so only a condition that
    persists across the window acts.  The default of 1 keeps the old
    immediate behavior."""

    def __init__(self, registry_ep: str, poll_ttl: float = 2.0,
                 hysteresis: int = 1):
        from ..distributed import transport as _transport
        self.registry_ep = registry_ep
        self.poll_ttl = poll_ttl
        self.hysteresis = max(1, int(hysteresis))
        self._client = _transport.RPCClient(0)
        self._cache = {"t": float("-inf"), "table": {}}
        # lease-snapshot cache for the capacity dimension (headroom
        # rides lease DATA, not the health table)
        self._snap_cache = {"t": float("-inf"), "data": {}}
        # per-role [direction, consecutive observations] streak
        self._streak: Dict[str, list] = {}

    def fleet_view(self, refresh: bool = False) -> Dict[str, dict]:
        """{worker: {state, role, ...}} from the registry health table,
        cached for ``poll_ttl``."""
        from ..distributed import registry as _registry_mod
        now = time.monotonic()
        if refresh or now - self._cache["t"] >= self.poll_ttl:
            self._cache["t"] = now
            self._cache["table"] = _registry_mod.fetch_health(
                self._client, self.registry_ep,
                connect_timeout=min(2.0, max(0.5, self.poll_ttl)))
        return self._cache["table"]

    def alive(self, role: str) -> List[str]:
        from ..observability import health as _health
        return sorted(w for w, info in self.fleet_view().items()
                      if info.get("role") == role
                      and info.get("state") != _health.DEAD)

    def slo_breaches(self, role: Optional[str] = None) -> Dict[str, list]:
        """Workers whose heartbeat ``slo`` dimension reports breach
        (observability/slo.py rides the health payload): {worker:
        [breached rule names]}.  A breach is a decision INPUT, never a
        resize by itself — :meth:`decide` reports it alongside the
        liveness-driven action so the supervisor/operator can see a
        fleet that is alive but missing its SLOs, damped by the same
        hysteresis discipline (the supervisor requires consecutive
        observations before flagging)."""
        return {w: list(info.get("slo_rules") or [])
                for w, info in self.fleet_view().items()
                if (role is None or info.get("role") == role)
                and info.get("slo") == "breach"}

    def headroom(self, role: Optional[str] = None) -> Dict[str, dict]:
        """Capacity headroom per lease, read from the registry's lease
        DATA payloads (serving/decode servers publish ``headroom_frac``
        / ``binding_phase`` / ``predicted_max_qps`` there iff
        FLAGS_capacity_attribution is on at the replica): {lease key:
        {headroom_frac, binding_phase, ...}}.  ``role`` filters by the
        announce key prefix (``SERVING`` → ``serving/``, ``DECODE`` →
        ``decode/``).  Like :meth:`slo_breaches`, this is an
        INFORMATIONAL decision input — empty when no replica publishes
        capacity (flags off fleet-wide)."""
        from ..distributed import registry as _registry_mod
        now = time.monotonic()
        # lazy init: controllers built without __init__ (test doubles
        # stubbing fleet_view) still get a working cache
        cache = getattr(self, "_snap_cache", None)
        if cache is None:
            cache = self._snap_cache = {"t": float("-inf"), "data": {}}
        if now - self._snap_cache["t"] >= self.poll_ttl:
            self._snap_cache["t"] = now
            try:
                snap = _registry_mod.fetch_snapshot(
                    self._client, self.registry_ep,
                    connect_timeout=min(2.0, max(0.5, self.poll_ttl)))
                self._snap_cache["data"] = dict(snap.get("data") or {})
            except Exception:
                pass    # registry blip: keep the last view
        prefix = {"SERVING": "serving/", "DECODE": "decode/"}.get(
            (role or "").upper())
        out = {}
        for key, data in self._snap_cache["data"].items():
            if prefix is not None and not key.startswith(prefix):
                continue
            if isinstance(data, dict) and "headroom_frac" in data:
                out[key] = {k: data[k] for k in
                            ("headroom_frac", "binding_phase",
                             "predicted_max_qps") if k in data}
        return out

    def memory_headroom(self, role: Optional[str] = None) -> Dict[str, dict]:
        """Measured memory headroom per lease, read from the same lease
        DATA payloads as :meth:`headroom` (servers publish
        ``memory_headroom_frac`` / ``memory_bytes`` there iff
        FLAGS_memory_attribution is on at the replica): {lease key:
        {memory_headroom_frac, memory_bytes, ...}}.  ``role`` filters by
        the announce key prefix like :meth:`headroom`.  INFORMATIONAL —
        empty when no replica publishes memory (flags off fleet-wide)."""
        # reuse headroom()'s snapshot cache discipline (one registry
        # poll feeds both planes)
        self.headroom(role)
        prefix = {"SERVING": "serving/", "DECODE": "decode/"}.get(
            (role or "").upper())
        out = {}
        for key, data in self._snap_cache["data"].items():
            if prefix is not None and not key.startswith(prefix):
                continue
            if isinstance(data, dict) and "memory_headroom_frac" in data:
                out[key] = {k: data[k] for k in
                            ("memory_headroom_frac", "memory_bytes",
                             "memory_parked_bytes", "memory_leak")
                            if k in data}
        return out

    def decide(self, role: str, target: int) -> dict:
        """Grow/shrink recommendation for ``role`` against ``target``
        live workers: {"action": "grow"|"shrink"|"hold", "delta": n,
        "alive": [...], "raw": the undamped direction, "streak": how
        many consecutive observations agreed, "needed": hysteresis}.
        Each call is one observation; ``action`` stays "hold" until
        ``hysteresis`` consecutive calls agree on a direction."""
        alive = self.alive(role)
        obs_t = self._cache["t"]
        n = len(alive)
        raw = "hold" if n == target else ("grow" if n < target
                                          else "shrink")
        if raw == "hold":
            self._streak.pop(role, None)
            streak = 0
        else:
            st = self._streak.get(role)
            if st is not None and st[0] == raw:
                # a repeated decide against the SAME cached table is the
                # same observation — only a fresh poll extends the streak
                if obs_t != st[2]:
                    st[1] += 1
                    st[2] = obs_t
            else:
                st = [raw, 1, obs_t]
                self._streak[role] = st
            streak = st[1]
        action = raw if streak >= self.hysteresis else "hold"
        out = {"action": action, "raw": raw, "streak": streak,
               "needed": self.hysteresis, "delta": abs(target - n),
               "alive": alive, "target": target}
        # SLO breach state rides the same (cached) fleet view as an
        # INFORMATIONAL dimension: it never changes `action` here —
        # liveness decides counts; usefulness is the supervisor's /
        # operator's damped signal (decisions stay HOLD-safe)
        breaches = self.slo_breaches(role)
        if breaches:
            out["slo_breaches"] = breaches
        # capacity headroom is the same HOLD-safe discipline: it rides
        # the decision as `capacity`, never changes `action` (the
        # direct input for a future saturation-driven grow — item 4(a)
        # — without automating it here), and is absent when no replica
        # publishes it (flags off ⇒ byte-identical decisions)
        cap = self.headroom(role)
        if cap:
            out["capacity"] = cap
        # measured memory headroom rides the same way: HOLD-safe,
        # informational, absent when no replica publishes it
        mem = self.memory_headroom(role)
        if mem:
            out["memory"] = mem
        return out
