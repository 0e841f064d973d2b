"""Declarative SLO watchdog: rules over the live metric surface.

The port's copy of ``paddle_tpu/observability/slo.py``.

The self-healing loop acts on liveness alone — a replica can be
alive and useless (TTFT p99 at 4 s) without the fleet ever noticing.
This module evaluates operator-declared rules against the in-process
:mod:`stats` registry and turns sustained violations into every signal
the rest of the stack already consumes:

- ``slo.breaches`` / ``slo.<rule>.breaches`` counters and a
  ``slo.breached`` gauge (how many rules are in breach right now);
- a flight-recorder note per breach/clear transition (the post-mortem
  reads "slo_breach ttft" next to the death it preceded);
- the ``/sloz`` debug page (rule table: live value, threshold, state,
  sustain progress);
- an ``slo`` **health dimension** merged into every registry heartbeat
  payload (``registry.Heartbeat._health_payload``), so the fleet health
  table, :class:`~paddle_tpu.checkpoint.elastic.ElasticController` and
  the supervisor see breach state per worker WITHOUT a new RPC.

Rule grammar (``FLAGS_slo_rules``, semicolon-separated)::

    name=metric:stat(op)threshold[:for=sustain_s]

    ttft=decode.lm.ttft_ms:p99>250:for=5
    errors=serving.mnist.errors:rate>0.5:for=10
    queue=decode.lm.queue_depth:value>48

``stat`` is ``p50``/``p90``/``p99``/``p999`` (histograms — via the
shared :func:`stats.histogram_percentile`, computed over the
observations SINCE the previous evaluation so the rule tracks current
behavior and can clear; an interval with no observations expresses no
opinion), ``rate`` (counters, per-second over the evaluation
interval), or ``value`` (gauges).  A
rule BREACHES only after its condition holds for ``for`` seconds of
consecutive evaluations, and CLEARS only after it fails for the same
window — symmetric hysteresis, so one outlier evaluation can neither
trip nor silence the alarm.  Consumers stay HOLD-safe: a breach is a
decision *input* (reported, damped), never an automatic resize.

Strictly flag-gated: ``FLAGS_slo_rules`` empty (default) means no
watchdog thread, no metric series, and zero bytes added to the
heartbeat payload.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional

from . import flight as _flight
from . import stats as _stats
from ..core import flags as _flags

__all__ = ["SloRule", "SloWatchdog", "parse_rules", "watchdog",
           "maybe_start_from_flags", "health_dimension", "active",
           "sloz", "stop"]

OK = "OK"
PENDING = "PENDING"
BREACH = "BREACH"

_STATS = ("p50", "p90", "p99", "p999", "rate", "value")
# metric charset includes '@' and '/': serving metrics are scoped by
# model@version, registry logical keys by path (serving/<m>/<replica>)
_RULE_RE = re.compile(
    r"^(?P<name>[\w.-]+)=(?P<metric>[\w.:@/-]+):"
    r"(?P<stat>p50|p90|p99|p999|rate|value)"
    r"(?P<op>[<>])(?P<threshold>-?[\d.]+(?:[eE][-+]?\d+)?)"
    r"(?::for=(?P<sustain>[\d.]+))?$")


class SloRule:
    """One parsed rule (see the module-doc grammar)."""

    def __init__(self, name: str, metric: str, stat: str, op: str,
                 threshold: float, sustain_s: float = 0.0):
        if stat not in _STATS:
            raise ValueError(f"slo rule {name!r}: unknown stat {stat!r}")
        if op not in ("<", ">"):
            raise ValueError(f"slo rule {name!r}: op must be < or >")
        self.name = name
        self.metric = metric
        self.stat = stat
        self.op = op
        self.threshold = float(threshold)
        self.sustain_s = float(sustain_s)
        # evaluation state (owned by the watchdog)
        self.state = OK
        self.since: Optional[float] = None     # condition flip time
        self.last_value: Optional[float] = None
        self.breaches = 0
        self._last_counter: Optional[tuple] = None   # (t, value) for rate
        self._last_hist: Optional[dict] = None       # snapshot for pXX

    def condition(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" \
            else value < self.threshold

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "stat": self.stat, "op": self.op,
                "threshold": self.threshold, "sustain_s": self.sustain_s,
                "state": self.state, "last_value": self.last_value,
                "breaches": self.breaches}


def parse_rules(spec: str) -> List[SloRule]:
    """Parse the flag grammar; malformed rules raise ValueError naming
    the offending fragment (a typo'd SLO must fail loudly at arm time,
    not silently never fire)."""
    rules = []
    for frag in str(spec or "").split(";"):
        frag = frag.strip()
        if not frag:
            continue
        m = _RULE_RE.match(frag)
        if m is None:
            raise ValueError(
                f"bad slo rule {frag!r}; expected "
                "'name=metric:stat(<|>)threshold[:for=sustain_s]'")
        rules.append(SloRule(m.group("name"), m.group("metric"),
                             m.group("stat"), m.group("op"),
                             float(m.group("threshold")),
                             float(m.group("sustain") or 0.0)))
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate slo rule names in {spec!r}")
    return rules


class SloWatchdog:
    """Evaluates rules in-process (module doc)."""

    def __init__(self, rules, registry: Optional[_stats.StatsRegistry] = None):
        self.rules: List[SloRule] = (parse_rules(rules)
                                     if isinstance(rules, str)
                                     else list(rules))
        self.registry = registry or _stats.default_registry()
        self._lock = threading.Lock()
        sc = _stats.scope("slo")
        self._c_breaches = sc.counter(
            "breaches", "SLO rule breach transitions (sustained "
            "violations; per-rule twins under slo.<rule>.breaches)")
        self._c_clears = sc.counter("clears", "breach -> OK transitions")
        self._g_breached = sc.gauge(
            "breached", "rules currently in BREACH")

    def _resolve(self, rule: SloRule, now: float) -> Optional[float]:
        m = self.registry.get(rule.metric)
        if m is None:
            return None
        if rule.stat in ("p50", "p90", "p99", "p999"):
            if not isinstance(m, _stats.Histogram):
                return None
            q = {"p50": 0.50, "p90": 0.90, "p99": 0.99,
                 "p999": 0.999}[rule.stat]
            # WINDOWED percentile: over the observations since the
            # previous evaluation (bucket-count delta), like `rate` for
            # counters.  A lifetime-cumulative percentile could never
            # CLEAR — one bad minute an hour ago would hold p99 high
            # forever.  No new observations => no opinion (None)
            snap = m.snapshot()
            prev, rule._last_hist = rule._last_hist, snap
            if prev is None:
                return None
            dcount = snap["count"] - prev["count"]
            if dcount <= 0:
                return None
            dbuckets = {le: cum - prev["buckets"].get(le, 0)
                        for le, cum in snap["buckets"].items()}
            return _stats.histogram_percentile(
                {"buckets": dbuckets, "count": dcount}, q,
                finite_max=m.buckets[-1])
        if rule.stat == "rate":
            v = float(m.value)
            prev = rule._last_counter
            rule._last_counter = (now, v)
            if prev is None or now <= prev[0]:
                return None          # first sighting: no interval yet
            return (v - prev[1]) / (now - prev[0])
        return float(m.value)

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation round; returns breach/clear TRANSITIONS."""
        now = time.monotonic() if now is None else now
        events = []
        with self._lock:
            breached = 0
            for rule in self.rules:
                value = self._resolve(rule, now)
                if value is None:
                    # metric not registered yet / wrong kind: not a
                    # breach (a decode engine that hasn't served yet
                    # must not page anyone)
                    if rule.state != BREACH:
                        rule.state, rule.since = OK, None
                    breached += rule.state == BREACH
                    continue
                rule.last_value = round(float(value), 4)
                cond = rule.condition(value)
                if rule.state == BREACH:
                    if cond:
                        rule.since = None        # still breaching
                    else:
                        if rule.since is None:
                            rule.since = now     # clear window opens
                        if now - rule.since >= rule.sustain_s:
                            rule.state, rule.since = OK, None
                            self._c_clears.inc()
                            events.append({"rule": rule.name,
                                           "event": "clear",
                                           "value": rule.last_value})
                else:
                    if not cond:
                        rule.state, rule.since = OK, None
                    else:
                        if rule.since is None:
                            rule.since = now     # breach window opens
                            rule.state = PENDING
                        if now - rule.since >= rule.sustain_s:
                            rule.state, rule.since = BREACH, None
                            rule.breaches += 1
                            self._c_breaches.inc()
                            _stats.counter(
                                f"slo.{rule.name}.breaches").inc()
                            events.append({"rule": rule.name,
                                           "event": "breach",
                                           "value": rule.last_value,
                                           "threshold": rule.threshold})
                breached += rule.state == BREACH
            self._g_breached.set(breached)
        for ev in events:
            _flight.note(f"slo_{ev['event']}", **ev)
        return events

    def breached(self) -> List[str]:
        with self._lock:
            return [r.name for r in self.rules if r.state == BREACH]

    def health_dimension(self) -> dict:
        """The heartbeat rider: ``{"slo": "ok"|"breach"[, "slo_rules":
        [names]]}`` — small, merge-ready, absent entirely when the
        plane is off (see :func:`health_dimension` below)."""
        names = self.breached()
        if not names:
            return {"slo": "ok"}
        return {"slo": "breach", "slo_rules": names}

    def sloz(self) -> dict:
        """The /sloz payload."""
        with self._lock:
            rules = [r.to_dict() for r in self.rules]
        return {"rules": rules, "breached": self.breached(),
                "eval_interval_s": eval_interval_s()}


_lock = threading.Lock()
_watchdog: Optional[SloWatchdog] = None
_thread: Optional[threading.Thread] = None
_stop = threading.Event()


def rules_spec() -> str:
    try:
        return str(_flags.get_flags("slo_rules") or "")
    except KeyError:  # pragma: no cover - flag always defined
        return ""


def eval_interval_s() -> float:
    try:
        return float(_flags.get_flags("slo_eval_interval_s"))
    except KeyError:  # pragma: no cover - flag always defined
        return 1.0


def active() -> bool:
    """A watchdog exists (armed from flags or installed explicitly)."""
    return _watchdog is not None


def watchdog() -> Optional[SloWatchdog]:
    return _watchdog


def install(wd: Optional[SloWatchdog]) -> Optional[SloWatchdog]:
    """Install (or clear, with None) the process watchdog explicitly —
    servers that build their rules in code rather than flags."""
    global _watchdog
    with _lock:
        _watchdog = wd
    return wd


def maybe_start_from_flags() -> Optional[SloWatchdog]:
    """Arm the watchdog + evaluation thread iff ``FLAGS_slo_rules`` is
    non-empty (idempotent, called next to the debug-server opt-in).
    Flag empty: one dict lookup, nothing else."""
    global _watchdog, _thread
    spec = rules_spec()
    if not spec:
        return _watchdog
    with _lock:
        if _watchdog is None:
            _watchdog = SloWatchdog(spec)
        wd = _watchdog
        if _thread is not None and _thread.is_alive():
            return wd
        _stop.clear()

        def _loop():
            while not _stop.wait(max(0.05, eval_interval_s())):
                try:
                    wd.evaluate()
                except Exception:  # pragma: no cover - never kill host
                    pass

        _thread = threading.Thread(target=_loop, daemon=True,
                                   name="slo-watchdog")
        _thread.start()
    return wd


def stop() -> None:
    """Stop the thread and drop the watchdog (tests)."""
    global _watchdog, _thread
    _stop.set()
    with _lock:
        t, _thread = _thread, None
        _watchdog = None
    if t is not None:
        t.join(timeout=2.0)


def health_dimension() -> dict:
    """What a registry heartbeat merges into its health payload: the
    watchdog's slo dimension, or ``{}`` when no watchdog is armed (the
    wire stays byte-identical to the pre-slo build)."""
    wd = _watchdog
    if wd is None:
        return {}
    try:
        return wd.health_dimension()
    except Exception:  # pragma: no cover - a broken probe never stops a lease
        return {}


def sloz() -> dict:
    """The /sloz page payload (armed or not)."""
    wd = _watchdog
    if wd is None:
        return {"slo": "no rules armed (set FLAGS_slo_rules or "
                       "slo.install(SloWatchdog(...)))"}
    return wd.sloz()
