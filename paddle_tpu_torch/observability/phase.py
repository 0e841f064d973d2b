"""Per-request latency-phase attribution: where did the p99 go?

The port's copy of ``paddle_tpu/observability/phase.py``.

The serving and decode planes used to export ONE end-to-end latency
histogram per model — enough to see a tail regression, useless for
operating on it (queue wait, batch assembly, device execution and
readback/reply all hide inside one number).  This module gives every
request a :class:`PhaseTimeline` of monotonic stamps through its
lifecycle and folds the finished timelines into a per-model
:class:`PhaseRecorder`:

- one fixed-bucket histogram per phase (``<scope>.phase.<name>``,
  exported like any other metric — /metrics, STATS_PULL fleet merge);
- a bounded per-request sample ring (the "request flight recorder") —
  the raw recent tail an operator reads after a spike;
- slowest-request exemplars (top-N by total) that keep their trace ids,
  so the worst request links straight into the PR-4 distributed trace.

**The invariant**: a timeline's phases are consecutive deltas of ONE
``time.monotonic()`` clock, so recorded phase durations sum EXACTLY to
the recorded end-to-end wall — a p99 regression always names its phase,
nothing leaks into an unattributed gap.  (Tests pin the recorded total
against an externally measured wall within 5%.)

Strictly flag-gated (``FLAGS_phase_attribution``): stamps are host-side
``time.monotonic()`` reads only (zero device syncs), and with the flag
off no timeline is created and no ``*.phase.*`` series ever registers —
the metric surface is byte-identical to the pre-phase build.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from . import stats as _stats
from ..core import flags as _flags

# phase histograms reuse the default ms buckets; the sample ring and
# exemplar list are small fixed bounds (operator tails, not archives)
_SAMPLE_RING = 64
_EXEMPLARS = 8


def enabled() -> bool:
    """One dict lookup — the per-request gate."""
    try:
        return bool(_flags.get_flags("phase_attribution"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


class PhaseTimeline:
    """Monotonic stamps along one request's lifecycle.

    ``stamp(name)`` closes the interval that started at the previous
    stamp (or at construction) and labels it ``name``; ``durations()``
    returns the ordered ``{name: ms}`` map whose values sum to
    ``total_ms()`` by construction.
    """

    __slots__ = ("t0", "marks")

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.monotonic() if t0 is None else t0
        self.marks: List[tuple] = []

    def stamp(self, name: str, t: Optional[float] = None) -> None:
        """Close the current interval as ``name``.  ``t`` lets a batch
        event stamp many timelines with ONE clock read; stamps are
        clamped monotonic so a shared batch timestamp that races a
        per-request stamp can never produce a negative phase."""
        now = time.monotonic() if t is None else t
        last = self.marks[-1][1] if self.marks else self.t0
        self.marks.append((name, max(now, last)))

    def total_ms(self) -> float:
        if not self.marks:
            return 0.0
        return (self.marks[-1][1] - self.t0) * 1e3

    def durations(self) -> Dict[str, float]:
        """Ordered {phase: ms}; values sum to total_ms() exactly."""
        out: Dict[str, float] = {}
        prev = self.t0
        for name, t in self.marks:
            out[name] = out.get(name, 0.0) + (t - prev) * 1e3
            prev = t
        return out


class PhaseRecorder:
    """One model/plane's phase aggregation (see module doc).

    Histograms are created lazily on the first observed timeline so a
    flag-off process never registers ``*.phase.*`` series.
    """

    def __init__(self, scope: str, phases: Sequence[str] = ()):
        self.scope = scope
        self._declared = tuple(phases)
        self._lock = threading.Lock()
        self._hists: Dict[str, _stats.Histogram] = {}
        self._total: Optional[_stats.Histogram] = None
        self._ring: deque = deque(maxlen=_SAMPLE_RING)
        self._slowest: List[dict] = []   # kept sorted, slowest first
        self._observed = 0

    def _hist(self, phase: str) -> _stats.Histogram:
        h = self._hists.get(phase)
        if h is None:
            h = _stats.histogram(f"{self.scope}.phase.{phase}_ms")
            self._hists[phase] = h
        return h

    def observe(self, tl: PhaseTimeline, trace_id: Optional[int] = None,
                **meta) -> None:
        """Fold one finished timeline in (engine/batcher side)."""
        durs = tl.durations()
        total = tl.total_ms()
        sample = {"ts": time.time(), "total_ms": round(total, 3),
                  "phases": {k: round(v, 3) for k, v in durs.items()}}
        if trace_id:
            sample["trace_id"] = format(trace_id, "x")
        if meta:
            sample.update(meta)
        with self._lock:
            for k, v in durs.items():
                self._hist(k).observe(v)
            if self._total is None:
                self._total = _stats.histogram(
                    f"{self.scope}.phase.total_ms")
            self._total.observe(total)
            self._observed += 1
            self._ring.append(sample)
            # slowest-request exemplars: tiny N, insertion sort is fine
            self._slowest.append(sample)
            self._slowest.sort(key=lambda s: -s["total_ms"])
            del self._slowest[_EXEMPLARS:]

    def snapshot(self) -> dict:
        """The /servingz//decodez payload: per-phase percentiles, the
        slowest-phase attribution, recent samples, exemplars."""
        with self._lock:
            hists = dict(self._hists)
            total = self._total
            recent = list(self._ring)[-16:]
            slowest = [dict(s) for s in self._slowest]
            observed = self._observed
        phases = {}
        worst_name, worst_p99 = None, -1.0
        for name, h in hists.items():
            snap = h.snapshot()
            p50 = _stats.histogram_percentile(snap, 0.50,
                                              finite_max=h.buckets[-1])
            p99 = _stats.histogram_percentile(snap, 0.99,
                                              finite_max=h.buckets[-1])
            phases[name] = {"count": snap["count"],
                            "mean_ms": round(snap["sum"]
                                             / max(snap["count"], 1), 3),
                            "p50_ms": round(p50, 3),
                            "p99_ms": round(p99, 3)}
            if p99 > worst_p99:
                worst_name, worst_p99 = name, p99
        out = {"observed": observed, "phases": phases,
               "slowest_phase": worst_name,
               "recent": recent, "slowest_requests": slowest}
        if total is not None:
            tsnap = total.snapshot()
            out["total_p99_ms"] = round(_stats.histogram_percentile(
                tsnap, 0.99, finite_max=total.buckets[-1]), 3)
        return out

    def phase_p99_ms(self) -> Dict[str, float]:
        """{phase: p99 ms} — the bench-artifact form."""
        snap = self.snapshot()
        return {name: ent["p99_ms"]
                for name, ent in snap["phases"].items()}
