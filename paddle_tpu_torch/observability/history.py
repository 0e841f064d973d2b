"""Metric history rings: "what changed in the last 10 minutes?"

The port's copy of ``paddle_tpu/observability/history.py``.

Counters and gauges in the :mod:`stats` registry are point-in-time —
without an external scraper there is no way to ask how a metric MOVED.
This module keeps a bounded, self-downsampling time series per
counter/gauge in-process:

- a sampler (thread under ``FLAGS_metrics_history_interval_s``, or
  explicit :meth:`HistoryStore.sample` calls in tests) appends one
  ``(monotonic_ts, value)`` point per metric per period;
- each :class:`SeriesRing` holds at most ``FLAGS_metrics_history_points``
  points; when full it HALVES its resolution — adjacent samples merge
  into their mean, the stored stride doubles — so memory stays bounded
  while the covered window keeps extending (a long-lived server holds a
  coarse day next to a fine last-hour);
- queries (``/varz?window=<s>``, :func:`query`) return ``[[age_s,
  value], ...]`` — ages, not wall clocks.  The STATS_PULL fleet merge
  carries each worker's series the same way, so skewed worker wall
  clocks can never misalign the fleet view: every sample is "N seconds
  before that worker answered the pull".

Strictly flag-gated: with ``FLAGS_metrics_history_interval_s`` at its
default 0 no thread starts, no ring allocates, and ``export_state()``
payloads carry no history key — byte-identical to the pre-history wire.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from . import stats as _stats
from ..core import flags as _flags

__all__ = ["SeriesRing", "HistoryStore", "store", "maybe_start_from_flags",
           "query", "export_history", "varz", "stop"]


class SeriesRing:
    """One metric's bounded, resolution-doubling time series.

    Points are ``(t_monotonic, value)``.  ``append`` accumulates
    ``stride`` raw samples into one stored point (mean value, last
    timestamp); when the ring is full, adjacent stored points merge
    pairwise into their means and ``stride`` doubles.  Mean-of-means
    stays exact because merged pairs hold equal sample counts (an odd
    ring capacity leaves one boundary point approximate; the default
    capacity is even).
    """

    __slots__ = ("capacity", "stride", "_pts", "_acc_n", "_acc_sum",
                 "_acc_t")

    def __init__(self, capacity: int):
        self.capacity = max(8, int(capacity))
        self.stride = 1
        self._pts: List[List[float]] = []    # [t, mean]
        self._acc_n = 0
        self._acc_sum = 0.0
        self._acc_t = 0.0

    def append(self, t: float, v: float) -> None:
        self._acc_n += 1
        self._acc_sum += float(v)
        self._acc_t = t
        if self._acc_n < self.stride:
            return
        self._pts.append([self._acc_t, self._acc_sum / self._acc_n])
        self._acc_n, self._acc_sum = 0, 0.0
        if len(self._pts) >= self.capacity:
            merged = []
            pts = self._pts
            for i in range(0, len(pts) - 1, 2):
                merged.append([pts[i + 1][0],
                               (pts[i][1] + pts[i + 1][1]) / 2.0])
            if len(pts) % 2:                 # odd leftover kept verbatim
                merged.append(pts[-1])
            self._pts = merged
            self.stride *= 2

    def __len__(self) -> int:
        return len(self._pts)

    def points(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[List[float]]:
        """``[[age_s, value], ...]`` oldest-first (ages decreasing)."""
        now = time.monotonic() if now is None else now
        out = []
        for t, v in self._pts:
            age = now - t
            if window_s is not None and age > window_s:
                continue
            out.append([round(age, 3), v])
        return out


class HistoryStore:
    """Every counter/gauge of one registry, ringed (see module doc)."""

    def __init__(self, registry: Optional[_stats.StatsRegistry] = None,
                 points: Optional[int] = None):
        self.registry = registry or _stats.default_registry()
        if points is None:
            points = int(_flags.get_flags("metrics_history_points"))
        self.points = points
        self._lock = threading.Lock()
        self._series: Dict[str, SeriesRing] = {}
        self._samples = 0

    def sample(self, now: Optional[float] = None) -> int:
        """Append one point per counter/gauge (histograms keep their
        own bucket state and are skipped).  Returns metrics sampled."""
        now = time.monotonic() if now is None else now
        snap = self.registry.snapshot()
        n = 0
        with self._lock:
            for name, val in snap.items():
                if isinstance(val, dict):     # histogram snapshot
                    continue
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = SeriesRing(self.points)
                ring.append(now, float(val))
                n += 1
            self._samples += 1
        return n

    def query(self, window_s: Optional[float] = None,
              pattern: str = "", now: Optional[float] = None
              ) -> Dict[str, List[List[float]]]:
        """{metric: [[age_s, value], ...]} within ``window_s``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            items = sorted(self._series.items())
        out = {}
        for name, ring in items:
            if pattern and pattern not in name:
                continue
            pts = ring.points(window_s, now=now)
            if pts:
                out[name] = pts
        return out

    def export_state(self, now: Optional[float] = None) -> dict:
        """Merge-ready wire form for the STATS_PULL fleet aggregation:
        ages only (clock-skew-proof), plus this store's strides so a
        reader knows each series' current resolution."""
        now = time.monotonic() if now is None else now
        with self._lock:
            items = sorted(self._series.items())
            samples = self._samples
        return {"samples": samples,
                "series": {name: ring.points(now=now)
                           for name, ring in items},
                "strides": {name: ring.stride for name, ring in items}}

    def stats(self) -> dict:
        with self._lock:
            return {"series": len(self._series),
                    "samples": self._samples,
                    "points": sum(len(r) for r in self._series.values()),
                    "capacity_points": self.points}


_lock = threading.Lock()
_store: Optional[HistoryStore] = None
_thread: Optional[threading.Thread] = None
_stop = threading.Event()


def interval_s() -> float:
    try:
        return float(_flags.get_flags("metrics_history_interval_s"))
    except KeyError:  # pragma: no cover - flag always defined
        return 0.0


def enabled() -> bool:
    return interval_s() > 0.0


def store(create: bool = False) -> Optional[HistoryStore]:
    """The process-wide store (None until armed)."""
    global _store
    with _lock:
        if _store is None and create:
            _store = HistoryStore()
        return _store


def maybe_start_from_flags() -> Optional[HistoryStore]:
    """Arm the sampler thread iff ``FLAGS_metrics_history_interval_s``
    > 0 (idempotent; called next to the debug-server opt-in).  Flag at
    its default 0: one dict lookup, nothing else."""
    global _thread
    if not enabled():
        return _store
    st = store(create=True)
    with _lock:
        if _thread is not None and _thread.is_alive():
            return st
        _stop.clear()

        def _loop():
            while not _stop.wait(max(0.05, interval_s())):
                try:
                    st.sample()
                except Exception:  # pragma: no cover - never kill host
                    pass

        _thread = threading.Thread(target=_loop, daemon=True,
                                   name="metrics-history-sampler")
        _thread.start()
    return st


def stop() -> None:
    """Stop the sampler and drop the store (tests)."""
    global _store, _thread
    _stop.set()
    with _lock:
        t, _thread = _thread, None
        _store = None
    if t is not None:
        t.join(timeout=2.0)


def query(window_s: Optional[float] = None, pattern: str = ""
          ) -> Dict[str, List[List[float]]]:
    st = store()
    return st.query(window_s, pattern) if st is not None else {}


def export_history() -> Optional[dict]:
    """The STATS_PULL rider: this process's series, or None when the
    plane is off (the payload then stays byte-identical to the
    pre-history wire)."""
    st = store()
    if st is None:
        return None
    return st.export_state()


def varz(window_s: Optional[float] = None, pattern: str = "") -> dict:
    """The /varz page payload."""
    st = store()
    if st is None:
        return {"history": "disabled (set FLAGS_metrics_history_"
                           "interval_s > 0)"}
    out = {"interval_s": interval_s(), **st.stats()}
    out["window_s"] = window_s
    out["series_points"] = query(window_s, pattern)
    return out
