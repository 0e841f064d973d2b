"""Saturation anatomy: phase-level utilization and capacity modeling.

The port's copy of ``paddle_tpu/observability/capacity.py``.

``FLAGS_phase_attribution`` (observability/phase.py) made latency
*attributable* — each request knows where its milliseconds went.  This
module answers the next question a fleet sizer needs: **how close to
saturation is each replica, and which phase binds first?**

One :class:`CapacityTracker` per pipeline (one per serving batcher, one
per decode engine) accounts per-component BUSY time — wall-clock spans
during which that component's single worker thread was occupied — into
a bounded sliding window:

- serving: ``assemble`` (feed concatenation on the scheduler thread),
  ``dispatch`` (predictor enqueue, same thread), ``device`` (host-side
  materialization drain on the completer thread), ``reply`` (slicing +
  future delivery, same thread);
- decode: ``prefill`` (bucketed prompt prefill) and ``decode`` (the
  fixed-width decode step), both on the engine thread.

Because each component's spans come from ONE serial thread, windowed
``busy/wall`` is a true utilization in [0, 1].  From there the
operational laws do the rest: with X = completions/s observed in the
window and S = busy-ms-per-completion of a component, U = X*S — so the
capacity ceiling of the pipeline is the throughput at which the BINDING
component (max U) reaches U = 1::

    S_b               = busy_ms(binding) / completions(window)
    predicted_max_qps = 1000 / S_b
    headroom_frac     = 1 - U(binding)

Per-bucket service-time fits (``device`` busy keyed by the padded batch
bucket, decode ``prefill`` by the prompt bucket) expose how the padding
ladder shifts S, and a saturation ``verdict`` names the binding phase
(``ok`` / ``approaching`` / ``saturated``).

Everything is gated by ``FLAGS_capacity_attribution``: off (default),
no tracker is created, no ``*.util.*`` gauge series exist, and the
STATS_PULL rider (:func:`export_state`) returns ``None`` so snapshots
stay byte-identical.  All accounting is host-side clock arithmetic on
stamps the hot paths already take — zero added device syncs.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import flags as _flags
from . import stats as _stats

__all__ = [
    "CapacityTracker",
    "enabled",
    "tracker",
    "get",
    "unregister",
    "trackers",
    "capacityz",
    "capacityz_text",
    "headroom",
    "export_state",
    "merge_states",
    "reset",
]

# default snapshot window (seconds) — long enough to smooth scheduler
# jitter, short enough that a load change shows within a scrape or two
DEFAULT_WINDOW_S = 30.0

# verdict thresholds on the binding component's utilization
APPROACHING_UTIL = 0.60
SATURATED_UTIL = 0.85

_SLOT_S = 2.0          # busy-window slot width
_SLOTS = 64            # retained slots (128 s — covers any sane window)


def enabled() -> bool:
    """Is capacity attribution armed (``FLAGS_capacity_attribution``)?"""
    try:
        return bool(_flags.get_flags("capacity_attribution"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


class _BusyWindow:
    """Bounded time-sliced accumulator of (busy_ms, work) samples.

    Slots are ``_SLOT_S`` wide; at most ``_SLOTS`` are retained, so
    memory is O(1) regardless of request rate.  Not thread-safe — the
    owning tracker serializes access under its lock.
    """

    __slots__ = ("_slots",)

    def __init__(self):
        self._slots: Dict[int, List[float]] = {}  # idx -> [busy_ms, work]

    def add(self, busy_ms: float, work: float, now: float) -> None:
        idx = int(now / _SLOT_S)
        slot = self._slots.get(idx)
        if slot is None:
            if len(self._slots) >= _SLOTS:
                for old in sorted(self._slots)[:len(self._slots) - _SLOTS + 1]:
                    del self._slots[old]
            self._slots[idx] = [busy_ms, work]
        else:
            slot[0] += busy_ms
            slot[1] += work

    def window(self, now: float, window_s: float) -> Tuple[float, float]:
        """(busy_ms, work) summed over slots younger than ``window_s``."""
        lo = int((now - window_s) / _SLOT_S)
        busy = work = 0.0
        for idx, (b, w) in self._slots.items():
            if idx >= lo:
                busy += b
                work += w
        return busy, work


class CapacityTracker:
    """Windowed busy-time accounting for one pipeline's components."""

    def __init__(self, name: str, components: Sequence[str]):
        self.name = name
        self.components = tuple(components)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._busy = {c: _BusyWindow() for c in self.components}
        self._done = _BusyWindow()          # completions (work = count)
        # lifetime per-(component, bucket) service fits:
        # (count, busy_ms, rows) — bucketed components only
        self._fits: Dict[Tuple[str, object], List[float]] = {}
        sc = _stats.scope(name)
        self._gauges = {c: sc.gauge(f"util.{c}") for c in self.components}
        self._headroom_g = sc.gauge("util.headroom_frac")

    # -- accounting (hot path; one dict update under a short lock) -------
    def note(self, component: str, busy_ms: float,
             bucket=None, work: float = 0.0) -> None:
        """Account ``busy_ms`` of busy wall to ``component`` (one span
        of its serial worker thread).  ``bucket`` keys a lifetime
        service-time fit; ``work`` is the rows/requests the span
        covered (for the per-bucket rows/s ceiling)."""
        if busy_ms < 0.0:
            busy_ms = 0.0
        now = time.monotonic()
        with self._lock:
            win = self._busy.get(component)
            if win is None:       # unknown component: file, don't drop
                win = self._busy[component] = _BusyWindow()
            win.add(busy_ms, work, now)
            if bucket is not None:
                fit = self._fits.get((component, bucket))
                if fit is None:
                    self._fits[(component, bucket)] = [1.0, busy_ms,
                                                       float(work)]
                else:
                    fit[0] += 1.0
                    fit[1] += busy_ms
                    fit[2] += float(work)

    def note_done(self, n: int = 1) -> None:
        """Account ``n`` pipeline completions (the X of U = X*S)."""
        now = time.monotonic()
        with self._lock:
            self._done.add(0.0, float(n), now)

    # -- modeling --------------------------------------------------------
    def snapshot(self, window_s: float = DEFAULT_WINDOW_S) -> dict:
        """Utilization + operational-law capacity estimate over the
        trailing ``window_s`` seconds (bounded by the tracker's age)."""
        now = time.monotonic()
        span_s = max(1e-6, min(window_s, now - self._t0))
        with self._lock:
            per = {c: w.window(now, window_s)
                   for c, w in self._busy.items()}
            _, done = self._done.window(now, window_s)
            fits = {k: list(v) for k, v in self._fits.items()}
        comps = {}
        binding = None
        for c, (busy_ms, work) in per.items():
            util = min(1.0, busy_ms / (span_s * 1000.0))
            comps[c] = {"busy_ms": round(busy_ms, 3),
                        "util": round(util, 4)}
            if binding is None or (util, busy_ms) > (
                    comps[binding]["util"], comps[binding]["busy_ms"]):
                binding = c
        out = {"name": self.name,
               "window_s": round(span_s, 3),
               "components": comps,
               "completed": int(done),
               "qps": round(done / span_s, 3)}
        if binding is not None:
            b = comps[binding]
            out["binding_phase"] = binding
            out["utilization"] = b["util"]
            out["headroom_frac"] = round(1.0 - b["util"], 4)
            if done > 0 and b["busy_ms"] > 0:
                s_ms = b["busy_ms"] / done
                out["service_ms"] = round(s_ms, 3)
                out["predicted_max_qps"] = round(1000.0 / s_ms, 2)
            out["verdict"] = (
                "saturated" if b["util"] >= SATURATED_UTIL else
                "approaching" if b["util"] >= APPROACHING_UTIL else "ok")
        for c, g in self._gauges.items():
            if c in comps:
                g.set(comps[c]["util"])
        if "headroom_frac" in out:
            self._headroom_g.set(out["headroom_frac"])
        bucket_fits: Dict[str, dict] = {}
        for (comp, bucket), (count, busy_ms, rows) in fits.items():
            ent = {"count": int(count),
                   "mean_ms": round(busy_ms / count, 3)}
            if rows > 0 and busy_ms > 0:
                ent["rows_per_s_cap"] = round(rows / (busy_ms / 1000.0), 1)
            bucket_fits.setdefault(comp, {})[str(bucket)] = ent
        if bucket_fits:
            out["bucket_fits"] = bucket_fits
        return out

    def headroom(self) -> Optional[dict]:
        """The compact lease-data rider: headroom + binding phase +
        predicted ceiling, or None before any completion."""
        snap = self.snapshot()
        if "headroom_frac" not in snap or not snap.get("completed"):
            return None
        out = {"headroom_frac": snap["headroom_frac"],
               "binding_phase": snap["binding_phase"]}
        if "predicted_max_qps" in snap:
            out["predicted_max_qps"] = snap["predicted_max_qps"]
        return out


# -- module registry (one tracker per live pipeline) ----------------------
_lock = threading.Lock()
_trackers: Dict[str, CapacityTracker] = {}


def tracker(name: str, components: Sequence[str]) -> CapacityTracker:
    """Get-or-create the named tracker.  Callers gate on
    :func:`enabled` — creating one instantiates its gauge series."""
    with _lock:
        t = _trackers.get(name)
        if t is None:
            t = _trackers[name] = CapacityTracker(name, components)
        return t


def get(name: str) -> Optional[CapacityTracker]:
    with _lock:
        return _trackers.get(name)


def unregister(name: str) -> None:
    with _lock:
        _trackers.pop(name, None)


def trackers() -> Dict[str, CapacityTracker]:
    with _lock:
        return dict(_trackers)


def reset() -> None:
    """Drop all trackers (tests / bench config isolation)."""
    with _lock:
        _trackers.clear()


# -- pages / riders -------------------------------------------------------
def capacityz(window_s: float = DEFAULT_WINDOW_S) -> dict:
    """The ``/capacityz`` payload: one snapshot per live tracker."""
    if not enabled():
        return {"capacity": "disabled (set FLAGS_capacity_attribution)"}
    return {"window_s": window_s,
            "pipelines": {n: t.snapshot(window_s)
                          for n, t in trackers().items()}}


def capacityz_text(payload: Optional[dict] = None) -> str:
    """Human rendering of :func:`capacityz` (``/capacityz?text=1``)."""
    payload = payload if payload is not None else capacityz()
    pipes = payload.get("pipelines")
    if not isinstance(pipes, dict) or not pipes:
        return "capacity: no live pipelines (flag off or nothing served)\n"
    lines = []
    for name in sorted(pipes):
        s = pipes[name]
        lines.append(f"== {name} ==")
        lines.append(
            "  verdict={} binding={} util={:.1%} headroom={:.1%} "
            "qps={} predicted_max_qps={}".format(
                s.get("verdict", "-"), s.get("binding_phase", "-"),
                s.get("utilization", 0.0), s.get("headroom_frac", 1.0),
                s.get("qps", 0.0), s.get("predicted_max_qps", "-")))
        for c in sorted(s.get("components", {})):
            e = s["components"][c]
            lines.append(f"  {c:<10} busy_ms={e['busy_ms']:<10} "
                         f"util={e['util']:.1%}")
        for comp, buckets in sorted(s.get("bucket_fits", {}).items()):
            for b in sorted(buckets, key=lambda x: (len(x), x)):
                f = buckets[b]
                lines.append(
                    f"  fit {comp}[{b}] n={f['count']} "
                    f"mean_ms={f['mean_ms']}"
                    + (f" rows_per_s_cap={f['rows_per_s_cap']}"
                       if "rows_per_s_cap" in f else ""))
    return "\n".join(lines) + "\n"


def headroom() -> Dict[str, dict]:
    """{tracker name: compact headroom rider} for every pipeline that
    has completed work — what /healthz and the lease data carry."""
    out = {}
    for name, t in trackers().items():
        h = t.headroom()
        if h is not None:
            out[name] = h
    return out


def export_state() -> Optional[dict]:
    """The STATS_PULL rider: per-pipeline snapshots, or None when the
    flag is off / nothing tracked (payload byte-identity)."""
    if not enabled():
        return None
    t = trackers()
    if not t:
        return None
    return {n: tr.snapshot() for n, tr in t.items()}


def merge_states(per_worker: Dict[str, dict]) -> dict:
    """Fleet rollup of per-worker :func:`export_state` payloads.

    Pipelines are per-replica (no shared queue), so fleet capacity SUMS
    predicted ceilings per pipeline name while headroom takes the MIN
    (the tightest replica binds a balanced fleet first).
    """
    fleet: Dict[str, dict] = {}
    for worker, pipes in per_worker.items():
        if not isinstance(pipes, dict):
            continue
        for name, snap in pipes.items():
            if not isinstance(snap, dict):
                continue
            agg = fleet.setdefault(name, {
                "replicas": 0, "qps": 0.0, "predicted_max_qps": 0.0,
                "headroom_frac": None, "binding_phase": None,
                "min_headroom_worker": None})
            agg["replicas"] += 1
            agg["qps"] = round(agg["qps"] + float(snap.get("qps") or 0.0), 3)
            if isinstance(snap.get("predicted_max_qps"), (int, float)):
                agg["predicted_max_qps"] = round(
                    agg["predicted_max_qps"] + snap["predicted_max_qps"], 2)
            hf = snap.get("headroom_frac")
            if isinstance(hf, (int, float)) and (
                    agg["headroom_frac"] is None
                    or hf < agg["headroom_frac"]):
                agg["headroom_frac"] = hf
                agg["binding_phase"] = snap.get("binding_phase")
                agg["min_headroom_worker"] = worker
    return fleet
