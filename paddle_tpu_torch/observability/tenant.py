"""Per-tenant usage metering: who is consuming the replica's capacity?

The port's copy of ``paddle_tpu/observability/tenant.py``.

Serving and decode submissions may carry an optional, client-supplied
``tenant`` id (wire-optional — an absent id leaves INFER/DECODE frames
byte-identical, so old peers interoperate both ways).  When
``FLAGS_tenant_accounting`` is armed, every submission is folded into a
process-wide :class:`TenantMeter`:

- per-tenant counters: requests, rows, prefill tokens, decode tokens,
  cancellations;
- per-tenant **device-ms**, attributed proportionally from the shared
  batch's device wall (a serving batch splits its materialization wall
  by row share; a decode step splits its step wall evenly over the
  LIVE slots) — so per-tenant device-ms sums to the measured device
  time by construction;
- per-tenant latency p99 over a bounded recent-sample ring.

Cardinality is bounded by a **space-saving** (Misra–Gries family)
heavy-hitter sketch: at most ``FLAGS_tenant_top_k`` tenants are tracked
exactly; when a new tenant arrives at capacity, the smallest tracked
entry is evicted — its accumulated usage rolls into the ``other``
bucket and the newcomer inherits the evicted weight as its error bound
(the classic guarantee: any true heavy hitter stays in the table).  An
adversarial id stream can therefore never grow memory or the
``/tenantz`` payload.

Trust caveat: tenant ids are CLIENT-SUPPLIED and unauthenticated —
this is attribution for capacity planning and abuse triage, not a
security boundary.  Ids are clipped to a sane length; requests without
an id are accounted under ``"-"`` so attribution always sums to the
measured totals.

Off (default): submissions' tenant ids are ignored, no sketch exists,
no metric series register, and the STATS_PULL rider
(:func:`export_state`) returns ``None`` — byte-identical payloads.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

from ..core import flags as _flags
from . import stats as _stats

__all__ = [
    "TenantMeter",
    "enabled",
    "top_k",
    "meter",
    "account",
    "tenantz",
    "tenantz_text",
    "export_state",
    "merge_states",
    "reset",
]

UNTENANTED = "-"        # reserved id for requests without a tenant
OTHER = "other"         # the eviction rollup bucket
CANARY = "__canary__"   # reserved id for golden canary probes (canary.py)
                        # — synthetic traffic, excluded from metering
_MAX_ID_LEN = 64        # clip abusive ids (attribution, not storage)
_LAT_RING = 128         # per-tenant recent-latency samples for p99

_DIMS = ("requests", "rows", "prefill_tokens", "decode_tokens",
         "cancellations", "device_ms", "resident_kv_bytes")


def enabled() -> bool:
    """Is tenant accounting armed (``FLAGS_tenant_accounting``)?"""
    try:
        return bool(_flags.get_flags("tenant_accounting"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


def top_k() -> int:
    try:
        return max(1, int(_flags.get_flags("tenant_top_k")))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return 20


class _Entry:
    __slots__ = ("weight", "error", "dims", "lat")

    def __init__(self, weight: float = 0.0, error: float = 0.0):
        self.weight = weight          # space-saving rank key
        self.error = error            # inherited over-count bound
        self.dims = dict.fromkeys(_DIMS, 0.0)
        self.lat: deque = deque(maxlen=_LAT_RING)

    def fold(self, other: "_Entry") -> None:
        for d in _DIMS:
            self.dims[d] += other.dims[d]
        self.weight += other.weight


class TenantMeter:
    """Bounded per-tenant usage table (space-saving top-K sketch)."""

    def __init__(self, k: Optional[int] = None):
        self.k = int(k) if k else top_k()
        self._lock = threading.Lock()
        self._table: Dict[str, _Entry] = {}
        self._other = _Entry()        # eviction rollup (not ranked)
        self._evictions = 0

    def account(self, tenant: Optional[str], requests: int = 0,
                rows: int = 0, prefill_tokens: int = 0,
                decode_tokens: int = 0, cancellations: int = 0,
                device_ms: float = 0.0,
                resident_kv_bytes: float = 0.0,
                latency_ms: Optional[float] = None) -> None:
        """Fold one observation into the tenant's entry (admitting or
        evicting per the space-saving discipline).
        ``resident_kv_bytes`` is a signed DELTA (blocks held × block
        bytes, + at admission / block growth, − at retire/preempt), so
        the dimension reads as the tenant's CURRENT resident KV
        footprint — "whose bytes", next to device_ms's "whose time"."""
        tid = self._clip(tenant)
        with self._lock:
            ent = self._table.get(tid)
            if ent is None:
                if len(self._table) < self.k:
                    ent = self._table[tid] = _Entry()
                else:
                    # evict the minimum-weight entry into `other`; the
                    # newcomer inherits its weight as the error bound
                    victim = min(self._table, key=lambda t:
                                 self._table[t].weight)
                    evicted = self._table.pop(victim)
                    self._other.fold(evicted)
                    self._evictions += 1
                    ent = self._table[tid] = _Entry(
                        weight=evicted.weight, error=evicted.weight)
            ent.weight += requests
            d = ent.dims
            d["requests"] += requests
            d["rows"] += rows
            d["prefill_tokens"] += prefill_tokens
            d["decode_tokens"] += decode_tokens
            d["cancellations"] += cancellations
            d["device_ms"] += device_ms
            d["resident_kv_bytes"] += resident_kv_bytes
            if latency_ms is not None:
                ent.lat.append(float(latency_ms))

    @staticmethod
    def _clip(tenant: Optional[str]) -> str:
        if not tenant:
            return UNTENANTED
        tid = str(tenant)
        return tid[:_MAX_ID_LEN] if len(tid) > _MAX_ID_LEN else tid

    def snapshot(self) -> dict:
        with self._lock:
            tenants = {}
            for tid, ent in self._table.items():
                rec = {d: (round(v, 3) if d == "device_ms" else int(v))
                       for d, v in ent.dims.items()}
                rec["weight_error"] = round(ent.error, 1)
                if ent.lat:
                    rec["p99_ms"] = round(_stats.percentile_sorted(
                        sorted(ent.lat), 0.99), 3)
                tenants[tid] = rec
            out = {"top_k": self.k,
                   "tracked": len(tenants),
                   "evictions": self._evictions,
                   "tenants": tenants}
            if self._evictions:
                out[OTHER] = {
                    d: (round(v, 3) if d == "device_ms" else int(v))
                    for d, v in self._other.dims.items()}
            return out


# -- module singleton -----------------------------------------------------
_lock = threading.Lock()
_meter: Optional[TenantMeter] = None


def meter(create: bool = True) -> Optional[TenantMeter]:
    """The process-wide meter (lazily created when the flag is on)."""
    global _meter
    with _lock:
        if _meter is None and create and enabled():
            _meter = TenantMeter()
        return _meter


def account(tenant: Optional[str], **kw) -> None:
    """Module-level fold — a no-op unless the flag is armed.  Canary
    probes (the reserved ``__canary__`` id) are synthetic traffic and
    never enter user accounting."""
    if not enabled() or tenant == CANARY:
        return
    m = meter()
    if m is not None:
        m.account(tenant, **kw)


def reset() -> None:
    """Drop the meter (tests / bench config isolation)."""
    global _meter
    with _lock:
        _meter = None


# -- pages / riders -------------------------------------------------------
def tenantz() -> dict:
    """The ``/tenantz`` payload."""
    if not enabled():
        return {"tenants": "disabled (set FLAGS_tenant_accounting)"}
    m = meter(create=False)
    if m is None:
        return {"tenants": {}, "tracked": 0, "top_k": top_k(),
                "evictions": 0}
    return m.snapshot()


def tenantz_text(payload: Optional[dict] = None) -> str:
    """Human rendering of :func:`tenantz` (``/tenantz?text=1``)."""
    payload = payload if payload is not None else tenantz()
    tenants = payload.get("tenants")
    if not isinstance(tenants, dict) or not tenants:
        return "tenants: none tracked (flag off or no traffic)\n"
    lines = [f"top_k={payload.get('top_k')} "
             f"tracked={payload.get('tracked')} "
             f"evictions={payload.get('evictions')}"]
    hdr = ("tenant", "reqs", "rows", "prefill_tok", "decode_tok",
           "cancel", "device_ms", "kv_bytes", "p99_ms")
    lines.append(
        "{:<18}{:>8}{:>8}{:>12}{:>11}{:>8}{:>12}{:>10}{:>9}".format(*hdr))
    ordered = sorted(tenants,
                     key=lambda t: -tenants[t].get("device_ms", 0.0))
    for tid in ordered:
        r = tenants[tid]
        lines.append(
            "{:<18}{:>8}{:>8}{:>12}{:>11}{:>8}{:>12}{:>10}{:>9}".format(
                tid[:17], r.get("requests", 0), r.get("rows", 0),
                r.get("prefill_tokens", 0), r.get("decode_tokens", 0),
                r.get("cancellations", 0), r.get("device_ms", 0.0),
                r.get("resident_kv_bytes", 0), r.get("p99_ms", "-")))
    other = payload.get(OTHER)
    if other:
        lines.append(
            "{:<18}{:>8}{:>8}{:>12}{:>11}{:>8}{:>12}{:>10}{:>9}".format(
                OTHER, other.get("requests", 0), other.get("rows", 0),
                other.get("prefill_tokens", 0),
                other.get("decode_tokens", 0),
                other.get("cancellations", 0),
                other.get("device_ms", 0.0),
                other.get("resident_kv_bytes", 0), "-"))
    return "\n".join(lines) + "\n"


def export_state() -> Optional[dict]:
    """The STATS_PULL rider — None when off / no meter (byte-identity)."""
    if not enabled():
        return None
    m = meter(create=False)
    if m is None:
        return None
    return m.snapshot()


def merge_states(per_worker: Dict[str, dict]) -> dict:
    """Fleet rollup of per-worker :func:`export_state` payloads: dims
    sum per tenant, the merged table re-trims to top-K by request
    count (overflow folds into ``other``), p99 takes the worst worker
    — so a fleet-wide heavy hitter is visible from one endpoint."""
    k = top_k()
    merged: Dict[str, dict] = {}
    other = dict.fromkeys(_DIMS, 0.0)
    evictions = 0
    for snap in per_worker.values():
        if not isinstance(snap, dict):
            continue
        evictions += int(snap.get("evictions") or 0)
        for tid, rec in (snap.get("tenants") or {}).items():
            agg = merged.setdefault(tid, dict.fromkeys(_DIMS, 0.0))
            for d in _DIMS:
                agg[d] += float(rec.get(d) or 0.0)
            p99 = rec.get("p99_ms")
            if isinstance(p99, (int, float)):
                agg["p99_ms"] = max(float(p99),
                                    agg.get("p99_ms", 0.0))
        o = snap.get(OTHER)
        if isinstance(o, dict):
            for d in _DIMS:
                other[d] += float(o.get(d) or 0.0)
    keep = sorted(merged, key=lambda t: -merged[t]["requests"])[:k]
    for tid in list(merged):
        if tid not in keep:
            rec = merged.pop(tid)
            for d in _DIMS:
                other[d] += rec[d]
    out = {"top_k": k, "tracked": len(merged), "evictions": evictions,
           "tenants": {
               tid: {d: (round(v, 3) if d in ("device_ms", "p99_ms")
                         else int(v))
                     for d, v in rec.items()}
               for tid, rec in merged.items()}}
    if any(other.values()):
        out[OTHER] = {d: (round(v, 3) if d == "device_ms" else int(v))
                      for d, v in other.items()}
    return out
