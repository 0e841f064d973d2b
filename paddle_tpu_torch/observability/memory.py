"""Memory anatomy: per-pool device-memory attribution, allocation
timelines, and OOM forensics.

The port of ``paddle_tpu/observability/memory.py``.  The decode plane
lives or dies by memory economics — refcounted copy-on-write KV blocks,
overcommit admission and preemption all trade device bytes for
throughput — so device memory is an accounted resource here.

This module is the process-wide **MemoryLedger**.  Every byte-holding
subsystem registers a :class:`MemoryPool` reporting
``reserved``/``used``/``parked`` bytes through a cheap callback (the
decode KV block pool, serving batch staging).  From the pool set the
ledger derives:

- **Reconciliation**: per device, the sum of attributed device-pool
  bytes is compared against the device's bytes in use, and the
  difference is published as an explicit ``unattributed_bytes``
  residual.  The identity ``attributed + unattributed == bytes_in_use``
  holds exactly by construction (the residual may be negative:
  over-attribution is a bug worth seeing too).  What ``bytes_in_use``
  is, per device key:

  - a CUDA card ``d<i>``: the caching allocator's live tensor bytes,
    ``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]``
    (weights, activations and every other tensor the process holds
    there, so the residual names what no pool claims);
  - the host, key ``cpu``: the bytes of the distinct storages of the
    tensors that the pools registered (``pool(..., tensors=)``), each
    storage counted once however many registered tensors view it.
    PyTorch keeps no list of live host tensors (the counterpart of the
    reference's ``jax.live_arrays()``), so on the host ``bytes_in_use``
    is defined over what the pools hold, and a pool whose ``reserved``
    bytes are the bytes of its registered tensors (the KV block pool)
    reconciles to a zero residual.
- **Allocation event ring**: a bounded ring of
  alloc/free/park/reclaim/preempt/evict records with sizes and pool
  ids (``FLAGS_memory_event_ring`` capacity), the timeline half of a
  post-mortem, renderable as Chrome-trace counter lanes through the
  distributed stitcher (``counter_series``).
- **Leak sentinel**: a periodic audit thread
  (``FLAGS_memory_audit_interval_s``) calls each pool's refcount
  invariant (``BlockAllocator.leaked()`` et al.); a nonzero audit is
  promoted to a ``memory`` health dimension.
- **OOM forensics** (:func:`oom_forensics`): on an out-of-memory error
  escaping a dispatch (``torch.cuda.OutOfMemoryError``, or the
  ``RESOURCE_EXHAUSTED`` the fault injector raises) the handler dumps a
  flight record with the full ledger, top-N holders, the event-ring
  tail, and block-pool occupancy before the caller re-raises (or
  recovers).

Surfaces: the ``/allocz`` payload (:func:`allocz`, ``allocz_text``), a
fleet merge (:func:`export_state` / :func:`merge_states`) and the
compact lease-data rider (:func:`lease_rider`).

Everything is gated by ``FLAGS_memory_attribution``: off (default) no
pool exists, no ``memory.*`` series is registered, no thread starts,
and every rider returns its absent form.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core import flags as _flags
from . import stats as _stats

__all__ = [
    "MemoryPool",
    "enabled",
    "pool",
    "get",
    "unregister",
    "pools",
    "note_event",
    "events",
    "device_bytes_in_use",
    "device_key",
    "host_registered_bytes",
    "ledger",
    "top_holders",
    "allocz",
    "allocz_text",
    "counter_series",
    "export_state",
    "merge_states",
    "lease_rider",
    "health_dimension",
    "run_audit",
    "last_audit",
    "maybe_start_sentinel",
    "is_oom",
    "oom_forensics",
    "last_oom",
    "reset",
]

# event kinds the ring accepts (free-form extras ride along, but the
# kind vocabulary is closed so the stitcher can sign them)
EVENT_KINDS = ("alloc", "free", "park", "reclaim", "preempt", "evict")

# per-pool resident/parked byte deltas each event kind implies (the
# counter-lane reconstruction): alloc grows resident, free/preempt
# shrink it, park moves resident->parked, reclaim/evict shrink parked
_RESIDENT_SIGN = {"alloc": 1, "free": -1, "preempt": -1, "park": -1}
_PARKED_SIGN = {"park": 1, "reclaim": -1, "evict": -1}

# how many ring-tail events / top holders an OOM flight record carries
OOM_EVENT_TAIL = 64
OOM_TOP_HOLDERS = 5


def enabled() -> bool:
    """Is memory attribution armed (``FLAGS_memory_attribution``)?"""
    try:
        return bool(_flags.get_flags("memory_attribution"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


class MemoryPool:
    """One byte-holding subsystem's ledger entry.

    ``callback()`` returns the pool's live byte accounting — a dict
    with any of ``reserved`` (bytes the pool holds from its backing
    store), ``used`` (bytes referenced by live work), ``parked``
    (reclaimable bytes held for reuse, e.g. LRU-parked KV blocks) plus
    free-form metadata (block counts, entry counts...).  It runs under
    the ledger's snapshot pass, so it must be cheap and lock-light.

    ``audit()`` (optional) returns the pool's refcount-invariant
    violation count — nonzero means leaked bytes/blocks; the sentinel
    promotes it to the ``memory`` health dimension.

    ``device`` is a torch device (or a CUDA index); the ledger keys it
    ``d<i>`` for ``cuda:i`` and ``cpu`` for the host.  ``tensors()``
    (optional) returns the tensors the pool holds: on the host they
    define ``bytes_in_use`` (module doc).
    """

    __slots__ = ("name", "kind", "device", "callback", "audit_fn",
                 "tensors_fn")

    def __init__(self, name: str, kind: str,
                 callback: Callable[[], dict],
                 audit: Optional[Callable[[], int]] = None,
                 device=0,
                 tensors: Optional[Callable[[], Sequence[torch.Tensor]]]
                 = None):
        if kind not in ("device", "host", "disk"):
            raise ValueError(f"unknown pool kind {kind!r}")
        self.name = name
        self.kind = kind
        self.device = device_key(device)
        self.callback = callback
        self.audit_fn = audit
        self.tensors_fn = tensors

    def tensors(self) -> List[torch.Tensor]:
        if self.tensors_fn is None:
            return []
        try:
            return [t for t in self.tensors_fn() if t is not None]
        except Exception:  # a dying pool must not kill the ledger
            return []

    def snapshot(self) -> dict:
        try:
            raw = self.callback() or {}
        except Exception as e:  # a dying pool must not kill the ledger
            raw = {"error": repr(e)[:120]}
        out = {"kind": self.kind, "device": self.device,
               "reserved": int(raw.get("reserved", 0) or 0),
               "used": int(raw.get("used", 0) or 0),
               "parked": int(raw.get("parked", 0) or 0)}
        for k, v in raw.items():
            if k not in out:
                out[k] = v
        return out

    def audit(self) -> int:
        if self.audit_fn is None:
            return 0
        try:
            return int(self.audit_fn() or 0)
        except Exception:  # pragma: no cover - audit must never raise
            return 0


# -- module registry -------------------------------------------------------
_lock = threading.Lock()
_pools: Dict[str, MemoryPool] = {}
_ring: Optional[deque] = None
_ring_total = 0
_last_audit: Optional[dict] = None
_last_oom: Optional[dict] = None
_oom_count = 0
_sentinel: Optional[threading.Thread] = None
_sentinel_stop = threading.Event()
_gauges: Dict[str, object] = {}


def device_key(device) -> str:
    """The ledger's key for a device: ``d<i>`` for ``cuda:i`` (an int
    is a CUDA index), ``cpu`` for the host."""
    if isinstance(device, int):
        return f"d{device}"
    d = torch.device(device)
    if d.type == "cuda":
        return f"d{0 if d.index is None else d.index}"
    return d.type


def pool(name: str, kind: str = "device",
         callback: Optional[Callable[[], dict]] = None,
         audit: Optional[Callable[[], int]] = None,
         device=0,
         tensors: Optional[Callable[[], Sequence[torch.Tensor]]] = None
         ) -> MemoryPool:
    """Get-or-create the named pool.  Callers gate on :func:`enabled`
    — a flag-off process never creates a pool (or any series)."""
    with _lock:
        p = _pools.get(name)
        if p is None:
            p = _pools[name] = MemoryPool(
                name, kind, callback or (lambda: {}), audit=audit,
                device=device, tensors=tensors)
        return p


def get(name: str) -> Optional[MemoryPool]:
    with _lock:
        return _pools.get(name)


def unregister(name: str) -> None:
    with _lock:
        _pools.pop(name, None)


def pools() -> Dict[str, MemoryPool]:
    with _lock:
        return dict(_pools)


def reset() -> None:
    """Drop pools, ring, audit/OOM state and stop the sentinel (tests /
    bench config isolation)."""
    global _ring, _ring_total, _last_audit, _last_oom, _oom_count, _sentinel
    _sentinel_stop.set()
    s = _sentinel
    if s is not None and s.is_alive():
        s.join(timeout=2.0)
    with _lock:
        _pools.clear()
        _ring = None
        _ring_total = 0
        _last_audit = None
        _last_oom = None
        _oom_count = 0
        _sentinel = None
        _gauges.clear()


# -- allocation event ring -------------------------------------------------
def _ring_cap() -> int:
    try:
        return max(int(_flags.get_flags("memory_event_ring")), 16)
    except KeyError:  # pragma: no cover
        return 1024


def note_event(kind: str, pool_name: str, nbytes: int, **extra) -> None:
    """File one allocation event (hot path: one flag read when off,
    one bounded append when armed)."""
    global _ring, _ring_total
    if not enabled():
        return
    ev = {"ts": time.time(), "kind": kind, "pool": pool_name,
          "bytes": int(nbytes)}
    if extra:
        ev.update(extra)
    with _lock:
        if _ring is None:
            _ring = deque(maxlen=_ring_cap())
        _ring.append(ev)
        _ring_total += 1


def events(limit: Optional[int] = None) -> List[dict]:
    """The ring tail (newest last), bounded by ``limit``."""
    with _lock:
        evs = list(_ring) if _ring is not None else []
    if limit is not None and len(evs) > limit:
        evs = evs[-limit:]
    return [dict(e) for e in evs]


def counter_series() -> List[dict]:
    """The event ring rebuilt as per-pool resident/parked byte
    counters — what the trace snapshot carries under ``counters`` and
    the distributed stitcher renders as Chrome ``ph:"C"`` lanes.
    Counters start at 0 at the ring's horizon (the ring is bounded, so
    these are deltas over the visible window, not absolute bytes)."""
    out: List[dict] = []
    run: Dict[str, List[int]] = {}
    for ev in events():
        cur = run.setdefault(ev["pool"], [0, 0])
        nb = int(ev.get("bytes", 0))
        cur[0] += _RESIDENT_SIGN.get(ev["kind"], 0) * nb
        cur[1] += _PARKED_SIGN.get(ev["kind"], 0) * nb
        out.append({"ts_us": ev["ts"] * 1e6, "pool": ev["pool"],
                    "resident": cur[0], "parked": cur[1]})
    return out


# -- reconciliation --------------------------------------------------------
def host_registered_bytes() -> int:
    """The host's ``bytes_in_use`` (module doc): the bytes of the
    distinct storages of every host tensor the pools registered."""
    seen = {}
    for p in pools().values():
        for t in p.tensors():
            if t.device.type != "cpu":
                continue
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def device_bytes_in_use() -> Dict[str, int]:
    """Live per-device footprint, keyed ``d<i>`` for each CUDA card
    (the caching allocator's ``allocated_bytes.all.current``) and
    ``cpu`` for the host when a pool registered host tensors (module
    doc) — the reconciliation identity is exact either way."""
    out: Dict[str, int] = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"d{i}"] = int(stats.get("allocated_bytes.all.current", 0))
    if any(t.device.type == "cpu" for p in pools().values()
           for t in p.tensors()):
        out["cpu"] = host_registered_bytes()
    return out


def _gauge(name: str):
    g = _gauges.get(name)
    if g is None:
        g = _gauges[name] = _stats.scope("memory").gauge(name)
    return g


def ledger(set_gauges: bool = True) -> dict:
    """The full attribution snapshot: every pool's bytes, per-kind
    totals, and the per-device reconciliation with its
    ``unattributed_bytes`` residual."""
    snaps = {name: p.snapshot() for name, p in pools().items()}
    totals = {"device": 0, "host": 0, "disk": 0}
    attributed: Dict[str, int] = {}
    for s in snaps.values():
        footprint = s["reserved"] or (s["used"] + s["parked"])
        totals[s["kind"]] += footprint
        if s["kind"] == "device":
            key = s["device"]
            attributed[key] = attributed.get(key, 0) + footprint
    devices = {}
    for dev, in_use in device_bytes_in_use().items():
        attr = attributed.get(dev, 0)
        devices[dev] = {"bytes_in_use": in_use, "attributed": attr,
                        "unattributed_bytes": in_use - attr}
    # attributed device pools on a device that reports nothing (a stub
    # pool): keep the identity honest against a zero in-use
    for dev, attr in attributed.items():
        if dev not in devices:  # pragma: no cover - stub pools only
            devices[dev] = {"bytes_in_use": 0, "attributed": attr,
                            "unattributed_bytes": -attr}
    with _lock:
        audit = dict(_last_audit) if _last_audit else None
    out = {"pools": snaps, "totals": totals, "devices": devices}
    if audit:
        out["audit"] = audit
    if set_gauges and enabled():
        with _lock:
            for name, s in snaps.items():
                _gauge(f"pool.{name}.used").set(s["used"])
                _gauge(f"pool.{name}.reserved").set(s["reserved"])
            for dev, d in devices.items():
                _gauge(f"{dev}.unattributed_bytes").set(
                    d["unattributed_bytes"])
    return out


def top_holders(led: Optional[dict] = None,
                n: int = OOM_TOP_HOLDERS) -> List[dict]:
    """Pools ranked by live footprint (used+parked, falling back to
    reserved) — the "who owns the bytes" list an OOM dump leads with."""
    led = led if led is not None else ledger(set_gauges=False)
    ranked = []
    for name, s in led.get("pools", {}).items():
        footprint = (s["used"] + s["parked"]) or s["reserved"]
        ranked.append({"pool": name, "bytes": footprint,
                       "kind": s["kind"]})
    ranked.sort(key=lambda e: (-e["bytes"], e["pool"]))
    return ranked[:n]


# -- pages -----------------------------------------------------------------
def allocz(events_limit: int = 128) -> dict:
    """The ``/allocz`` payload: ledger + event-ring tail."""
    if not enabled():
        return {"memory": "disabled (set FLAGS_memory_attribution)"}
    with _lock:
        total = _ring_total
        ooms = _oom_count
    out = {"ledger": ledger(), "events": events(events_limit),
           "events_total": total}
    if ooms:
        out["oom_dumps"] = ooms
    return out


def _fmt_bytes(n) -> str:
    n = float(n)
    sign = "-" if n < 0 else ""
    n = abs(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{sign}{n:.1f}{unit}" if unit != "B" \
                else f"{sign}{int(n)}B"
        n /= 1024.0
    return f"{sign}{n:.1f}GiB"  # pragma: no cover


def allocz_text(payload: Optional[dict] = None) -> str:
    """Human rendering of :func:`allocz` (``/allocz?text=1``)."""
    payload = payload if payload is not None else allocz()
    led = payload.get("ledger")
    if not isinstance(led, dict):
        return "memory: attribution off (set FLAGS_memory_attribution)\n"
    lines = ["== memory ledger =="]
    for name in sorted(led.get("pools", {})):
        s = led["pools"][name]
        lines.append(
            "  {:<28} {:<6} reserved={:<10} used={:<10} parked={}".format(
                name, s["kind"], _fmt_bytes(s["reserved"]),
                _fmt_bytes(s["used"]), _fmt_bytes(s["parked"])))
    for dev in sorted(led.get("devices", {})):
        d = led["devices"][dev]
        lines.append(
            "  {:<28} in_use={:<10} attributed={:<10} "
            "unattributed={}".format(
                dev, _fmt_bytes(d["bytes_in_use"]),
                _fmt_bytes(d["attributed"]),
                _fmt_bytes(d["unattributed_bytes"])))
    audit = led.get("audit")
    if audit:
        leaks = audit.get("leaks") or {}
        verdict = ("LEAK " + ", ".join(
            f"{p}={n}" for p, n in sorted(leaks.items()))
            if leaks else "ok")
        lines.append(f"  audit: {verdict}")
    evs = payload.get("events") or []
    if evs:
        lines.append(f"== events (tail {len(evs)} of "
                     f"{payload.get('events_total', len(evs))}) ==")
        for ev in evs:
            extra = " ".join(f"{k}={v}" for k, v in sorted(ev.items())
                             if k not in ("ts", "kind", "pool", "bytes"))
            lines.append("  {:<8} {:<28} {:>10}  {}".format(
                ev["kind"], ev["pool"], _fmt_bytes(ev["bytes"]), extra))
    return "\n".join(lines) + "\n"


# -- riders ----------------------------------------------------------------
def export_state() -> Optional[dict]:
    """The STATS_PULL rider: the ledger, or None when the flag is off /
    nothing registered (payload byte-identity)."""
    if not enabled():
        return None
    if not _pools:
        return None
    return ledger(set_gauges=False)


def merge_states(per_worker: Dict[str, dict]) -> dict:
    """Fleet rollup of per-worker :func:`export_state` payloads: bytes
    SUM per pool name across workers; the ``unattributed`` residual is
    kept per worker (residuals are local honesty metrics — summing
    them would let one worker's over-attribution hide another's
    leak)."""
    fleet_pools: Dict[str, dict] = {}
    unattributed: Dict[str, int] = {}
    total = 0
    for worker, led in per_worker.items():
        if not isinstance(led, dict):
            continue
        for name, s in (led.get("pools") or {}).items():
            if not isinstance(s, dict):
                continue
            agg = fleet_pools.setdefault(name, {
                "workers": 0, "reserved": 0, "used": 0, "parked": 0})
            agg["workers"] += 1
            for k in ("reserved", "used", "parked"):
                agg[k] += int(s.get(k, 0) or 0)
            total += int(s.get("reserved", 0) or 0) or (
                int(s.get("used", 0) or 0) + int(s.get("parked", 0) or 0))
        devs = led.get("devices") or {}
        if devs:
            unattributed[worker] = sum(
                int(d.get("unattributed_bytes", 0) or 0)
                for d in devs.values() if isinstance(d, dict))
    return {"pools": fleet_pools, "total_bytes": total,
            "unattributed": unattributed}


def headroom_frac() -> Optional[float]:
    """Measured byte headroom of the tightest device pool: the
    fraction of its reserved bytes not referenced by live work (parked
    bytes are reclaimable, so they count as headroom).  None when no
    device pool reports reserved bytes."""
    worst = None
    for p in pools().values():
        if p.kind != "device":
            continue
        s = p.snapshot()
        if s["reserved"] <= 0:
            continue
        frac = max(0.0, 1.0 - s["used"] / s["reserved"])
        if worst is None or frac < worst:
            worst = frac
    return round(worst, 4) if worst is not None else None


def lease_rider() -> Optional[dict]:
    """The compact lease-data rider: byte headroom + live footprint
    (+ leak verdict), or None when the flag is off / nothing pooled —
    lease payloads stay byte-identical by default.  Pool snapshots
    only: no allocator read per heartbeat."""
    if not enabled():
        return None
    ps = pools()
    if not ps:
        return None
    used = parked = reserved = 0
    for p in ps.values():
        s = p.snapshot()
        if p.kind == "device":
            used += s["used"]
            parked += s["parked"]
            reserved += s["reserved"]
    out = {"memory_bytes": used, "memory_parked_bytes": parked}
    hf = headroom_frac()
    if hf is not None:
        out["memory_headroom_frac"] = hf
    with _lock:
        audit = _last_audit
    leaks = (audit or {}).get("leaks") or {}
    if leaks:
        out["memory_leak"] = sum(leaks.values())
    return out


def health_dimension() -> dict:
    """The heartbeat rider: ``{}`` when unarmed (payload byte-identity)
    else the leak-audit verdict — ``memory: ok`` / ``memory: leak``
    with the offending pool names, exactly the canary dimension's
    shape so the supervisor folds it with the same damping."""
    if not enabled():
        return {}
    with _lock:
        audit = _last_audit
        have = bool(_pools)
    if not have and audit is None:
        return {}
    leaks = (audit or {}).get("leaks") or {}
    if leaks:
        return {"memory": "leak", "memory_pools": sorted(leaks)}
    return {"memory": "ok"}


# -- leak sentinel ---------------------------------------------------------
def run_audit() -> dict:
    """One refcount-invariant sweep over every pool with an audit
    callback; returns {pool: violation count} for the NONZERO ones and
    records the result for :func:`health_dimension`."""
    global _last_audit
    leaks = {}
    for name, p in pools().items():
        n = p.audit()
        if n:
            leaks[name] = n
    rec = {"ts": time.time(), "leaks": leaks}
    with _lock:
        _last_audit = rec
        if enabled():
            _gauge("leaked").set(sum(leaks.values()))
    return leaks


def last_audit() -> Optional[dict]:
    with _lock:
        return dict(_last_audit) if _last_audit else None


def _sentinel_loop(interval_s: float) -> None:
    while not _sentinel_stop.wait(interval_s):
        if not enabled():
            return
        run_audit()


def maybe_start_sentinel() -> bool:
    """Start the periodic leak-audit thread once (idempotent).  A
    no-op — zero threads — unless ``FLAGS_memory_attribution`` is on
    and ``FLAGS_memory_audit_interval_s`` > 0."""
    global _sentinel
    if not enabled():
        return False
    try:
        interval = float(_flags.get_flags("memory_audit_interval_s"))
    except KeyError:  # pragma: no cover
        interval = 0.0
    if interval <= 0:
        return False
    with _lock:
        if _sentinel is not None and _sentinel.is_alive():
            return True
        _sentinel_stop.clear()
        _sentinel = threading.Thread(
            target=_sentinel_loop, args=(interval,), daemon=True,
            name="memory-leak-sentinel")
        _sentinel.start()
    return True


# -- OOM forensics ---------------------------------------------------------
def is_oom(exc: BaseException) -> bool:
    """Does this exception carry an out-of-memory verdict?  The card's
    ``torch.cuda.OutOfMemoryError``, or an error that stringifies with
    ``RESOURCE_EXHAUSTED`` (the chaos ``oom`` rule's
    ``InjectedResourceExhausted``)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return "RESOURCE_EXHAUSTED" in f"{type(exc).__name__}: {exc}"


def oom_forensics(exc: BaseException, site: str) -> Optional[dict]:
    """Name the post-mortem: on an out-of-memory error escaping a
    dispatch, capture the full ledger, top-N holders, the event-ring
    tail and pool occupancy into the flight recorder (and a retained
    ``last_oom`` record) BEFORE the caller re-raises or recovers.
    Returns the record, or None when unarmed / not an OOM."""
    global _last_oom, _oom_count
    if not enabled() or not is_oom(exc):
        return None
    led = ledger(set_gauges=False)
    rec = {"ts": time.time(), "site": site, "error": repr(exc)[:300],
           "top_holders": top_holders(led),
           "events": events(OOM_EVENT_TAIL), "ledger": led}
    with _lock:
        _last_oom = rec
        _oom_count += 1
        count = _oom_count
    _stats.scope("memory").counter(
        "oom_dumps", "out-of-memory events that produced a "
        "forensic ledger dump").inc()
    from . import flight as _flight
    top = rec["top_holders"][0]["pool"] if rec["top_holders"] else "?"
    _flight.note("oom_forensics", site=site, top_holder=top,
                 error=repr(exc)[:200], dumps=count)
    _flight.dump(f"oom_{site}")
    return rec


def last_oom() -> Optional[dict]:
    """The most recent OOM forensic record (tests / debug pages)."""
    with _lock:
        return dict(_last_oom) if _last_oom else None
