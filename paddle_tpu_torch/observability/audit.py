"""Cross-replica divergence sentinel: is the fleet still *agreeing*?

The port's copy of ``paddle_tpu/observability/audit.py``.

The numerics sentinel catches NaN/Inf; nothing before this plane caught
a replica that silently returns plausible-but-wrong numbers after a bad
hydrate, a stale hot-swap, or hardware silent data corruption.  When
``FLAGS_divergence_check`` is armed:

- **Serving replies**: each reply batch folds a content digest (FNV-1a
  64-bit over fetch names + raw array bytes) keyed by
  ``(model, version, request-hash)`` into a bounded per-model audit
  ring.  The ring rides the replica's registry lease data
  (:func:`recent_digests`), so the supervisor can group digests across
  replicas with zero new RPCs.
- **Decode streams**: the engine folds every emitted token id into a
  per-stream rolling hash; the finished stream's digest enters the same
  ring keyed by its prompt hash.
- **Training**: :meth:`ParallelExecutor` folds a periodic u64 parameter
  checksum (every ``FLAGS_divergence_param_steps`` steps) under the
  reserved model name ``__params__`` keyed by ``step:<n>`` — cross-DP
  state divergence is caught within K steps through the same grouping.

:func:`name_divergent` is the sentinel proper: it groups digests by
``(model, version, request-hash)`` across replicas and NAMES any
replica whose digest disagrees with a strict majority (>= 2 agreeing
peers) — a single divergent replica is *named*, not just suspected.
Two replicas that disagree with no tiebreaker are reported as a
``suspect`` pair instead.  Findings surface as ``divergence.*``
counters, flight-recorder notes, the ``/canaryz`` audit section, and a
STATS_PULL rider merged fleet-wide.

Determinism caveat: digests only group when replicas compute the SAME
request — grouping keys on the request-hash, so replicas that never
see common traffic (no canary, disjoint batches) simply produce no
groups.  The golden canary prober (canary.py) exists precisely to
guarantee common, repeated traffic across all replicas.

Off (default): no digests are computed, no metric series register, the
lease rider and STATS_PULL rider (:func:`export_state`) return ``None``
— byte-identical payloads.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..core import flags as _flags
from . import flight as _flight
from . import stats as _stats

__all__ = [
    "PARAMS_MODEL",
    "enabled",
    "fnv1a64",
    "fold_bytes",
    "fold_token",
    "digest_pairs",
    "request_hash",
    "AuditRing",
    "ring",
    "note_reply",
    "note_stream",
    "note_param_checksum",
    "recent_digests",
    "name_divergent",
    "auditz",
    "export_state",
    "merge_states",
    "reset",
]

PARAMS_MODEL = "__params__"   # reserved pipeline name for param checksums
_RING = 64                    # recalled (request_hash -> digest) per model
_RIDER = 16                   # newest entries published on the lease
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def enabled() -> bool:
    """Is the divergence sentinel armed (``FLAGS_divergence_check``)?"""
    try:
        return bool(_flags.get_flags("divergence_check"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


def param_steps() -> int:
    try:
        return max(1, int(_flags.get_flags("divergence_param_steps")))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return 50


# -- digests --------------------------------------------------------------
def fnv1a64(data: bytes, h: int = _FNV_OFFSET) -> int:
    """FNV-1a 64-bit over ``data`` (content fingerprint, not crypto)."""
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def fold_bytes(h: int, data: bytes) -> int:
    return fnv1a64(data, h)


def fold_token(h: int, token: int) -> int:
    """Fold one decode token id into a per-stream rolling hash."""
    return fnv1a64(int(token).to_bytes(8, "little", signed=True), h)


def _fold_array(h: int, v) -> int:
    a = np.ascontiguousarray(np.asarray(v))
    h = fold_bytes(h, str(a.dtype).encode())
    h = fold_bytes(h, repr(a.shape).encode())
    return fold_bytes(h, a.tobytes())


def digest_pairs(pairs) -> str:
    """Content digest of a serving reply batch ``[(name, array), ...]``."""
    h = _FNV_OFFSET
    for name, v in pairs:
        h = fold_bytes(h, str(name).encode())
        h = _fold_array(h, v)
    return f"{h:016x}"


def request_hash(feeds) -> str:
    """Grouping key: digest of the request content itself, so replicas
    that answered the SAME question are comparable fleet-wide."""
    h = _FNV_OFFSET
    if isinstance(feeds, dict):
        for name in sorted(feeds):
            h = fold_bytes(h, str(name).encode())
            h = _fold_array(h, feeds[name])
    elif isinstance(feeds, (bytes, bytearray)):
        h = fold_bytes(h, bytes(feeds))
    else:
        h = fold_bytes(h, repr(feeds).encode())
    return f"{h:016x}"


# -- the per-process audit ring -------------------------------------------
class AuditRing:
    """Bounded per-model ring of ``request_hash -> digest`` entries."""

    def __init__(self, cap: int = _RING):
        self.cap = int(cap)
        self._lock = threading.Lock()
        # model -> OrderedDict[(version, request_hash)] = digest
        self._rings: Dict[str, OrderedDict] = {}
        self._noted = 0
        self._c_noted = _stats.counter(
            "divergence.digests", "reply/stream/param digests folded "
            "into the audit ring (FLAGS_divergence_check)")

    def note(self, model: str, version: str, req_hash: str,
             digest: str) -> None:
        with self._lock:
            ring = self._rings.setdefault(str(model), OrderedDict())
            key = (str(version), str(req_hash))
            ring.pop(key, None)           # re-answer refreshes recency
            ring[key] = str(digest)
            while len(ring) > self.cap:
                ring.popitem(last=False)
            self._noted += 1
        self._c_noted.inc()

    def recent(self, limit: int = _RIDER) -> dict:
        """Compact lease/STATS_PULL rider: newest entries per model as
        ``{model: [[version, request_hash, digest], ...]}``."""
        with self._lock:
            out = {}
            for model, ring in self._rings.items():
                items = list(ring.items())[-int(limit):]
                out[model] = [[v, rh, d] for (v, rh), d in items]
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"noted": self._noted,
                    "models": {m: len(r) for m, r in self._rings.items()}}


# -- module singleton -----------------------------------------------------
_lock = threading.Lock()
_ring: Optional[AuditRing] = None


def ring(create: bool = True) -> Optional[AuditRing]:
    """The process-wide audit ring (lazily created when armed)."""
    global _ring
    with _lock:
        if _ring is None and create and enabled():
            _ring = AuditRing()
        return _ring


def note_reply(model: str, version: str, req_hash: str,
               digest: str) -> None:
    """Fold one serving reply digest — a no-op unless armed."""
    if not enabled():
        return
    r = ring()
    if r is not None:
        r.note(model, version, req_hash, digest)


def note_stream(model: str, version: str, prompt_hash: str,
                rolling: int) -> None:
    """Fold one finished decode stream's rolling token hash."""
    note_reply(model, version, prompt_hash, f"{rolling & _MASK64:016x}")


def note_param_checksum(step: int, checksum: int,
                        version: str = "") -> None:
    """Fold one DP replica's u64 parameter checksum at ``step``."""
    note_reply(PARAMS_MODEL, version, f"step:{int(step)}",
               f"{int(checksum) & _MASK64:016x}")


def recent_digests(limit: int = _RIDER) -> Optional[dict]:
    """The lease-data rider — ``None`` when off (byte-identity)."""
    if not enabled():
        return None
    r = ring(create=False)
    if r is None:
        return None
    return r.recent(limit)


def reset() -> None:
    """Drop the ring (tests / bench config isolation)."""
    global _ring
    with _lock:
        _ring = None


# -- the sentinel: cross-replica grouping ---------------------------------
def name_divergent(per_replica: Dict[str, Optional[dict]]) -> dict:
    """Group digests by (model, version, request-hash) across replicas
    and name any replica out-voted by a strict majority.

    ``per_replica`` maps a replica key (announce key or worker name) to
    that replica's :func:`recent_digests` payload.  Returns
    ``{"groups": n, "divergent": [finding...], "suspect": [pair...]}``
    where a finding names the guilty replica, the group key, its digest
    and the majority digest.  Pure function — safe on merged fleet
    snapshots as well as live supervisor lease data.
    """
    groups: Dict[tuple, Dict[str, str]] = {}
    for rep, payload in per_replica.items():
        if not isinstance(payload, dict):
            continue
        for model, entries in payload.items():
            for ent in entries or ():
                try:
                    version, rh, digest = ent[0], ent[1], ent[2]
                except (TypeError, IndexError):
                    continue
                groups.setdefault((str(model), str(version), str(rh)),
                                  {})[str(rep)] = str(digest)
    divergent: List[dict] = []
    suspect: List[dict] = []
    checked = 0
    for (model, version, rh), by_rep in groups.items():
        if len(by_rep) < 2:
            continue
        checked += 1
        votes: Dict[str, int] = {}
        for d in by_rep.values():
            votes[d] = votes.get(d, 0) + 1
        if len(votes) == 1:
            continue
        major = max(votes, key=lambda d: votes[d])
        if votes[major] >= 2:
            for rep, d in sorted(by_rep.items()):
                if d != major:
                    divergent.append({
                        "replica": rep, "model": model,
                        "version": version, "request_hash": rh,
                        "digest": d, "majority": major,
                        "agreeing": votes[major]})
        else:
            # two replicas, two answers: someone is wrong, no quorum
            # to say who — report the pair, never guess
            suspect.append({"model": model, "version": version,
                            "request_hash": rh,
                            "replicas": dict(sorted(by_rep.items()))})
    return {"groups": checked, "divergent": divergent, "suspect": suspect}


# -- pages / riders -------------------------------------------------------
def auditz() -> dict:
    """The audit section of ``/canaryz``."""
    if not enabled():
        return {"audit": "disabled (set FLAGS_divergence_check)"}
    r = ring(create=False)
    if r is None:
        return {"audit": {"noted": 0, "models": {}}}
    return {"audit": r.snapshot(), "recent": r.recent()}


def export_state() -> Optional[dict]:
    """The STATS_PULL rider — None when off / no ring (byte-identity)."""
    if not enabled():
        return None
    r = ring(create=False)
    if r is None:
        return None
    return {"recent": r.recent(), **r.snapshot()}


def merge_states(per_worker: Dict[str, dict]) -> dict:
    """Fleet rollup: run the sentinel over every worker's recent ring —
    a divergent replica is named from one aggregator endpoint."""
    rings = {w: (snap or {}).get("recent")
             for w, snap in per_worker.items()
             if isinstance(snap, dict)}
    verdict = name_divergent(rings)
    verdict["noted"] = sum(int((s or {}).get("noted") or 0)
                           for s in per_worker.values()
                           if isinstance(s, dict))
    for f in verdict["divergent"]:
        _flight.note("divergence_named", **f)
    return verdict
