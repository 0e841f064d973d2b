"""Golden canary prober: does the replica still give *recorded* answers?

The port's copy of ``paddle_tpu/observability/canary.py``.

A latency SLO cannot see a replica that answers fast and wrong.  When
``FLAGS_canary_probe`` is armed, a background prober periodically
replays a small **golden set** — input -> expected-output pairs
recorded with ``tools/golden.py record`` against a trusted build —
through the *real* submit path of every registered replica target
(serving batcher, decode engine), compares replies against the goldens
with per-model rtol, and maintains per-target pass/fail streaks:

- probes are tenant-tagged :data:`tenant.CANARY` (``__canary__``) so
  per-tenant metering excludes them from user accounting;
- a sustained fail streak (``FLAGS_canary_fail_streak``) flips the
  ``canary`` health dimension on every registry heartbeat to ``fail``
  — the supervisor's ``quarantine_on_canary_fail`` policy then DRAINs
  (never kills) the replica after its own hysteresis;
- every failure leaves a flight-recorder note and a ``canary.*``
  counter; ``/canaryz`` (+``?text=1``) renders streaks; a STATS_PULL
  rider merges fleet-wide; probe busy time is tracked so benches can
  report ``canary_overhead_frac``.

Trust caveats, in order of importance: a canary pass is a REGRESSION
check against whatever build recorded the goldens — it is not a proof
of correctness, and a golden set recorded on a broken build blesses
the breakage.  Comparison is rtol-based, so it tolerates (and is
blind to) numeric drift inside the tolerance; record goldens with the
tightest rtol the hardware pair actually sustains.  Coverage is the
golden set: a bug outside the recorded inputs' activation paths passes
every probe.  The cross-replica divergence sentinel (audit.py) is the
complementary check that needs no trusted recording at all.

Off (default): no thread, no targets probed, no metric series, the
health dimension is empty and the STATS_PULL/lease riders return
``None`` — byte-identical payloads.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import flags as _flags
from . import flight as _flight
from . import stats as _stats
from .tenant import CANARY as CANARY_TENANT

__all__ = [
    "CANARY_TENANT",
    "GoldenSet",
    "CanaryProber",
    "enabled",
    "encode_array",
    "decode_array",
    "compare_pairs",
    "load_goldens",
    "register_target",
    "unregister_target",
    "prober",
    "probe_once",
    "health_dimension",
    "lease_rider",
    "overhead_frac",
    "canaryz",
    "canaryz_text",
    "export_state",
    "merge_states",
    "maybe_start_from_flags",
    "stop",
    "reset",
]

GOLDEN_FORMAT_VERSION = 1
_MAX_FAIL_DETAIL = 200


def enabled() -> bool:
    """Is the canary prober armed (``FLAGS_canary_probe``)?"""
    try:
        return bool(_flags.get_flags("canary_probe"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


def _interval_s() -> float:
    try:
        return max(0.05, float(_flags.get_flags("canary_interval_s")))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return 5.0


def _default_rtol() -> float:
    try:
        return float(_flags.get_flags("canary_rtol"))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return 1e-5


def fail_streak_threshold() -> int:
    try:
        return max(1, int(_flags.get_flags("canary_fail_streak")))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return 3


# -- golden-set codec -----------------------------------------------------
def encode_array(a) -> dict:
    """JSON-safe encoding of one array (dtype/shape/flat data)."""
    a = np.asarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": np.ascontiguousarray(a).ravel().tolist()}


def decode_array(d: dict) -> np.ndarray:
    return np.asarray(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        d["shape"])


class GoldenSet:
    """A recorded golden set: per-model cases + per-model rtol.

    On-disk format (``tools/golden.py record``)::

        {"format_version": 1,
         "provenance": {...},            # free-form trust breadcrumbs
         "models": {"<model>": {
             "rtol": 1e-5,               # optional, beats FLAGS_canary_rtol
             "cases": [{"feeds": {name: enc_array},
                        "expect": [[name, enc_array], ...]}, ...]}}}
    """

    def __init__(self, payload: Optional[dict] = None):
        payload = payload or {}
        self.provenance = dict(payload.get("provenance") or {})
        self.models: Dict[str, dict] = {}
        for model, spec in (payload.get("models") or {}).items():
            cases = []
            for case in spec.get("cases") or ():
                feeds = {n: decode_array(e)
                         for n, e in (case.get("feeds") or {}).items()}
                expect = [(n, decode_array(e))
                          for n, e in (case.get("expect") or ())]
                cases.append({"feeds": feeds, "expect": expect})
            self.models[str(model)] = {
                "rtol": spec.get("rtol"), "cases": cases}

    def rtol(self, model: str) -> float:
        r = self.models.get(model, {}).get("rtol")
        return float(r) if r is not None else _default_rtol()

    def cases(self, model: str) -> List[dict]:
        return self.models.get(model, {}).get("cases", [])

    def n_cases(self) -> int:
        return sum(len(m["cases"]) for m in self.models.values())

    def to_payload(self) -> dict:
        return {"format_version": GOLDEN_FORMAT_VERSION,
                "provenance": self.provenance,
                "models": {
                    model: {
                        **({"rtol": spec["rtol"]}
                           if spec.get("rtol") is not None else {}),
                        "cases": [{
                            "feeds": {n: encode_array(a) for n, a
                                      in c["feeds"].items()},
                            "expect": [[n, encode_array(a)] for n, a
                                       in c["expect"]],
                        } for c in spec["cases"]]}
                    for model, spec in self.models.items()}}


def load_goldens(path: str) -> GoldenSet:
    with open(path, "r", encoding="utf-8") as f:
        payload = json.load(f)
    ver = payload.get("format_version")
    if ver != GOLDEN_FORMAT_VERSION:
        raise ValueError(f"golden set {path}: format_version {ver!r} "
                         f"(prober speaks {GOLDEN_FORMAT_VERSION})")
    return GoldenSet(payload)


def compare_pairs(expect, got, rtol: float) -> Optional[str]:
    """Compare a reply against a golden.  ``None`` = pass, else a short
    human mismatch description (first offense wins)."""
    got_by_name = {str(n): v for n, v in (got or ())}
    for name, exp in expect:
        g = got_by_name.get(str(name))
        if g is None:
            return f"missing output '{name}'"
        ga, ea = np.asarray(g), np.asarray(exp)
        if ga.shape != ea.shape:
            return (f"'{name}' shape {list(ga.shape)} != golden "
                    f"{list(ea.shape)}")
        if not np.allclose(ga.astype(np.float64, copy=False),
                           ea.astype(np.float64, copy=False),
                           rtol=rtol, atol=rtol, equal_nan=True):
            diff = np.abs(ga.astype(np.float64) - ea.astype(np.float64))
            return (f"'{name}' max_abs_diff={float(np.max(diff)):.6g} "
                    f"(rtol={rtol:g})")
    return None


# -- the prober -----------------------------------------------------------
class _Target:
    __slots__ = ("name", "model", "submit_fn")

    def __init__(self, name: str, model: str,
                 submit_fn: Callable[[dict, str], list]):
        self.name = name          # replica-qualified, e.g. serving/m/r0
        self.model = model        # golden-set model this target answers
        self.submit_fn = submit_fn


class CanaryProber:
    """Replays goldens through registered targets, keeps streaks."""

    def __init__(self, goldens: Optional[GoldenSet] = None):
        self.goldens = goldens or GoldenSet()
        self._lock = threading.Lock()
        self._targets: Dict[str, _Target] = {}
        self._streaks: Dict[str, dict] = {}
        self._busy_s = 0.0
        self._armed_t0 = time.monotonic()
        self._cycles = 0
        sc = _stats.scope("canary")
        self._c_probes = sc.counter(
            "probes", "golden canary cases replayed (FLAGS_canary_probe)")
        self._c_failures = sc.counter(
            "failures", "golden canary case mismatches")
        self._g_failing = sc.gauge(
            "failing_targets", "targets at/over FLAGS_canary_fail_streak")

    # targets ------------------------------------------------------------
    def register(self, name: str, model: str,
                 submit_fn: Callable[[dict, str], list]) -> None:
        with self._lock:
            self._targets[str(name)] = _Target(str(name), str(model),
                                               submit_fn)
            self._streaks.setdefault(str(name), {
                "pass_streak": 0, "fail_streak": 0, "probes": 0,
                "failures": 0, "last_fail": None})

    def unregister(self, name: str) -> None:
        with self._lock:
            self._targets.pop(str(name), None)

    # probing ------------------------------------------------------------
    def run_cycle(self) -> dict:
        """One synchronous probe cycle over every (target x case).
        Returns ``{target: ok_bool}`` for this cycle."""
        with self._lock:
            targets = list(self._targets.values())
        results: Dict[str, bool] = {}
        t0 = time.monotonic()
        for tgt in targets:
            cases = self.goldens.cases(tgt.model)
            if not cases:
                continue
            rtol = self.goldens.rtol(tgt.model)
            fail: Optional[str] = None
            for i, case in enumerate(cases):
                self._c_probes.inc()
                try:
                    got = tgt.submit_fn(case["feeds"], CANARY_TENANT)
                    mismatch = compare_pairs(case["expect"], got, rtol)
                except Exception as e:
                    mismatch = f"probe error: {repr(e)[:120]}"
                if mismatch is not None:
                    fail = f"case {i}: {mismatch}"[:_MAX_FAIL_DETAIL]
                    break
            results[tgt.name] = fail is None
            self._fold(tgt, fail)
        with self._lock:
            self._busy_s += time.monotonic() - t0
            self._cycles += 1
            self._g_failing.set(sum(
                1 for s in self._streaks.values()
                if s["fail_streak"] >= fail_streak_threshold()))
        return results

    def _fold(self, tgt: _Target, fail: Optional[str]) -> None:
        with self._lock:
            s = self._streaks.setdefault(tgt.name, {
                "pass_streak": 0, "fail_streak": 0, "probes": 0,
                "failures": 0, "last_fail": None})
            s["probes"] += 1
            if fail is None:
                s["pass_streak"] += 1
                s["fail_streak"] = 0
                return
            s["failures"] += 1
            s["fail_streak"] += 1
            s["pass_streak"] = 0
            s["last_fail"] = fail
            streak = s["fail_streak"]
        self._c_failures.inc()
        _stats.counter(f"canary.{tgt.model}.failures").inc()
        _flight.note("canary_fail", target=tgt.name, model=tgt.model,
                     detail=fail, streak=streak)

    # surfaces -----------------------------------------------------------
    def failing_targets(self) -> List[str]:
        thr = fail_streak_threshold()
        with self._lock:
            return sorted(t for t, s in self._streaks.items()
                          if s["fail_streak"] >= thr)

    def streaks(self) -> Dict[str, dict]:
        with self._lock:
            return {t: dict(s) for t, s in self._streaks.items()}

    def overhead_frac(self) -> float:
        with self._lock:
            wall = max(1e-9, time.monotonic() - self._armed_t0)
            return min(1.0, self._busy_s / wall)

    def snapshot(self) -> dict:
        with self._lock:
            busy = self._busy_s
            wall = max(1e-9, time.monotonic() - self._armed_t0)
            return {"targets": len(self._targets),
                    "golden_cases": self.goldens.n_cases(),
                    "cycles": self._cycles,
                    "fail_streak_threshold": fail_streak_threshold(),
                    "overhead_frac": round(min(1.0, busy / wall), 6),
                    "streaks": {t: dict(s)
                                for t, s in self._streaks.items()}}


# -- module singleton + lifecycle (slo.py discipline) ---------------------
_lock = threading.Lock()
_prober: Optional[CanaryProber] = None
_thread: Optional[threading.Thread] = None
_stop_evt = threading.Event()


def prober(create: bool = True) -> Optional[CanaryProber]:
    """The process-wide prober (lazily created when armed)."""
    global _prober
    with _lock:
        if _prober is None and create and enabled():
            golden_path = ""
            try:
                golden_path = str(_flags.get_flags("canary_golden_path")
                                  or "")
            except KeyError:  # pragma: no cover
                pass
            goldens = None
            if golden_path:
                try:
                    goldens = load_goldens(golden_path)
                except Exception as e:
                    # an unreadable golden set arms an empty prober —
                    # a bad path must never take the serving path down
                    _flight.note("canary_golden_load_error",
                                 path=golden_path, error=repr(e)[:200])
            _prober = CanaryProber(goldens)
        return _prober


def register_target(name: str, model: str,
                    submit_fn: Callable[[dict, str], list]) -> bool:
    """Register one replica submit path — a no-op unless armed."""
    if not enabled():
        return False
    p = prober()
    if p is None:
        return False
    p.register(name, model, submit_fn)
    return True


def unregister_target(name: str) -> None:
    p = prober(create=False)
    if p is not None:
        p.unregister(name)


def probe_once() -> dict:
    """One synchronous cycle (tests, bench) — ``{}`` unless armed."""
    p = prober(create=False) or (prober() if enabled() else None)
    return p.run_cycle() if p is not None else {}


def _run_loop() -> None:
    while not _stop_evt.wait(_interval_s()):
        p = prober(create=False)
        if p is None:
            continue
        try:
            p.run_cycle()
        except Exception:  # a broken probe never kills its thread
            pass


def maybe_start_from_flags() -> bool:
    """Idempotently start the prober thread when the flag is armed."""
    global _thread
    if not enabled():
        return False
    prober()                      # force creation + golden load
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        _stop_evt.clear()
        _thread = threading.Thread(target=_run_loop, daemon=True,
                                   name="canary-prober")
        _thread.start()
        return True


def stop() -> None:
    """Stop the prober thread (tests / shutdown)."""
    global _thread
    with _lock:
        t, _thread = _thread, None
    _stop_evt.set()
    if t is not None and t.is_alive():
        t.join(2.0)


def reset() -> None:
    """Drop prober + targets + streaks (tests / bench isolation)."""
    global _prober
    stop()
    with _lock:
        _prober = None
    _stop_evt.clear()


# -- health / riders / pages ----------------------------------------------
def health_dimension() -> dict:
    """The heartbeat rider: ``{}`` unless a prober is armed (so flags
    off leaves the payload byte-identical), else ``{"canary": "ok"}``
    or ``{"canary": "fail", "canary_targets": [...]}``."""
    try:
        p = prober(create=False)
        if p is None or not enabled():
            return {}
        failing = p.failing_targets()
        if failing:
            return {"canary": "fail", "canary_targets": failing}
        return {"canary": "ok"}
    except Exception:  # pragma: no cover - a broken probe never
        return {}      # stops a lease


def lease_rider(target: str) -> Optional[dict]:
    """Per-target streak summary for one replica's lease data — None
    when off / unknown target (byte-identity)."""
    p = prober(create=False)
    if p is None or not enabled():
        return None
    s = p.streaks().get(str(target))
    if s is None:
        return None
    return {"fail_streak": s["fail_streak"], "probes": s["probes"],
            "failures": s["failures"], "last_fail": s["last_fail"]}


def overhead_frac() -> float:
    p = prober(create=False)
    return p.overhead_frac() if p is not None else 0.0


def canaryz() -> dict:
    """The ``/canaryz`` payload (audit section appended by the page)."""
    if not enabled():
        return {"canary": "disabled (set FLAGS_canary_probe)"}
    p = prober(create=False)
    if p is None:
        return {"canary": {"targets": 0, "golden_cases": 0,
                           "cycles": 0, "streaks": {}}}
    return {"canary": p.snapshot()}


def canaryz_text(payload: Optional[dict] = None) -> str:
    """Human rendering of :func:`canaryz` (``/canaryz?text=1``)."""
    payload = payload if payload is not None else canaryz()
    can = payload.get("canary")
    if not isinstance(can, dict):
        return f"canary: {can}\n"
    streaks = can.get("streaks") or {}
    lines = [f"targets={can.get('targets')} "
             f"golden_cases={can.get('golden_cases')} "
             f"cycles={can.get('cycles')} "
             f"overhead_frac={can.get('overhead_frac')}"]
    hdr = ("target", "probes", "fail", "pass_strk", "fail_strk",
           "last_fail")
    lines.append("{:<26}{:>8}{:>6}{:>11}{:>11}  {}".format(*hdr))
    for t in sorted(streaks):
        s = streaks[t]
        lines.append("{:<26}{:>8}{:>6}{:>11}{:>11}  {}".format(
            t[:25], s.get("probes", 0), s.get("failures", 0),
            s.get("pass_streak", 0), s.get("fail_streak", 0),
            (s.get("last_fail") or "-")[:60]))
    if not streaks:
        lines.append("no targets probed yet")
    return "\n".join(lines) + "\n"


def export_state() -> Optional[dict]:
    """The STATS_PULL rider — None when off / no prober."""
    if not enabled():
        return None
    p = prober(create=False)
    if p is None:
        return None
    return p.snapshot()


def merge_states(per_worker: Dict[str, dict]) -> dict:
    """Fleet rollup: streak tables union (targets are replica-qualified
    so they never collide), totals sum, overhead takes the worst."""
    streaks: Dict[str, dict] = {}
    cases = cycles = 0
    overhead = 0.0
    failing = []
    for snap in per_worker.values():
        if not isinstance(snap, dict):
            continue
        cases = max(cases, int(snap.get("golden_cases") or 0))
        cycles += int(snap.get("cycles") or 0)
        overhead = max(overhead, float(snap.get("overhead_frac") or 0.0))
        thr = int(snap.get("fail_streak_threshold") or
                  fail_streak_threshold())
        for t, s in (snap.get("streaks") or {}).items():
            streaks[t] = dict(s)
            if int(s.get("fail_streak") or 0) >= thr:
                failing.append(t)
    return {"targets": len(streaks), "golden_cases": cases,
            "cycles": cycles, "overhead_frac": round(overhead, 6),
            "failing": sorted(failing), "streaks": streaks}
