"""Crash flight recorder: a black-box post-mortem for dead workers.

The port's copy of ``paddle_tpu/observability/flight.py``.

The health plane tells the fleet *that* a worker died; this
module records *what it was doing*.  Every process keeps a bounded ring
of recent log events (:func:`note`) next to the distributed-span ring
(``trace.py``) and the step-stats ring; when the process dies badly the
whole bundle — recent spans, **in-flight** spans, log events, the
step-stats tail — is dumped as one JSON file into
``FLAGS_flight_record_dir``:

- unhandled exceptions (``sys.excepthook`` / ``threading.excepthook``),
- SIGTERM (a killed worker still leaves its black box, main thread
  only — signal handlers cannot be installed elsewhere),
- explicit dirty exits (``Heartbeat.stop(bye=False)`` — the path a
  worker takes when it stops heartbeating without saying goodbye).

Strictly opt-in: with ``FLAGS_flight_record_dir`` empty (the default)
:func:`arm_from_flags` reads one flag and installs nothing; ``note()``
still records into the in-memory ring (cheap, bounded) so the
``/tracez?recent=1`` debug page works without the dump-to-disk hooks.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from . import step_stats as _step_stats
from . import trace as _trace
from ..core import flags as _flags

_EVENT_RING = 256      # recent log events kept
_SPAN_TAIL = 256       # completed spans included in a dump
_STEP_TAIL = 8         # step-stats records included in a dump

_lock = threading.Lock()
_events: deque = deque(maxlen=_EVENT_RING)
_total_events = 0
_hooks_installed = False
_last_dump_path: Optional[str] = None


def record_dir() -> str:
    try:
        return str(_flags.get_flags("flight_record_dir") or "")
    except KeyError:  # pragma: no cover - flag always defined
        return ""


def armed() -> bool:
    """Dump-to-disk hooks wanted (``FLAGS_flight_record_dir`` set)?"""
    return bool(record_dir())


def note(msg: str, **fields) -> None:
    """Append one log event to the flight ring (always-on, bounded).
    Call sites are the runtime's 'loud' moments — failovers, apply
    errors, dirty exits — so a post-mortem reads as a story."""
    global _total_events
    ev = {"ts": time.time(), "msg": str(msg)}
    if fields:
        ev.update(fields)
    with _lock:
        _events.append(ev)
        _total_events += 1


def events() -> List[dict]:
    with _lock:
        return [dict(e) for e in _events]


def clear_events() -> None:
    global _total_events
    with _lock:
        _events.clear()
        _total_events = 0


def snapshot(reason: str, exc_info=None) -> dict:
    """The post-mortem bundle (what :func:`dump` writes and the
    ``/tracez?recent=1`` debug page serves live)."""
    out = {
        "reason": reason,
        "ts": time.time(),
        "pid": os.getpid(),
        "role": os.environ.get("PADDLE_TRAINING_ROLE", "STANDALONE"),
        "argv": list(sys.argv),
        "open_spans": _trace.open_spans(),
        "spans": _trace.spans(limit=_SPAN_TAIL),
        "lanes": {str(k): v for k, v in _trace.local_trace_snapshot(
            limit=0)["lanes"].items()},
        "events": events(),
        "step_stats": _step_stats.recorder().export(tail=_STEP_TAIL),
    }
    if exc_info is not None:
        tp, val, tb = exc_info
        out["exception"] = "".join(
            traceback.format_exception(tp, val, tb))[-8000:]
    return out


def last_dump_path() -> Optional[str]:
    return _last_dump_path


def dump(reason: str, exc_info=None,
         dirname: Optional[str] = None) -> Optional[str]:
    """Write the post-mortem; returns the path (None when disarmed or
    the write fails — a dying process must never die harder over its
    own black box)."""
    global _last_dump_path
    dirname = dirname or record_dir()
    if not dirname:
        return None
    try:
        os.makedirs(dirname, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(
            dirname, f"flight_{os.getpid()}_{stamp}_{reason}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snapshot(reason, exc_info=exc_info), f, indent=2,
                      default=repr)
        os.replace(tmp, path)  # atomic: a reader never sees a partial
        _last_dump_path = path
        return path
    except Exception:  # pragma: no cover - disk full, perms, ...
        return None


def export_events(path: str, role: str = "") -> str:
    """Write this process's event ring as one JSON record
    ``{"role", "pid", "events"}`` (atomic rename).  The chaos suite's
    runners call it on the way out so a test can stitch the
    cross-process note chain without arming the full dump hooks."""
    rec = {"role": role or os.environ.get("PADDLE_TRAINING_ROLE", ""),
           "pid": os.getpid(), "events": events()}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, default=repr)
    os.replace(tmp, path)
    return path


def dirty_exit(reason: str) -> Optional[str]:
    """A worker leaving without a goodbye (``Heartbeat.stop(bye=False)``
    and friends): dump if armed, no-op otherwise."""
    note("dirty_exit", reason=reason)
    if not armed():
        return None
    return dump(reason)


def arm_from_flags() -> bool:
    """Install the crash hooks iff ``FLAGS_flight_record_dir`` is set
    (idempotent; called from ``Executor.__init__`` and
    ``RPCServer.start`` next to the debug-server opt-in).  Returns
    whether hooks are installed."""
    global _hooks_installed
    if _hooks_installed:
        return True
    if not armed():
        return False
    with _lock:
        if _hooks_installed:
            return True
        _hooks_installed = True

    prev_except = sys.excepthook

    def _excepthook(tp, val, tb):
        dump("unhandled_exception", exc_info=(tp, val, tb))
        prev_except(tp, val, tb)

    sys.excepthook = _excepthook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        dump("unhandled_thread_exception",
             exc_info=(args.exc_type, args.exc_value, args.exc_traceback))
        prev_thread(args)

    threading.excepthook = _thread_hook

    if threading.current_thread() is threading.main_thread():
        try:
            prev_term = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                dump("sigterm")
                if callable(prev_term):
                    prev_term(signum, frame)
                else:
                    # restore the default disposition and re-deliver so
                    # the exit status still says "killed by SIGTERM"
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):  # pragma: no cover - exotic hosts
            pass
    return True
