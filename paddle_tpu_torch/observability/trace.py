"""Runtime spans: profiler-stream spans + distributed trace propagation.

The port's copy of ``paddle_tpu/observability/trace.py``.

Two cooperating layers live here:

**Profiler-stream spans** (the original role): the runtime feeds the
``paddle_tpu_torch.profiler`` event stream under a ``runtime::`` name prefix
so ``profiler.chrome_trace()`` shows the lower→jit→dispatch pipeline
interleaved with user ``train_step`` spans.  Recorded only when the
profiler is armed AND ``FLAGS_runtime_stats`` is on.

**Distributed tracing** (Dapper-style): a :class:`SpanContext`
(trace id, span id, sampled bit) rides a thread-local stack; the
executor opens one *step-root* span per ``run`` (head-sampled by
``FLAGS_trace_sample_rate``), the RPC client injects the current
context into a compact wire extension on the frame
(``distributed/transport.py``), and the server opens child spans from
the inbound context — so a trainer step's ``send_vars`` and the
pserver's apply land under ONE trace id across processes.  Completed
spans go to a bounded in-memory ring (``FLAGS_trace_ring_spans``)
served over the ``TRACE_PULL`` RPC and the ``/tracez`` debug page;
``stitch_chrome_trace`` merges per-worker rings into one
Chrome/Perfetto JSON with real ``pid``/process-name metadata.

Overhead discipline: with sampling off (``FLAGS_trace_sample_rate=0``,
the default) ``start_span`` is a thread-local read plus two dict
lookups and returns a shared no-op — no ring writes, no wire bytes.
Span timestamps use ``time.time_ns()`` (the wall clock), the one clock
processes on a host share, so stitched timelines align without offset
fitting.
"""
from __future__ import annotations

import contextlib
import json
import os
import random as _random
import socket as _socket
import struct
import sys as _sys
import threading
import time
from collections import deque
from typing import Dict, List, Mapping, NamedTuple, Optional

from .. import profiler as _profiler
from ..core import flags as _flags

CATEGORY = "runtime"
PREFIX = "runtime::"


def flags_on() -> bool:
    """The one FLAGS_runtime_stats gate — every instrumentation site
    (executor, lowering, transport, observability.enabled) routes
    through here so gating semantics live in a single place."""
    try:
        return bool(_flags.get_flags("runtime_stats"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


def enabled() -> bool:
    # profiler check first: it is False in steady state, so the common
    # path is one dict lookup
    return _profiler.is_profiler_enabled() and flags_on()


def emit(name: str, t0_ns: int, t1_ns: int) -> None:
    """Record an already-timed runtime span (callers that measured a
    region for stats anyway reuse the timestamps instead of nesting a
    context manager)."""
    _profiler._emit(PREFIX + name, t0_ns, t1_ns, cat=CATEGORY)


@contextlib.contextmanager
def span(name: str):
    """``with trace.span("executor::lower"): ...`` — no-op when disabled."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        _profiler._emit(PREFIX + name, t0, time.perf_counter_ns(),
                        cat=CATEGORY)


# ---------------------------------------------------------------------------
# distributed tracing: trace context, span ring, fleet stitching
# ---------------------------------------------------------------------------

_SNAPSHOT_VERSION = 1

# compact wire form of a SpanContext (the RPC frame extension):
# u64 trace_id | u64 span_id | u8 flags (bit0 = sampled)
_WIRE = struct.Struct("<QQB")
WIRE_CTX_SIZE = _WIRE.size


class SpanContext(NamedTuple):
    """What crosses a process (or thread) boundary: enough to parent a
    child span, nothing else (the Dapper trace-context shape)."""

    trace_id: int
    span_id: int
    sampled: bool = True


def ctx_to_wire(ctx: SpanContext) -> bytes:
    return _WIRE.pack(ctx.trace_id, ctx.span_id, 1 if ctx.sampled else 0)


def ctx_from_wire(data) -> Optional[SpanContext]:
    """Decode a wire extension; None for anything malformed (a peer of a
    future build must never crash the request path over trace bytes)."""
    if data is None:
        return None
    b = bytes(data)
    if len(b) != _WIRE.size:
        return None
    trace_id, span_id, fl = _WIRE.unpack(b)
    return SpanContext(trace_id, span_id, bool(fl & 1))


_tls = threading.local()


def current() -> Optional[SpanContext]:
    """The innermost active context on THIS thread (or None)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _push(ctx: SpanContext) -> None:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)


def _pop() -> None:
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


@contextlib.contextmanager
def activate(ctx: Optional[SpanContext]):
    """Re-home a captured context onto this thread — the explicit
    handoff for fan-out pools (``RPCClient.parallel``, stripe threads),
    where thread-local context does not follow the work."""
    if ctx is None:
        yield
        return
    _push(ctx)
    try:
        yield
    finally:
        _pop()


def inject() -> Optional[bytes]:
    """Wire bytes of the current context, or None when nothing sampled
    is active — the None path is what keeps unsampled frames
    byte-identical to the pre-trace wire format."""
    c = current()
    return ctx_to_wire(c) if c is not None and c.sampled else None


def sample_rate() -> float:
    try:
        return float(_flags.get_flags("trace_sample_rate"))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return 0.0


# Private RNG: id generation and sampling draws must not consume from
# (or collide through) the process-global `random` instance — workers
# that call random.seed(K) for reproducibility would otherwise all
# generate the SAME id sequence, and enabling sampling would silently
# shift seeded training runs.  random.Random() self-seeds from urandom.
_rng = _random.Random()


def _new_id() -> int:
    # nonzero 63-bit ids: 0 is the "no parent" sentinel, and staying
    # under 2**63 keeps every JSON consumer (signed-int parsers) happy
    return _rng.getrandbits(63) | 1


# span ring: completed spans, process-wide, bounded
_ring_lock = threading.Lock()
_ring: deque = deque(maxlen=4096)
_open_spans: Dict[int, "Span"] = {}
_total_recorded = 0


def _ring_capacity() -> int:
    try:
        return max(16, int(_flags.get_flags("trace_ring_spans")))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return 4096


class Span:
    """One traced region; context manager.  Created via
    :func:`start_span` (which owns the sample decision) — entering
    pushes this span's context for children, exiting records it into
    the ring.  In-flight spans are visible to the flight recorder."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "t0_ns", "t1_ns", "tags", "error", "lane")

    def __init__(self, name: str, cat: str, trace_id: int, parent_id: int,
                 tags: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.tags = dict(tags) if tags else None
        self.error = None
        self.t0_ns = 0
        self.t1_ns = 0
        self.lane = 0

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, True)

    def annotate(self, **tags) -> None:
        """Attach key→value tags (shown as Chrome-trace args)."""
        if self.tags is None:
            self.tags = {}
        self.tags.update(tags)

    def __enter__(self) -> "Span":
        self.t0_ns = time.time_ns()
        self.lane = _profiler.thread_lane()
        _push(self.context())
        with _ring_lock:
            _open_spans[self.span_id] = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1_ns = time.time_ns()
        if exc is not None:
            self.error = repr(exc)[:200]
        _pop()
        global _total_recorded
        with _ring_lock:
            _open_spans.pop(self.span_id, None)
            if _ring.maxlen != _ring_capacity():
                _resize_ring_locked()
            _ring.append(self)
            _total_recorded += 1
        return False

    def to_dict(self, now_ns: Optional[int] = None) -> dict:
        t1 = self.t1_ns or (now_ns if now_ns is not None else time.time_ns())
        d = {"name": self.name, "cat": self.cat,
             "trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "tid": self.lane,
             "ts_us": self.t0_ns / 1000.0,
             "dur_us": max(t1 - self.t0_ns, 0) / 1000.0}
        if not self.t1_ns:
            d["in_flight"] = True
        if self.error:
            d["error"] = self.error
        if self.tags:
            d["tags"] = dict(self.tags)
        return d


def _resize_ring_locked() -> None:
    global _ring
    _ring = deque(_ring, maxlen=_ring_capacity())


_NOOP = contextlib.nullcontext()
NOOP = _NOOP  # callers that pre-check current() reuse the shared no-op


def start_span(name: str, cat: str = "runtime",
               parent: Optional[SpanContext] = None, root: bool = True,
               tags: Optional[dict] = None):
    """Open a distributed span; returns a context manager.

    - ``parent`` given (the server side, from the wire): child of it.
    - otherwise child of this thread's current context, if any.
    - no context at all: a ROOT is head-sampled by
      ``FLAGS_trace_sample_rate`` — unless ``root=False`` (RPC client /
      host-op internals, which never start traces of their own).

    Unsampled / disabled paths return a shared no-op context manager.
    """
    p = parent if parent is not None else current()
    if p is None:
        if not root or not flags_on():
            return _NOOP
        rate = sample_rate()
        if rate <= 0.0 or (rate < 1.0 and _rng.random() >= rate):
            return _NOOP
        return Span(name, cat, _new_id(), 0, tags)
    if not p.sampled or not flags_on():
        return _NOOP
    return Span(name, cat, p.trace_id, p.span_id, tags)


def spans(limit: Optional[int] = None) -> List[dict]:
    """Completed spans (ring tail), oldest first."""
    with _ring_lock:
        out = list(_ring)
    if limit is not None and limit >= 0:
        out = out[-limit:] if limit else []
    return [s.to_dict() for s in out]


def open_spans() -> List[dict]:
    """In-flight spans (entered, not yet exited) — the post-mortem view
    the flight recorder dumps when a worker dies mid-step."""
    now = time.time_ns()
    with _ring_lock:
        live = list(_open_spans.values())
    return [s.to_dict(now_ns=now) for s in live]


def total_spans_recorded() -> int:
    with _ring_lock:
        return _total_recorded


def clear_spans() -> None:
    global _total_recorded
    with _ring_lock:
        _ring.clear()
        _open_spans.clear()
        _total_recorded = 0


def _process_role() -> str:
    return os.environ.get("PADDLE_TRAINING_ROLE", "STANDALONE")


def local_trace_snapshot(limit: Optional[int] = None) -> dict:
    """This process's span ring + identity — the ``TRACE_PULL`` response
    body and the unit :func:`stitch_chrome_trace` merges."""
    try:
        host = _socket.gethostname()
    except OSError:  # pragma: no cover
        host = "?"
    snap = {"version": _SNAPSHOT_VERSION,
            "pid": os.getpid(),
            "host": host,
            "role": _process_role(),
            "argv0": os.path.basename(_sys.argv[0]) if _sys.argv else "",
            "sample_rate": sample_rate(),
            "total_recorded": total_spans_recorded(),
            "lanes": _profiler.lane_names(),
            "spans": spans(limit=limit)}
    # memory-anatomy counter lanes (FLAGS_memory_attribution): per-pool
    # resident/parked byte series rebuilt from the allocation event
    # ring, rendered by stitch_chrome_trace as ph:"C" counter tracks.
    # Lazy import — memory.py must stay importable without trace.py.
    from . import memory as _memory
    if _memory.enabled():
        counters = _memory.counter_series()
        if counters:
            snap["counters"] = counters
    return snap


def local_snapshot_payload(limit: Optional[int] = None) -> bytes:
    return json.dumps(local_trace_snapshot(limit=limit)).encode("utf-8")


def _span_chrome_event(s: dict, pid: int) -> dict:
    args = {"trace_id": f"{int(s.get('trace_id', 0)):016x}",
            "span_id": f"{int(s.get('span_id', 0)):016x}"}
    if s.get("parent_id"):
        args["parent_id"] = f"{int(s['parent_id']):016x}"
    if s.get("error"):
        args["error"] = s["error"]
    if s.get("in_flight"):
        args["in_flight"] = True
    for k, v in (s.get("tags") or {}).items():
        args.setdefault(str(k), v)
    return {"name": s.get("name", "?"), "cat": s.get("cat", "runtime"),
            "ph": "X", "pid": pid, "tid": int(s.get("tid", 0)),
            "ts": s.get("ts_us", 0.0),
            # zero-duration spans still get a sliver so Perfetto renders
            "dur": max(float(s.get("dur_us", 0.0)), 0.001),
            "args": args}


def stitch_chrome_trace(per_worker: Mapping[str, dict]) -> dict:
    """{worker label: local_trace_snapshot()} → one Chrome/Perfetto
    JSON: every worker keeps its REAL pid (collisions across hosts get
    bumped deterministically), with ``process_name``/``thread_name``
    metadata so a trainer+pserver step renders as one labeled
    multi-process timeline."""
    events: List[dict] = []
    used_pids: set = set()
    for worker in sorted(per_worker):
        snap = per_worker[worker] or {}
        pid = int(snap.get("pid", 0))
        while pid in used_pids:
            pid += 1
        used_pids.add(pid)
        label = f"{worker} · {snap.get('role', '?')} (pid {snap.get('pid')}"
        host = snap.get("host")
        label += f" @ {host})" if host else ")"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        for lane, lname in sorted((snap.get("lanes") or {}).items(),
                                  key=lambda kv: int(kv[0])):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": int(lane), "args": {"name": str(lname)}})
        for s in snap.get("spans", []):
            events.append(_span_chrome_event(s, pid))
        # memory counter lanes: one ph:"C" track per pool, resident +
        # parked bytes stacked, sharing the span timeline's wall-clock
        # microsecond axis (both derive from time.time())
        for c in snap.get("counters", []):
            events.append({"ph": "C", "name": f"mem:{c.get('pool')}",
                           "pid": pid, "tid": 0,
                           "ts": c.get("ts_us", 0.0),
                           "args": {"resident": c.get("resident", 0),
                                    "parked": c.get("parked", 0)}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
