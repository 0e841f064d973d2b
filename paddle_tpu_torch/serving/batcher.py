"""Continuous dynamic batching: coalesce requests onto a bucket ladder.

The port of ``paddle_tpu/serving/batcher.py``.  Concurrent
:meth:`DynamicBatcher.submit` calls enqueue requests; one scheduler
thread coalesces them into a single batch padded to the smallest bucket
that fits (:class:`BucketLadder`), runs it through the model's
:class:`~paddle_tpu_torch.inference.Predictor`, and a completion thread
slices each request's rows back out (pad rows never leave the server).
A batch goes out as soon as the top bucket fills or the oldest queued
request has waited ``max_delay_ms``.  Buckets keep every dispatch on a
handful of shapes; the decode plane uses the same ladder.

Admission control: a bounded queue (``max_queue_rows``) and an optional
queue-delay SLO (``queue_delay_slo_ms``); past either a request is shed
with a typed :class:`Overloaded`, and a sequence feed longer than
``max_seq_len`` with a typed :class:`RequestTooLong`, never queued.

``Predictor.run`` returns host arrays, so the scheduler thread waits
for each batch; the completion thread answers the futures while the
next batch runs.

The flag-gated recorders are the reference's: request phases
(``FLAGS_phase_attribution``; the predictor's device work lands in
``dispatch``, since ``run`` returns host arrays, and ``device`` is the
wait in the completion queue), capacity, tenant metering, the staging
pool in the MemoryLedger with OOM forensics, the ``serving::dispatch``
trace span and the ``serving_dispatch`` fault-injection site.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import flags as _flags
from ..core.types import np_dtype
from ..distributed import faults as _faults
from ..observability import capacity as _capacity
from ..observability import debug_server as _debug_server
from ..observability import memory as _memory
from ..observability import phase as _phase
from ..observability import stats as _obs_stats
from ..observability import tenant as _tenant
from ..observability import trace as _obs_trace

# request lifecycle phases (FLAGS_phase_attribution; observability/
# phase.py): consecutive monotonic stamps, so the five sum EXACTLY to
# the request's end-to-end wall — a p99 regression names its phase
#   queue     submit accepted -> its batch starts assembling
#   assemble  coalesce + pad + feed build
#   dispatch  Predictor.run (the device work and the readback; injected
#             dispatch faults land here)
#   device    dispatch return -> batch taken by the completion thread
#   reply     taken -> this request's future completed
SERVING_PHASES = ("queue", "assemble", "dispatch", "device", "reply")
# capacity-tracked components: the phases that consume a worker
# thread's wall ("queue" is waiting, not busy — it never saturates)
SERVING_CAPACITY_COMPONENTS = ("assemble", "dispatch", "device", "reply")


class Overloaded(RuntimeError):
    """Typed load-shed reply: the request was NOT queued.

    Carried over the wire by :mod:`server`/:mod:`client` so a remote
    caller sees the same type with the same fields — clients should
    back off or fail over to another replica."""

    def __init__(self, model: str, queue_rows: int, limit_rows: int,
                 est_delay_ms: Optional[float] = None,
                 slo_ms: Optional[float] = None):
        self.model = model
        self.queue_rows = queue_rows
        self.limit_rows = limit_rows
        self.est_delay_ms = est_delay_ms
        self.slo_ms = slo_ms
        if est_delay_ms is not None:
            why = (f"estimated queue delay {est_delay_ms:.1f} ms exceeds "
                   f"SLO {slo_ms:.1f} ms")
        else:
            why = f"queue full ({queue_rows}/{limit_rows} rows)"
        super().__init__(f"model {model!r} overloaded: {why}")

    def to_dict(self) -> dict:
        return {"model": self.model, "queue_rows": self.queue_rows,
                "limit_rows": self.limit_rows,
                "est_delay_ms": self.est_delay_ms, "slo_ms": self.slo_ms}

    @classmethod
    def from_dict(cls, d: dict) -> "Overloaded":
        return cls(d.get("model", "?"), int(d.get("queue_rows", 0)),
                   int(d.get("limit_rows", 0)), d.get("est_delay_ms"),
                   d.get("slo_ms"))


class Draining(RuntimeError):
    """Typed graceful-shutdown rejection: the request was NOT queued.

    A replica that is draining (``ModelServer.stop(drain=True)`` /
    ``DecodeServer`` SIGTERM) has already DEREGISTERED its registry
    lease — discovery-based clients fail over before the socket ever
    dies — and answers any straggler submit with this instead of
    accepting work it would have to abandon.  In-flight requests still
    finish inside the drain bound.  Carried over the wire like
    :class:`Overloaded`; clients rotate to another replica (unlike
    :class:`RequestTooLong`, some other replica WILL take it)."""

    def __init__(self, model: str, endpoint: str = ""):
        self.model = model
        self.endpoint = endpoint
        where = f" at {endpoint}" if endpoint else ""
        super().__init__(
            f"model {model!r} replica{where} is draining (graceful "
            "shutdown); retry another replica")

    def to_dict(self) -> dict:
        return {"model": self.model, "endpoint": self.endpoint}

    @classmethod
    def from_dict(cls, d: dict) -> "Draining":
        return cls(d.get("model", "?"), d.get("endpoint", ""))


class RequestTooLong(ValueError):
    """Typed over-length rejection: the request was NOT queued.

    Raised at submit when a feed's sequence axis exceeds the model's
    ``max_seq_len`` (or a decode prompt+budget exceeds the engine's
    context bound) — BEFORE the request can poison its coalesced batch
    or force an off-ladder recompile.  Carried over the wire like
    :class:`Overloaded` so remote callers see the same type; unlike
    Overloaded it must NOT fail over to another replica — every replica
    of the model would reject it identically."""

    def __init__(self, model: str, feed: str, length: int, limit: int):
        self.model = model
        self.feed = feed
        self.length = int(length)
        self.limit = int(limit)
        super().__init__(
            f"model {model!r}: feed {feed!r} length {length} exceeds "
            f"max_seq_len {limit}")

    def to_dict(self) -> dict:
        return {"model": self.model, "feed": self.feed,
                "length": self.length, "limit": self.limit}

    @classmethod
    def from_dict(cls, d: dict) -> "RequestTooLong":
        return cls(d.get("model", "?"), d.get("feed", "?"),
                   int(d.get("length", 0)), int(d.get("limit", 0)))


class BucketLadder:
    """Sorted batch-size ladder; ``snap(n)`` is the smallest bucket
    ≥ n.  Requests larger than the top bucket are rejected at submit
    (dispatching off-ladder would recompile — the one thing the
    serving plane exists to never do)."""

    def __init__(self, buckets: Optional[Sequence[int]] = None):
        if buckets is None:
            buckets = self.flag_buckets()
        sizes = sorted({int(b) for b in buckets})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"invalid bucket ladder: {buckets!r}")
        self.sizes = tuple(sizes)

    @staticmethod
    def parse(spec) -> List[int]:
        """The ladder-spec grammar ("1,2,4" / "1;2;4"), shared by the
        flag default and tools/serve.py's --buckets."""
        return [int(p) for p in str(spec).replace(";", ",").split(",")
                if p.strip()]

    @classmethod
    def flag_buckets(cls) -> List[int]:
        return cls.parse(_flags.get_flags("serving_buckets"))

    @property
    def max(self) -> int:
        return self.sizes[-1]

    def snap(self, n: int) -> int:
        for b in self.sizes:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the top bucket {self.max}")

    def __repr__(self) -> str:
        return f"BucketLadder{self.sizes}"


class _Request:
    __slots__ = ("feed", "rows", "future", "t_enq", "tl", "tenant")

    def __init__(self, feed: Dict[str, np.ndarray], rows: int,
                 tenant: Optional[str] = None):
        self.feed = feed
        self.rows = rows
        self.tenant = tenant
        self.future: "Future" = Future()
        self.t_enq = time.monotonic()
        # phase timeline, sharing the enqueue stamp (flag-gated; None
        # keeps the flag-off path allocation-free)
        self.tl = (_phase.PhaseTimeline(t0=self.t_enq)
                   if _phase.enabled() else None)


class BatcherStats:
    """Per-model serving gauges for /servingz: QPS and latency
    percentiles over a bounded recent window, plus lifetime counters
    (also in the stats registry as ``serving.<model>.*``)."""

    _WINDOW = 512

    def __init__(self, model: str):
        self.model = model
        self._lock = threading.Lock()
        # (t_done_monotonic, latency_ms) of recent completed requests
        self._recent: deque = deque(maxlen=self._WINDOW)
        # per-request phase attribution (FLAGS_phase_attribution):
        # created on first observe so a flag-off process never
        # registers serving.<model>.phase.* series
        self._phases: Optional[_phase.PhaseRecorder] = None
        self.requests = 0
        self.rows = 0
        self.shed = 0
        self.batches = 0
        self.padded_rows = 0
        self.dispatched_rows = 0
        self.errors = 0
        sc = _obs_stats.scope(f"serving.{model}")
        self._c_requests = sc.counter("requests")
        self._c_rows = sc.counter("rows")
        self._c_shed = sc.counter(
            "shed", "requests refused by admission control (typed "
            "Overloaded reply; queue bound or queue-delay SLO)")
        self._c_batches = sc.counter("batches")
        self._c_padded = sc.counter(
            "padded_rows", "pad rows added to snap batches onto the "
            "bucket ladder (sliced off before the reply)")
        self._c_errors = sc.counter("errors")
        self._g_depth = sc.gauge("queue_rows")
        self._h_latency = sc.histogram("latency_ms")
        self._h_occupancy = sc.histogram(
            "batch_occupancy_pct", buckets=(10, 25, 50, 75, 90, 100))

    def note_submit(self, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += rows
        self._c_requests.inc()
        self._c_rows.inc(rows)

    def note_shed(self) -> None:
        with self._lock:
            self.shed += 1
        self._c_shed.inc()

    def note_batch(self, rows: int, bucket: int) -> None:
        with self._lock:
            self.batches += 1
            self.padded_rows += bucket - rows
            self.dispatched_rows += rows
        self._c_batches.inc()
        self._c_padded.inc(bucket - rows)
        self._h_occupancy.observe(100.0 * rows / bucket)

    def note_done(self, n_requests: int, latencies_ms: List[float],
                  error: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if error:
                self.errors += n_requests
            for lat in latencies_ms:
                self._recent.append((now, lat))
        if error:
            self._c_errors.inc(n_requests)
        for lat in latencies_ms:
            self._h_latency.observe(lat)

    def set_depth(self, rows: int) -> None:
        self._g_depth.set(rows)

    def note_phases(self, tl, trace_id=None) -> None:
        """Fold one finished request timeline into the per-phase
        histograms + sample ring (completion thread)."""
        with self._lock:
            rec = self._phases
            if rec is None:
                rec = self._phases = _phase.PhaseRecorder(
                    f"serving.{self.model}", SERVING_PHASES)
        rec.observe(tl, trace_id=trace_id)

    def phases(self) -> Optional[_phase.PhaseRecorder]:
        with self._lock:
            return self._phases

    def capacity_tracker(self) -> "_capacity.CapacityTracker":
        """Get-or-create this model's capacity tracker (callers gate on
        ``_capacity.enabled()`` so a flag-off process never registers
        ``serving.<model>.util.*`` series)."""
        return _capacity.tracker(f"serving.{self.model}",
                                 SERVING_CAPACITY_COMPONENTS)

    def capacity(self) -> Optional["_capacity.CapacityTracker"]:
        return _capacity.get(f"serving.{self.model}")

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            recent = list(self._recent)
            phases = self._phases
            out = {
                "requests": self.requests, "rows": self.rows,
                "shed": self.shed, "batches": self.batches,
                "padded_rows": self.padded_rows, "errors": self.errors,
                "avg_batch_occupancy": (
                    round(self.dispatched_rows
                          / max(self.dispatched_rows + self.padded_rows, 1),
                          3)),
            }
        if recent:
            span = max(now - recent[0][0], 1e-3)
            lats = sorted(lat for _, lat in recent)
            out.update({
                "qps": round(len(recent) / span, 1),
                "p50_ms": round(_obs_stats.percentile_sorted(lats, 0.50), 3),
                "p99_ms": round(_obs_stats.percentile_sorted(lats, 0.99), 3),
            })
        if phases is not None:
            out["phases"] = phases.snapshot()
        cap = self.capacity()
        if cap is not None:
            out["capacity"] = cap.snapshot()
        return out


def _pad_rows(arr: np.ndarray, pad: int) -> np.ndarray:
    """Pad ``arr`` to ``len(arr) + pad`` rows by repeating the last row:
    real values keep every op numerically tame (an all-zero pad can
    divide by zero in a normalization), and the pad rows are sliced off
    before any reply."""
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


class DynamicBatcher:
    """One model version's continuous-batching scheduler (module doc).

    ``predictor`` needs ``run(feed_dict)``, ``feed_names`` and
    ``fetch_names``.  All feeds share the leading (batch) dimension;
    coalescing concatenates along it."""

    def __init__(self, predictor, name: str = "model",
                 buckets: Optional[Sequence[int]] = None,
                 max_delay_ms: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 queue_delay_slo_ms: Optional[float] = None,
                 max_seq_len: Optional[int] = None):
        self.predictor = predictor
        self.name = name
        # per-model sequence-length bound: an int applies to the feeds
        # whose declaration does not pin a static sample shape, a dict
        # names feed -> limit
        self.max_seq_len = max_seq_len if isinstance(max_seq_len, dict) \
            else (int(max_seq_len) if max_seq_len else None)
        self.ladder = (buckets if isinstance(buckets, BucketLadder)
                       else BucketLadder(buckets))
        self.max_delay_ms = (
            float(_flags.get_flags("serving_max_queue_delay_ms"))
            if max_delay_ms is None else float(max_delay_ms))
        self.max_queue_rows = (
            int(_flags.get_flags("serving_max_queue_rows"))
            if max_queue_rows is None else int(max_queue_rows))
        slo = (_flags.get_flags("serving_queue_delay_slo_ms")
               if queue_delay_slo_ms is None else queue_delay_slo_ms)
        self.queue_delay_slo_ms = float(slo) or None  # 0 disables it
        self.stats = BatcherStats(name)
        # per-feed [sample_shape, dtype] each request must match, so a
        # malformed request is refused alone at submit; seeded from the
        # program's static feed declarations, else latched from the
        # first accepted request
        self._feed_contract: Dict[str, list] = {}
        prog = getattr(predictor, "program", None)
        block = prog().global_block if callable(prog) else None
        for n in predictor.feed_names:
            var = block.var_or_none(n) if block is not None else None
            if var is not None and var.shape is not None and \
                    not any(s < 0 for s in var.shape[1:]):
                self._feed_contract[n] = [tuple(var.shape[1:]),
                                          np.dtype(np_dtype(var.dtype))
                                          if var.dtype is not None else None]
            else:
                self._feed_contract[n] = [None, None]
        if isinstance(self.max_seq_len, dict):
            self._seq_limits = {n: int(v)
                                for n, v in self.max_seq_len.items()}
        elif self.max_seq_len:
            self._seq_limits = {n: int(self.max_seq_len)
                                for n, c in self._feed_contract.items()
                                if c[0] is None}
        else:
            self._seq_limits = {}

        self._cv = threading.Condition()
        self._q: deque = deque()
        self._rows_queued = 0
        self._inflight_batches = 0
        self._closed = False
        self._ewma_batch_ms: Optional[float] = None
        # the completion thread answers each batch's futures in dispatch
        # order while the scheduler runs the next batch
        self._done_q: deque = deque()
        self._done_cv = threading.Condition()
        # memory anatomy (FLAGS_memory_attribution): batch staging —
        # queued request feeds plus batches awaiting completion — is a
        # host-side byte holder; flag off, no pool, no series
        self._mem_pool: Optional[str] = None
        if _memory.enabled():
            self._mem_pool = f"serving_staging.{name}"
            _memory.pool(self._mem_pool, "host",
                         self._mem_pool_snapshot)
        self._sched = threading.Thread(
            target=self._sched_loop, daemon=True,
            name=f"serving-sched-{name}")
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True,
            name=f"serving-complete-{name}")
        self._sched.start()
        self._completer.start()

    def _mem_pool_snapshot(self) -> dict:
        """MemoryLedger callback: bytes staged in the request queue
        plus batches dispatched but not yet completed (their request
        feeds are held until the reply slices out)."""
        with self._cv:
            queued = sum(sum(a.nbytes for a in r.feed.values())
                         for r in self._q)
            q_reqs = len(self._q)
        with self._done_cv:
            inflight = [t[0] for t in self._done_q]
        staged = sum(sum(a.nbytes for a in r.feed.values())
                     for take in inflight for r in take)
        return {"used": queued + staged, "queued_bytes": queued,
                "inflight_bytes": staged, "queued_requests": q_reqs}

    # -- request side ------------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               tenant: Optional[str] = None) -> "Future":
        """Enqueue one request; the Future resolves to the list of fetch
        arrays (leading dim = this request's rows).  ``tenant`` is an
        optional client-supplied id for per-tenant usage metering
        (``FLAGS_tenant_accounting``; ignored when off).  Raises
        :class:`Overloaded` or :class:`RequestTooLong` (shed, never
        queued) or ``ValueError`` (a malformed feed, or more rows than
        the top bucket)."""
        arrs = {}
        rows = None
        for n in self.predictor.feed_names:
            if n not in feed:
                raise ValueError(f"request missing feed {n!r}")
            a = np.asarray(feed[n])
            if a.ndim == 0:
                raise ValueError(f"feed {n!r} must be batch-major")
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise ValueError(
                    f"feeds disagree on the batch dim: {n!r} has "
                    f"{a.shape[0]} rows, expected {rows}")
            lim = self._seq_limits.get(n)
            if lim is not None and a.ndim >= 2 and a.shape[1] > lim:
                self.stats.note_shed()
                raise RequestTooLong(self.name, n, a.shape[1], lim)
            contract = self._feed_contract[n]
            if contract[0] is not None and a.shape[1:] != contract[0]:
                raise ValueError(
                    f"feed {n!r} sample shape {a.shape[1:]} does not "
                    f"match this model's {contract[0]}")
            if contract[1] is not None and a.dtype != contract[1]:
                # cast here: a stray float64 request must not promote
                # the whole coalesced batch
                a = a.astype(contract[1])
            arrs[n] = a
        if not rows:
            raise ValueError("empty request (0 rows)")
        if rows > self.ladder.max:
            raise ValueError(
                f"request of {rows} rows exceeds the top bucket "
                f"{self.ladder.max}; split it client-side")
        req = _Request(arrs, rows, tenant=tenant)
        with self._cv:
            if self._closed:
                raise RuntimeError(f"batcher {self.name!r} is closed")
            for n, a in arrs.items():
                c = self._feed_contract[n]
                if c[0] is None:
                    # no static declaration: the first accepted request
                    # fixes the sample shape
                    c[0] = a.shape[1:]
                    if c[1] is None:
                        c[1] = a.dtype
                elif a.shape[1:] != c[0]:
                    raise ValueError(
                        f"feed {n!r} sample shape {a.shape[1:]} does "
                        f"not match this model's {c[0]}")
            depth = self._rows_queued
            if depth + rows > self.max_queue_rows:
                self.stats.note_shed()
                raise Overloaded(self.name, depth, self.max_queue_rows)
            if self.queue_delay_slo_ms is not None and \
                    self._ewma_batch_ms is not None:
                # the wait behind work already accepted (queued and
                # in-flight batches at the observed batch time), not the
                # request's own service time: an idle server admits
                backlog = (depth + self.ladder.max - 1) \
                    // self.ladder.max + self._inflight_batches
                est = backlog * self._ewma_batch_ms
                if est > self.queue_delay_slo_ms:
                    self.stats.note_shed()
                    raise Overloaded(self.name, depth, self.max_queue_rows,
                                     est, self.queue_delay_slo_ms)
            self._q.append(req)
            self._rows_queued += rows
            self.stats.set_depth(self._rows_queued)
            self._cv.notify_all()
        self.stats.note_submit(rows)
        if _tenant.enabled():
            _tenant.account(tenant, requests=1, rows=rows)
        return req.future

    def infer(self, feed: Dict[str, np.ndarray],
              timeout: Optional[float] = None,
              tenant: Optional[str] = None) -> List[np.ndarray]:
        """Blocking convenience over :meth:`submit`."""
        return self.submit(feed, tenant=tenant).result(timeout=timeout)

    # -- scheduler ---------------------------------------------------------
    def _sched_loop(self) -> None:
        while True:
            take, total = self._gather()
            if take is None:
                return
            self._dispatch(take, total)

    def _gather(self):
        """Block until a batch is due: the top bucket full, the oldest
        request past max_delay_ms, or close."""
        max_rows = self.ladder.max
        delay_s = self.max_delay_ms / 1e3
        with self._cv:
            while True:
                if self._q:
                    if self._rows_queued >= max_rows or self._closed:
                        break
                    remaining = self._q[0].t_enq + delay_s - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                elif self._closed:
                    return None, 0
                else:
                    self._cv.wait()
            take, total = [], 0
            while self._q and total + self._q[0].rows <= max_rows:
                r = self._q.popleft()
                take.append(r)
                total += r.rows
            self._rows_queued -= total
            self._inflight_batches += 1
            self.stats.set_depth(self._rows_queued)
        return take, total

    def _dispatch(self, take: List[_Request], total: int) -> None:
        bucket = self.ladder.snap(total)
        t0 = time.monotonic()
        _debug_server.note_activity("serving")
        stamped = any(r.tl is not None for r in take)
        cap = (self.stats.capacity_tracker()
               if _capacity.enabled() else None)
        if stamped:
            # one clock read stamps the whole batch: queue ends when
            # its batch starts assembling
            for r in take:
                if r.tl is not None:
                    r.tl.stamp("queue", t=t0)
        trace_id = None
        t_asm = t_disp = None
        try:
            feed = {}
            for n in self.predictor.feed_names:
                a = (take[0].feed[n] if len(take) == 1
                     else np.concatenate([r.feed[n] for r in take], axis=0))
                feed[n] = _pad_rows(a, bucket - total)
            if stamped or cap is not None:
                t_asm = time.monotonic()
            if stamped:
                for r in take:
                    if r.tl is not None:
                        r.tl.stamp("assemble", t=t_asm)
            # chaos hooks: a `delay:serving_dispatch` rule sleeps HERE,
            # inside the dispatch phase; an `oom:serving_dispatch` rule
            # raises the injected out-of-memory error where a real
            # device allocation failure would
            _faults.event("serving_dispatch")
            _faults.oom_fault("serving_dispatch")
            with _obs_trace.start_span("serving::dispatch", cat="serving",
                                       root=False,
                                       tags={"model": self.name,
                                             "bucket": bucket,
                                             "rows": total}) as sp:
                outs = self.predictor.run(feed)
                trace_id = getattr(sp, "trace_id", None)
            if stamped or cap is not None:
                t_disp = time.monotonic()
            if stamped:
                for r in take:
                    if r.tl is not None:
                        r.tl.stamp("dispatch", t=t_disp)
            err = None
        except Exception as e:
            # OOM forensics: an out-of-memory error escaping the
            # dispatch dumps the full ledger + top holders + event tail
            # BEFORE the error reaches the request futures (no-op
            # unless FLAGS_memory_attribution and an actual OOM)
            _memory.oom_forensics(e, "serving_dispatch")
            outs, err = None, e
        if cap is not None and t_disp is not None:
            # the scheduler thread's busy legs: ONE span per batch
            # (batch members share the wall — per-request would
            # double-count), so windowed busy/wall is a utilization
            cap.note("assemble", (t_asm - t0) * 1e3)
            cap.note("dispatch", (t_disp - t_asm) * 1e3)
        self.stats.note_batch(total, bucket)
        with self._done_cv:
            self._done_q.append((take, outs, err, t0, trace_id, bucket))
            self._done_cv.notify()

    # -- completion --------------------------------------------------------
    def _complete_loop(self) -> None:
        while True:
            with self._done_cv:
                while not self._done_q:
                    # exit only once the scheduler is done for good
                    if self._closed and not self._sched.is_alive():
                        return
                    self._done_cv.wait(timeout=0.2)
                take, outs, err, t0, trace_id, bucket = \
                    self._done_q.popleft()
            now = time.monotonic()
            if err is not None:
                for r in take:
                    r.future.set_exception(err)
                self.stats.note_done(
                    len(take), [(now - r.t_enq) * 1e3 for r in take],
                    error=True)
            else:
                cap = (self.stats.capacity_tracker()
                       if _capacity.enabled() else None)
                outs = [np.asarray(o) for o in outs]
                t_mat = time.monotonic()
                total = sum(r.rows for r in take)
                if cap is not None:
                    cap.note("device", (t_mat - now) * 1e3,
                             bucket=bucket, work=total)
                ten_on = _tenant.enabled()
                dev_ms = (t_mat - now) * 1e3 if ten_on else 0.0
                off = 0
                for r in take:
                    if r.tl is not None:
                        r.tl.stamp("device", t=t_mat)
                    r.future.set_result([o[off:off + r.rows] for o in outs])
                    if r.tl is not None:
                        # per-request reply stamp: slicing + future
                        # completion, the final leg of the wall
                        r.tl.stamp("reply")
                        self.stats.note_phases(r.tl, trace_id=trace_id)
                    off += r.rows
                now = time.monotonic()
                if cap is not None:
                    cap.note("reply", (now - t_mat) * 1e3)
                    cap.note_done(len(take))
                if ten_on:
                    # the shared batch's wall splits by row share, so
                    # per-tenant device-ms sums to the measured wall
                    for r in take:
                        _tenant.account(
                            r.tenant,
                            device_ms=dev_ms * (r.rows / max(total, 1)),
                            latency_ms=(now - r.t_enq) * 1e3)
                self.stats.note_done(
                    len(take), [(now - r.t_enq) * 1e3 for r in take])
            batch_ms = (now - t0) * 1e3
            with self._cv:
                self._inflight_batches -= 1
                e = self._ewma_batch_ms
                self._ewma_batch_ms = (batch_ms if e is None
                                       else 0.8 * e + 0.2 * batch_ms)
                self._cv.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every accepted request has been answered (the
        hot-swap retire gate).  Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._q or self._rows_queued or self._inflight_batches \
                    or self._done_q:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.2))
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting, answer what was accepted, join the threads."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        with self._done_cv:
            self._done_cv.notify_all()
        self._sched.join(timeout=timeout)
        self._completer.join(timeout=timeout)
        _capacity.unregister(f"serving.{self.stats.model}")
        if self._mem_pool is not None:
            _memory.unregister(self._mem_pool)

    def queue_rows(self) -> int:
        with self._cv:
            return self._rows_queued


__all__ = ["BatcherStats", "BucketLadder", "Draining", "DynamicBatcher",
           "Overloaded", "RequestTooLong", "SERVING_PHASES"]
