"""Run-scalar log: append-only JSONL of per-step training scalars.

The port's copy of ``paddle_tpu/observability/runlog.py``.  Two things
differ: a value still computing on the card is a ``LazyFetch`` (the
same ``_done``/``_np``/``_err`` slots as the reference's) or a raw
tensor from ``run(return_numpy=False)``, whose record carries the
``torch.cuda.Event`` the executor recorded after the step (its
non-blocking ``query()`` stands for ``jax.Array.is_ready()``); and a
tensor is read to the host through ``.cpu()``.

The print-as-you-train convergence record, made durable (reference:
``benchmark/fluid/fluid_benchmark.py:295`` printed loss/elapsed per
step to stdout; here every ``Executor.run``/``run_steps`` appends one
JSON object per step to a log file instead, so convergence curves
survive the process and two runs can be diffed):

    {"step": 12, "ts": 1754..., "step_ms": 8.3, "samples_per_sec": 7700,
     "scalars": {"mean_0.tmp_0": 2.1409}, "grad_global_norm": 0.83}

- ``scalars`` holds every *scalar-shaped* fetch by name (loss, acc, lr
  if fetched); fetched ``*@GRAD`` vars additionally fold into
  ``grad_global_norm``.  Deferred (LazyFetch) fetches are never forced:
  a record whose values are still on device is QUEUED and written when
  they materialize (the user's first read flushes all pending fetches
  in one batched copy, so the queue drains on the next step's
  append), when the bounded queue overflows, or at ``flush()``/
  ``close()``/interpreter exit — async-fetch pipelining keeps its one
  round trip per read, not one per logged step.
- ``run_steps`` (K steps per dispatch) emits K records, one per scanned
  step, with per-step scalars sliced from the stacked fetches.
- Rotation is atomic and size-capped (``FLAGS_run_log_max_mb``): when
  an append would exceed the cap the generation chain shifts
  (``<name>.1`` newest … ``.8`` oldest, older ages out) and a fresh
  file starts — a reader never sees a torn line, and a long run keeps
  its whole convergence history up to 8 × the cap.
- :meth:`RunLog.watch` tails the log (rotation-aware) for live
  dashboards/tests; ``tools/runlog_report.py`` renders summaries and
  compares two runs offline.

Strictly opt-in: ``FLAGS_run_log_dir`` empty (default) means
:func:`enabled` is one flag read and the executor does zero extra work
and zero I/O.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

from ..core import flags as _flags


def enabled() -> bool:
    try:
        return bool(_flags.get_flags("run_log_dir"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


# deferred-record queue bound, just past LazyFetch._MAX_PENDING (512):
# the executor's own flush backstop guarantees fetches queued this deep
# have materialized, so hitting the cap (which forces a device sync on
# the head entry) takes a pathological never-read-anything loop
_DEFERRED_CAP = 576


def _is_deferred(v) -> bool:
    """Is ``v`` a fetch value still computing on device?  Reading it
    now would BLOCK on the step the async fetch path exists to
    overlap.  Two shapes: LazyFetch wrappers (duck-typed on the
    materialized/_err slots — executor imports runlog, not vice versa)
    and values with a non-blocking ``is_ready()``.  A raw card tensor
    has none: its record carries the step's event instead
    (:func:`_entry_pending`).  Sync-free either way."""
    ev = getattr(v, "_done", None)
    if ev is not None:
        return (getattr(v, "_np", None) is None
                and getattr(v, "_err", None) is None
                and not ev.is_set())
    is_ready = getattr(v, "is_ready", None)
    if callable(is_ready):
        try:
            return not is_ready()
        except Exception:
            return False
    return False


def _entry_pending(entry) -> bool:
    """Is any value of a queued entry still on the device?  The 7th
    element, when present, is the event the executor recorded after the
    step that made the entry's raw tensors (``torch.cuda.Event``)."""
    ready = entry[6] if len(entry) > 6 else None
    if ready is not None:
        try:
            if not ready.query():
                return True
        except Exception:
            pass
    return any(_is_deferred(v) for v in entry[2])


def _host(v):
    """``v`` as a host array: a tensor through ``.cpu()`` (bfloat16 as
    float32, which holds it exactly), anything else ``np.asarray``."""
    import numpy as np
    if hasattr(v, "detach") and hasattr(v, "cpu"):
        t = v.detach().cpu()
        if str(t.dtype) == "torch.bfloat16":
            t = t.float()
        return t.numpy()
    return np.asarray(v)


class RunLog:
    """One append-only JSONL scalar log with atomic size-capped rotation."""

    def __init__(self, path: str, max_bytes: int = 64 << 20):
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._f = None
        self._size = 0
        self._step = 0
        # records whose fetch values are still on device (LazyFetch):
        # written in order once they materialize — see defer()/drain()
        self._dlock = threading.Lock()
        self._deferred: deque = deque()

    def _open(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = self._f.tell()

    def log(self, record: Dict[str, object]) -> None:
        """Append one record (adds ``step``/``ts`` when absent); rotates
        first when the append would exceed the cap."""
        line = None
        with self._lock:
            self._step += 1
            rec = {"step": record.get("step", self._step),
                   "ts": record.get("ts", time.time())}
            rec.update({k: v for k, v in record.items()
                        if k not in ("step", "ts")})
            line = json.dumps(rec) + "\n"
            nbytes = len(line.encode("utf-8"))  # _size is file BYTES
            if self._f is None:
                self._open()
            if self.max_bytes and self._size and \
                    self._size + nbytes > self.max_bytes:
                self._rotate_locked()
            self._f.write(line)
            self._f.flush()
            self._size += nbytes

    # rotated generations kept per log (<name>.1 newest .. .8 oldest):
    # the whole convergence history survives up to 8 x max_bytes, then
    # the oldest generation ages out — never silently just-one-file
    KEEP_ROTATIONS = 8

    def _rotate_locked(self) -> None:
        self._f.close()
        for k in range(self.KEEP_ROTATIONS, 1, -1):  # shift .7→.8, ...
            older = f"{self.path}.{k - 1}"
            if os.path.exists(older):
                os.replace(older, f"{self.path}.{k}")
        os.replace(self.path, self.path + ".1")  # atomic; no torn lines
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def defer(self, entry) -> None:
        """Queue one executor run's fetch entry (see :func:`log_run` /
        :func:`log_run_steps` for the shapes), then write every queued
        record whose values have since materialized.  Entries never
        block on the device except past the queue cap."""
        with self._dlock:
            self._deferred.append(entry)
        self.drain()

    def drain(self, force: bool = False) -> None:
        """Write queued records, oldest first, stopping at the first
        whose values are still on device.  ``force`` materializes them
        instead (one batched flush — the head read resolves every
        pending fetch): close()/flush()/cap-overflow paths."""
        while True:
            with self._dlock:
                if not self._deferred:
                    return
                entry = self._deferred[0]
                if not force and len(self._deferred) <= _DEFERRED_CAP \
                        and _entry_pending(entry):
                    return
                self._deferred.popleft()
            try:
                self._write_entry(entry)
            except OSError:
                pass

    def _write_entry(self, entry) -> None:
        kind, names, values, k, wall_ms, batch = entry[:6]
        if kind == "steps":
            self._write_steps(names, values, k, wall_ms, batch)
            return
        scalars, gsq, had_grads, unreadable = _scalars_of(names, values)
        rec: Dict[str, object] = {"scalars": scalars}
        if wall_ms is not None:
            rec["step_ms"] = round(wall_ms, 3)
            if batch and wall_ms > 0:
                rec["samples_per_sec"] = round(batch / (wall_ms / 1e3), 1)
        if had_grads:
            rec["grad_global_norm"] = round(gsq ** 0.5, 6)
        if unreadable:
            rec["unreadable_fetches"] = unreadable
        self.log(rec)

    def _write_steps(self, names, values, k: int,
                     wall_ms: Optional[float],
                     batch: Optional[int]) -> None:
        step_ms = (wall_ms / max(k, 1)) if wall_ms is not None else None
        # materialize only the stacked fetches that are per-step scalars
        # (plus @GRAD fetches, which fold into a per-step global norm)
        cols: Dict[str, object] = {}
        gsq = None
        unreadable = 0
        for name, v in zip(names, values):
            shape = getattr(v, "shape", None)
            if shape is None or len(shape) < 1 or int(shape[0]) != k:
                continue
            if name.endswith("@GRAD"):
                try:
                    a = _host(v).astype("float64",
                                        copy=False).reshape(k, -1)
                    g = (a * a).sum(axis=1)
                    gsq = g if gsq is None else gsq + g
                except Exception:
                    unreadable += 1  # stamped below: loss never silent
                continue
            n = 1
            for dim in shape[1:]:
                n *= int(dim)
            if n != 1:
                continue
            try:
                cols[name] = _host(v).reshape(k)
            except Exception:
                unreadable += 1
                continue
        for i in range(k):
            rec: Dict[str, object] = {
                "scalars": {name: float(col[i])
                            for name, col in cols.items()}}
            if step_ms is not None:
                rec["step_ms"] = round(step_ms, 3)
                if batch and step_ms > 0:
                    rec["samples_per_sec"] = round(
                        batch / (step_ms / 1e3), 1)
            if gsq is not None:
                rec["grad_global_norm"] = round(float(gsq[i]) ** 0.5, 6)
            if unreadable:
                rec["unreadable_fetches"] = unreadable
            rec["k_steps"] = k
            self.log(rec)

    def close(self) -> None:
        self.drain(force=True)
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # -- reading ----------------------------------------------------------
    @staticmethod
    def read(path: str) -> List[dict]:
        """Parse one JSONL file; a torn final line (live writer racing a
        reader at rotation) is skipped, not fatal."""
        out = []
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            pass
        return out

    def watch(self, poll_interval: float = 0.1,
              timeout: Optional[float] = None,
              from_start: bool = True) -> Iterator[dict]:
        """Tail the log: yield each appended record as it lands.
        Rotation-aware: on an inode change the unread tail of the
        generation the watcher was on (found by inode under
        ``<path>.1..``) and every newer generation are yielded before
        restarting on the fresh file.  Best-effort under pathological
        churn — a generation that ages past the chain (more than
        ``KEEP_ROTATIONS`` rotations within one poll) is gone.
        ``timeout`` bounds the wait for the NEXT record — the generator
        returns after that much inactivity (None = tail forever)."""
        def _stat():
            try:
                st = os.stat(self.path)
                return st.st_size, st.st_ino
            except OSError:
                return 0, None

        def _read_from(p, start):
            try:
                with open(p, encoding="utf-8") as f:
                    f.seek(start)
                    return f.read()
            except OSError:
                return ""

        def _parse_lines(chunk):
            for line in chunk.split("\n"):
                if not line.strip():
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue

        size0, ino = _stat()
        pos = 0 if from_start else size0
        buf = ""
        last_new = time.monotonic()
        while True:
            size, cur_ino = _stat()
            if cur_ino != ino or size < pos:
                # rotated under us (the inode catches it even when the
                # fresh file already grew past our old offset within
                # one poll).  Before restarting on the new file, yield
                # the unread tail of the generation we were on — find
                # it by inode among <path>.1.. — plus any generations
                # rotated in above it, or those records vanish from
                # the tail silently
                rotated = []
                if ino is not None and cur_ino is not None:
                    old_gen = None
                    for k in range(1, self.KEEP_ROTATIONS + 1):
                        try:
                            if os.stat(f"{self.path}.{k}").st_ino == ino:
                                old_gen = k
                                break
                        except OSError:
                            continue
                    if old_gen is not None:
                        for k in range(old_gen, 0, -1):  # oldest first
                            start = pos if k == old_gen else 0
                            rotated.append(
                                _read_from(f"{self.path}.{k}", start))
                for rec in _parse_lines(buf + "".join(rotated)):
                    last_new = time.monotonic()
                    yield rec
                pos, buf, ino = 0, "", cur_ino
            if size > pos:
                with open(self.path, encoding="utf-8") as f:
                    f.seek(pos)
                    chunk = f.read()
                pos += len(chunk.encode("utf-8"))
                buf += chunk
                while "\n" in buf:
                    line, buf = buf.split("\n", 1)
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    last_new = time.monotonic()
                    yield rec
            if timeout is not None and \
                    time.monotonic() - last_new > timeout:
                return
            time.sleep(poll_interval)


# -- the executor-facing default log ----------------------------------------

_lock = threading.Lock()
_default_log: Optional[RunLog] = None
_default_dir: Optional[str] = None
_atexit_armed = False


def default_log() -> Optional[RunLog]:
    """The process-wide log under ``FLAGS_run_log_dir`` (file
    ``run_<pid>.jsonl``), re-created if the flag is re-pointed (tests);
    None when the flag is unset."""
    global _default_log, _default_dir, _atexit_armed
    if not enabled():
        return None
    d = str(_flags.get_flags("run_log_dir"))
    stale = None
    with _lock:
        if _default_log is None or _default_dir != d:
            stale = _default_log
            try:
                max_mb = int(_flags.get_flags("run_log_max_mb"))
            except KeyError:  # pragma: no cover
                max_mb = 64
            _default_log = RunLog(
                os.path.join(d, f"run_{os.getpid()}.jsonl"),
                max_bytes=max_mb << 20)
            _default_dir = d
            if not _atexit_armed:
                import atexit
                atexit.register(flush)  # the tail of a never-read run
                _atexit_armed = True
        log = _default_log
    if stale is not None:
        stale.close()  # outside _lock: close() force-drains (device sync)
    return log


def reset() -> None:
    """Close + forget the default log (tests)."""
    global _default_log, _default_dir
    with _lock:
        log = _default_log
        _default_log, _default_dir = None, None
    if log is not None:
        log.close()


def _scalars_of(fetch_names, values):
    """(scalars dict, grad sum-of-squares, had_grads, unreadable) from
    one run's fetches.  Only scalar-shaped values are materialized
    (LazyFetch .shape is sync-free), except fetched @GRAD vars which
    fold into the global-norm accumulator.  ``unreadable`` counts
    values that raised on read (e.g. a deferred fetch whose buffer a
    later step overwrote before the drain) — callers stamp it on the
    record so the loss is visible in the log, never silent."""
    scalars: Dict[str, float] = {}
    gsq, had_grads, unreadable = 0.0, False, 0
    for name, v in zip(fetch_names, values):
        shape = getattr(v, "shape", None)
        if shape is None:
            continue
        n = 1
        for dim in shape:
            n *= int(dim)
        if name.endswith("@GRAD"):
            try:
                a = _host(v).astype("float64", copy=False)
                gsq += float((a * a).sum())
                had_grads = True
            except Exception:
                unreadable += 1
            continue
        if n != 1:
            continue
        try:
            f = float(_host(v).reshape(()))
        except Exception:
            unreadable += 1
            continue
        scalars[name] = f
    return scalars, gsq, had_grads, unreadable


def log_run(fetch_names, values, wall_ms: Optional[float] = None,
            batch: Optional[int] = None, ready=None) -> None:
    """One ``Executor.run`` worth of scalars into the default log.
    Deferred (LazyFetch) values, and raw tensors whose step's ``ready``
    event has not fired, queue the record instead of forcing a device
    sync; it writes when they materialize (see :meth:`RunLog.drain`).
    Never raises — the log must not take training down."""
    log = default_log()
    if log is None:
        return
    try:
        log.defer(("run", list(fetch_names), list(values), 1,
                   wall_ms, batch, ready))
    except OSError:
        pass


def log_run_steps(fetch_names, stacked_values, k: int,
                  wall_ms: Optional[float] = None,
                  batch: Optional[int] = None, ready=None) -> None:
    """K records from one ``run_steps`` dispatch: per-step scalars are
    sliced out of the stacked ``[K, ...]`` fetches; ``step_ms`` is the
    dispatch wall split evenly (the scan hides per-step boundaries)."""
    log = default_log()
    if log is None:
        return
    try:
        log.defer(("steps", list(fetch_names), list(stacked_values), k,
                   wall_ms, batch, ready))
    except OSError:
        pass


def flush() -> None:
    """Force-write every queued deferred record of the default log
    (materializing still-pending fetches).  Registered at interpreter
    exit so a run that never read its last fetches still logs them."""
    with _lock:
        log = _default_log
    if log is not None:
        log.drain(force=True)


def drain_pending() -> None:
    """Opportunistic non-forcing drain of the default log.  The
    executor calls this at the TOP of run/run_steps, before the next
    step writes the state in place: a raw fetch that aliases persistable
    state must land before the next step overwrites it (by then the
    previous step has typically completed, so this writes without
    blocking).  No-op when nothing is queued."""
    with _lock:
        log = _default_log
    if log is not None:
        log.drain()


def batch_of(feed_vals, axis: int = 0) -> Optional[int]:
    """Batch size for the throughput line: dim ``axis`` of the LARGEST
    feed (by bytes) — the batch-major input dominates the feed payload,
    so an aux scalar or small table sorting first can't win.  None when
    no feed has that axis (throughput is then omitted, not wrong)."""
    best, best_n = None, -1
    for a in feed_vals:
        shp = getattr(a, "shape", None)
        if not shp or len(shp) <= axis:
            continue
        n = getattr(a, "nbytes", 0) or 0
        if n > best_n:
            best, best_n = shp, n
    return int(best[axis]) if best is not None else None
