"""Profiler: host-side spans + device tracing + Chrome-trace export.

The port of ``paddle_tpu/profiler.py``.  Reference:
``paddle/fluid/platform/profiler.h:73`` (RAII RecordEvent/RecordBlock),
``profiler.py:221`` context managers, ``device_tracer.h`` (CUPTI device
records), ``tools/timeline.py`` Chrome-trace conversion.

Host spans are recorded here (same report shape).  Device tracing
starts a ``torch.profiler`` session (CPU activity, and CUDA activity
when a card is present: CUPTI kernel records) when a trace directory
was armed with :func:`enable_device_trace`; ``stop_profiler`` writes its
Chrome trace there as ``device_trace.json``.  ``chrome_trace`` emits
the catapult JSON of the host spans directly.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

_state = {"enabled": False, "tracer_dir": None, "session": None}
_events: List[dict] = []
_lock = threading.Lock()

# thread ident → small stable lane id.  ``threading.get_ident() % N``
# could alias two threads into one Chrome-trace lane (idents are reused
# addresses); lanes are assigned densely in first-seen order instead and
# remembered with the thread's name for ``thread_name`` metadata.  The
# OS recycles idents after a thread exits, so a recycled ident whose
# CURRENT thread name differs gets a fresh lane (otherwise short-lived
# workers would inherit a dead thread's lane and its stale label — the
# exact aliasing class the dense mapping exists to fix); both tables are
# bounded (telemetry only: a clear just re-derives lanes on next use).
_lanes: Dict[int, tuple] = {}      # ident -> (lane, thread name)
_lane_names: Dict[int, str] = {}   # lane -> name
_next_lane = 0
_LANE_BOUND = 1024


def is_profiler_enabled() -> bool:
    return _state["enabled"]


def _thread_lane_locked() -> int:
    global _next_lane
    ident = threading.get_ident()
    name = threading.current_thread().name or ""
    ent = _lanes.get(ident)
    if ent is not None and ent[1] == name:
        return ent[0]
    if len(_lane_names) > _LANE_BOUND:
        _lanes.clear()
        _lane_names.clear()
    lane = _next_lane
    _next_lane += 1
    _lanes[ident] = (lane, name)
    _lane_names[lane] = name or f"thread-{lane}"
    return lane


def thread_lane() -> int:
    """This thread's stable lane id (shared with the distributed-trace
    spans so both streams agree on ``tid``)."""
    with _lock:
        return _thread_lane_locked()


def lane_names() -> Dict[int, str]:
    """{lane id: thread name} for ``ph:"M"`` thread_name metadata."""
    with _lock:
        return dict(_lane_names)


def _emit(name: str, t0_ns: int, t1_ns: int, cat: str = "op") -> None:
    """Append one completed span to the event stream.  Internal: the
    runtime telemetry layer (observability/trace.py) reuses it to file
    ``runtime::`` spans alongside user spans."""
    with _lock:
        _events.append({
            "name": name,
            "cat": cat,
            "ts": t0_ns / 1000.0,
            "dur": (t1_ns - t0_ns) / 1000.0,
            "tid": _thread_lane_locked(),
        })


class RecordEvent:
    """RAII span (profiler.h:73).  Usable as context manager or decorator:

        with RecordEvent("step"): ...

        @RecordEvent("step")
        def step(...): ...

    The decorator opens a FRESH span per call (never the shared instance
    state), so decorated functions are re-entrant and thread-safe.
    """

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def __enter__(self):
        if _state["enabled"]:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        if self._t0 is not None:
            _emit(self.name, self._t0, time.perf_counter_ns())
            self._t0 = None
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)
        return wrapper


record_event = RecordEvent  # snake_case alias


def _device_activities(state: str) -> list:
    from torch.profiler import ProfilerActivity
    acts = []
    if state in ("CPU", "All"):
        acts.append(ProfilerActivity.CPU)
    if state in ("GPU", "All") and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts or [ProfilerActivity.CPU]


def start_profiler(state: str = "All", tracer_option=None) -> None:
    """state ∈ {CPU, GPU, All}: which activities a device-trace session
    records; the session starts only when a trace dir was armed."""
    _state["enabled"] = True
    if _state["tracer_dir"] and _state["session"] is None:
        sess = torch.profiler.profile(activities=_device_activities(state))
        sess.__enter__()
        _state["session"] = sess


def stop_profiler(sorted_key: Optional[str] = "total",
                  profile_path: Optional[str] = None) -> None:
    _state["enabled"] = False
    sess = _state["session"]
    if sess is not None:
        _state["session"] = None
        sess.__exit__(None, None, None)
        os.makedirs(_state["tracer_dir"], exist_ok=True)
        sess.export_chrome_trace(
            os.path.join(_state["tracer_dir"], "device_trace.json"))
    _state["tracer_dir"] = None
    if profile_path:
        chrome_trace(profile_path)
    print_summary(sorted_key)


def enable_device_trace(logdir: str) -> None:
    """Arm a ``torch.profiler`` device trace for the next
    start_profiler; its Chrome trace lands in ``logdir``."""
    _state["tracer_dir"] = logdir


def reset_profiler() -> None:
    with _lock:
        _events.clear()


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None):
    """with profiler.profiler(...): ... (reference profiler.py:221)."""
    reset_profiler()
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def events() -> List[dict]:
    with _lock:
        return list(_events)


def print_summary(sorted_key: str = "total") -> None:
    agg = defaultdict(lambda: {"calls": 0, "total": 0.0, "max": 0.0})
    with _lock:
        for e in _events:
            a = agg[e["name"]]
            a["calls"] += 1
            a["total"] += e["dur"]
            a["max"] = max(a["max"], e["dur"])
    if not agg:
        return
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total"])
    if sorted_key == "calls":
        rows = sorted(agg.items(), key=lambda kv: -kv[1]["calls"])
    width = max(len(n) for n, _ in rows)
    print(f"{'Event':<{width}}  {'Calls':>8} {'Total(us)':>12} "
          f"{'Avg(us)':>12} {'Max(us)':>12}")
    for name, a in rows:
        print(f"{name:<{width}}  {a['calls']:>8} {a['total']:>12.1f} "
              f"{a['total'] / a['calls']:>12.1f} {a['max']:>12.1f}")


def chrome_trace(path: str) -> None:
    """Write catapult trace-event JSON (tools/timeline.py output format).

    Includes ``ph:"M"`` ``process_name``/``thread_name`` metadata so
    Perfetto labels the process row and every thread lane instead of
    showing bare numeric ids."""
    pid = os.getpid()
    with _lock:
        events = [
            {"name": e["name"], "cat": e.get("cat", "op"), "ph": "X",
             "pid": pid, "tid": e["tid"], "ts": e["ts"], "dur": e["dur"]}
            for e in _events
        ]
        names = dict(_lane_names)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"paddle_tpu_torch (pid {pid})"}}]
    for lane in sorted(names):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": lane, "args": {"name": names[lane]}})
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events}, f)


def cuda_profiler(*a, **kw):
    """The reference's ``cuda_profiler``: a cudaProfilerStart/Stop range
    (an external profiler's capture window) on a card, else a no-op."""
    if torch.cuda.is_available():
        return torch.cuda.profiler.profile()
    return contextlib.nullcontext()
