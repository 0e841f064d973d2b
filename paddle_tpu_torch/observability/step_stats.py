"""Per-``Executor.run`` step records in a bounded ring buffer.

The port's copy of ``paddle_tpu/observability/step_stats.py``.

Each run of the lower→jit→cache pipeline appends one :class:`StepStats`:
which executable served it (``program_key``), whether the compile cache
hit, where the time went (lowering vs first-call XLA compile vs total
wall), and how many bytes crossed the host↔device boundary.  A recompile
storm, a feed-transfer bottleneck, or a silently-degrading benchmark run
shows up here as data instead of as a mystery (BENCH_r0*.json motivated
this: runs degraded to skipped/zero metrics with no signal why).

The buffer is process-wide and bounded (``maxlen`` ring), so it is safe
to leave recording on in serving processes; ``summary()`` gives
percentile aggregates and ``last_n()`` the raw tail.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from .stats import percentile_sorted


def approx_nbytes(v) -> int:
    """Bytes of a host/device array from metadata only — never syncs.

    Works for numpy, torch tensors, SelectedRows (rows+values) and
    anything else exposing nbytes or shape+dtype; returns 0 for unsized
    values.
    """
    try:
        if hasattr(v, "element_size") and hasattr(v, "numel"):
            return int(v.numel()) * int(v.element_size())   # a tensor
        sz = getattr(v, "size", None)  # numpy + jax fast path (metadata;
        dt = getattr(v, "dtype", None)  # jax .nbytes is ~6x slower)
        if sz is not None and dt is not None:
            return int(sz) * dt.itemsize
        rows = getattr(v, "rows", None)
        values = getattr(v, "values", None)
        if rows is not None and values is not None:  # SelectedRows pytree
            return approx_nbytes(rows) + approx_nbytes(values)
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is None or dtype is None:
            return 0
        import numpy as np
        n = 1
        for d in shape:
            n *= int(d)
        return n * np.dtype(dtype).itemsize
    except Exception:
        return 0


@dataclass
class StepStats:
    """One ``Executor.run`` (or ``run_steps`` dispatch) worth of telemetry."""

    program_key: str        # short id of the executable-cache key
    cache_hit: bool
    lowering_ms: float = 0.0   # analyze_block + build_block_fn (miss only)
    compile_ms: float = 0.0    # first jitted call: trace + XLA compile
    feed_bytes: int = 0        # host→device feed payload
    fetch_bytes: int = 0       # device→host fetch payload (metadata-sized)
    sync_ms: float = 0.0       # explicit device sync inside run (if any)
    wall_ms: float = 0.0       # whole run() wall time
    ts: float = field(default_factory=time.time)
    # model-health scalars registered via Program.step_stat_vars and
    # fetched this step (e.g. switch_moe's aux loss / dropped-token
    # fraction) — EP/MoE health lands in /stepz next to the step timing
    extras: Optional[Dict[str, float]] = None

    def to_dict(self) -> dict:
        return asdict(self)


# the shared raw-sample percentile (observability/stats.py): /servingz,
# /decodez and these summaries must agree on small windows
_percentile = percentile_sorted


class StepStatsRecorder:
    """Bounded ring of StepStats + aggregate summaries (thread-safe)."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._total_recorded = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def record(self, ss: StepStats) -> None:
        with self._lock:
            self._ring.append(ss)
            self._total_recorded += 1

    def last_n(self, n: int) -> List[StepStats]:
        with self._lock:
            if n <= 0:
                return []
            return list(self._ring)[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_recorded(self) -> int:
        """Lifetime count, including entries the ring has dropped."""
        with self._lock:
            return self._total_recorded

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._total_recorded = 0

    def summary(self) -> Dict[str, object]:
        """Aggregates over the retained window (NOT lifetime): hit rate,
        wall-time percentiles, compile/transfer totals."""
        with self._lock:
            steps = list(self._ring)
            total = self._total_recorded
        hits = sum(1 for s in steps if s.cache_hit)
        walls = sorted(s.wall_ms for s in steps)
        out: Dict[str, object] = {
            "window": len(steps),
            "total_recorded": total,
            "cache_hits": hits,
            "cache_misses": len(steps) - hits,
            "hit_rate": round(hits / len(steps), 4) if steps else 0.0,
            "compile_ms_total": round(sum(s.compile_ms for s in steps), 3),
            "lowering_ms_total": round(sum(s.lowering_ms for s in steps), 3),
            "feed_bytes_total": sum(s.feed_bytes for s in steps),
            "fetch_bytes_total": sum(s.fetch_bytes for s in steps),
        }
        out["wall_ms"] = {
            "p50": round(_percentile(walls, 0.50), 3),
            "p90": round(_percentile(walls, 0.90), 3),
            "p99": round(_percentile(walls, 0.99), 3),
            "mean": round(sum(walls) / len(walls), 3) if walls else 0.0,
            "max": round(walls[-1], 3) if walls else 0.0,
        }
        return out

    def export(self, tail: int = 32) -> Dict[str, object]:
        """summary + the raw last-``tail`` records, JSON-ready."""
        return {"summary": self.summary(),
                "last": [s.to_dict() for s in self.last_n(tail)]}


_recorder = StepStatsRecorder()


def recorder() -> StepStatsRecorder:
    return _recorder


def record(ss: StepStats) -> None:
    _recorder.record(ss)


def last_n(n: int) -> List[StepStats]:
    return _recorder.last_n(n)


def summary() -> Dict[str, object]:
    return _recorder.summary()


def clear() -> None:
    _recorder.clear()
