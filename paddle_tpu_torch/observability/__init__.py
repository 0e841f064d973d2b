"""Observability of the PyTorch port.

The reference's runtime telemetry (``paddle_tpu/observability``).  All
modules but ``memory``, ``perf`` and ``runlog`` are copies of the
reference's; ``memory`` reconciles against ``torch.cuda.memory_stats``,
``perf`` prices each plan by a cost walk over its ops' shapes in place
of XLA's cost analysis, and ``runlog`` waits on CUDA events for raw
tensor fetches (their module docs).

- :mod:`stats` — the metrics registry (counters, gauges, histograms);
- :mod:`step_stats` — per-run step records (the flight recorder's tail);
- :mod:`trace` — runtime spans and distributed trace contexts;
- :mod:`flight` — the crash flight recorder;
- :mod:`perf` — the perf attribution plane (``FLAGS_perf_attribution``):
  per-plan cost/memory records, roofline positions against the card's
  peaks, live device-memory gauges; served on ``/profilez`` + ``/memz``;
- :mod:`runlog` — the append-only JSONL per-step scalar log
  (``FLAGS_run_log_dir``); ``tools/runlog_report.py`` renders/compares;
- :mod:`phase` — per-request latency-phase attribution
  (``FLAGS_phase_attribution``);
- :mod:`history` — metric history rings
  (``FLAGS_metrics_history_interval_s``), served on ``/varz``;
- :mod:`capacity` — phase-level utilization and capacity modeling
  (``FLAGS_capacity_attribution``);
- :mod:`tenant` — per-tenant usage metering (``FLAGS_tenant_accounting``);
- :mod:`memory` — the MemoryLedger: per-pool device-memory attribution,
  the allocation event ring, the leak sentinel and OOM forensics
  (``FLAGS_memory_attribution``);
- :mod:`slo` — the declarative SLO watchdog (``FLAGS_slo_rules``);
- :mod:`canary` — the golden canary prober (``FLAGS_canary_probe``);
- :mod:`audit` — the cross-replica divergence sentinel's stream hashes;
- :mod:`debug_server` — the opt-in (``FLAGS_debug_server_port``) HTTP
  daemon: ``/metrics`` ``/healthz`` ``/statusz`` ``/stepz`` ``/memz``
  ``/profilez`` ``/servingz`` ``/decodez`` ``/quantz`` and the rest;
- :mod:`health` — heartbeat-driven worker liveness
  (HEALTHY/SUSPECT/DEAD), fed by the discovery registry's TTL leases;
- :mod:`aggregate` — STATS_PULL RPC and the cross-worker merge into
  per-worker-labeled ``fleet:*`` series.

Everything is gated by ``FLAGS_runtime_stats``; spans additionally
require the profiler to be armed.
"""
from __future__ import annotations

from . import (  # noqa: F401
    aggregate,
    audit,
    canary,
    capacity,
    debug_server,
    flight,
    health,
    history,
    memory,
    perf,
    phase,
    runlog,
    slo,
    stats,
    step_stats,
    tenant,
    trace,
)
from .aggregate import FleetAggregator  # noqa: F401
from .health import HealthTable  # noqa: F401
from .stats import (  # noqa: F401
    StatsRegistry,
    default_registry,
    snapshot,
    to_prometheus_text,
)
from .step_stats import StepStats, StepStatsRecorder  # noqa: F401
from .trace import SpanContext, start_span, stitch_chrome_trace  # noqa: F401


def enabled() -> bool:
    """Is runtime telemetry collection on (``FLAGS_runtime_stats``)?"""
    return trace.flags_on()


def export(step_tail: int = 32) -> dict:
    """One JSON-ready bundle: metrics snapshot + step-stats summary/tail,
    the shape the debug server serves on ``/stepz``."""
    return {"stats": stats.to_dict(),
            "step_stats": step_stats.recorder().export(tail=step_tail)}


def reset() -> None:
    """Zero all metrics and drop the step ring."""
    stats.reset()
    step_stats.clear()
