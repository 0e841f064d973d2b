"""Observability of the PyTorch port.

- :mod:`stats` — the metrics registry (counters, gauges, histograms);
- :mod:`phase` — per-request latency-phase attribution
  (``FLAGS_phase_attribution``);
- :mod:`tenant` — per-tenant usage metering (``FLAGS_tenant_accounting``);
- :mod:`capacity` — phase-level utilization and capacity modeling
  (``FLAGS_capacity_attribution``);
- :mod:`memory` — the MemoryLedger: per-pool device-memory attribution,
  the allocation event ring, the leak sentinel and OOM forensics
  (``FLAGS_memory_attribution``);
- :mod:`trace` — runtime spans and distributed trace contexts;
- :mod:`flight` — the crash flight recorder;
- :mod:`audit` — the cross-replica divergence sentinel's stream hashes;
- :mod:`step_stats` — per-run step records (the flight recorder's tail).

All but ``memory`` are copies of the reference's modules; ``memory``
reconciles against ``torch.cuda.memory_stats`` (its module doc).
"""
from . import stats  # noqa: F401
