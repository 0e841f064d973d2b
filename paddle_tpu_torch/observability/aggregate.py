"""Cross-worker metric aggregation: STATS_PULL RPC + fleet merge.

The port's copy of ``paddle_tpu/observability/aggregate.py``.

The fan-in half of the observability plane: each worker's framed-TCP
``RPCServer`` (pserver, master, registry — any service) answers a
``STATS_PULL`` message with its registry's ``export_state()`` (served
centrally by ``transport._serve_io``, so service objects need no
changes).  Trainer 0 or the master runs a :class:`FleetAggregator`
over the worker endpoints and merges the per-process snapshots into
one fleet view:

- **counters** are summed into a fleet total AND kept as per-worker
  labeled series (``fleet:rpc_server_bytes_in{worker="trainer-1"}``);
- **gauges** stay per-worker labeled (summing queue depths across
  hosts is meaningless);
- **histograms** are bucket-merged (identical bucket layouts — the
  same code runs fleet-wide — so cumulative ``le`` counts, sums and
  totals add; on a layout mismatch the union of edges is summed).

The merged series are exposed under a ``fleet:`` name prefix so a
debug server can append them to its own ``/metrics`` without colliding
with the local (unprefixed) families.  Unreachable workers are skipped
and counted (``fleet.pull_errors``) — a partial fleet view beats none.
"""
from __future__ import annotations

import json
from typing import Dict, Mapping, Optional

from . import audit as _audit
from . import canary as _canary
from . import capacity as _capacity
from . import history as _history
from . import memory as _memory
from . import stats as _stats
from . import tenant as _tenant
from . import trace as _trace

# wire form version guard (payloads cross processes of possibly
# different builds during a rolling restart)
_WIRE_VERSION = 1


def local_snapshot_payload() -> bytes:
    """The STATS_PULL response body: this process's export_state(),
    plus the metric-history rings when that plane is armed
    (``FLAGS_metrics_history_interval_s`` — series carried as
    ``[[age_s, value], ...]``, ages not wall clocks, so skewed worker
    clocks cannot misalign the fleet merge).  Flag off: the payload is
    byte-identical to the pre-history wire."""
    state = _stats.export_state()
    state["version"] = _WIRE_VERSION
    hist = _history.export_history()
    if hist is not None:
        state["history"] = hist
    # saturation-anatomy riders (FLAGS_capacity_attribution /
    # FLAGS_tenant_accounting): same byte-identity discipline — the
    # key exists only when the plane is armed and has data
    cap = _capacity.export_state()
    if cap is not None:
        state["capacity"] = cap
    ten = _tenant.export_state()
    if ten is not None:
        state["tenants"] = ten
    # correctness-anatomy riders (FLAGS_canary_probe /
    # FLAGS_divergence_check): same discipline again
    can = _canary.export_state()
    if can is not None:
        state["canary"] = can
    aud = _audit.export_state()
    if aud is not None:
        state["audit"] = aud
    # memory-anatomy rider (FLAGS_memory_attribution): the full ledger
    # (pool snapshots + per-device reconciliation) rides the same pull
    mem = _memory.export_state()
    if mem is not None:
        state["memory"] = mem
    return json.dumps(state).encode("utf-8")


def parse_snapshot(payload: bytes) -> dict:
    state = json.loads(bytes(payload).decode("utf-8"))
    if state.get("version") != _WIRE_VERSION:
        raise ValueError(
            f"stats snapshot version {state.get('version')!r} != "
            f"{_WIRE_VERSION}")
    return state


def local_trace_payload() -> bytes:
    """The TRACE_PULL response body: this process's span-ring snapshot
    (``trace.local_trace_snapshot()`` — pid/role/host identity + spans),
    versioned like the stats payload."""
    return _trace.local_snapshot_payload()


def parse_trace_snapshot(payload: bytes) -> dict:
    snap = json.loads(bytes(payload).decode("utf-8"))
    if snap.get("version") != _trace._SNAPSHOT_VERSION:
        raise ValueError(
            f"trace snapshot version {snap.get('version')!r} != "
            f"{_trace._SNAPSHOT_VERSION}")
    return snap


def merge_snapshots(per_worker: Mapping[str, dict]) -> dict:
    """{worker: export_state()} → fleet merge (see module doc)."""
    counters: Dict[str, dict] = {}
    gauges: Dict[str, dict] = {}
    hists: Dict[str, dict] = {}
    # each process's constant labels (process_index/process_count from
    # multihost.py) ride along so per-worker fleet series stay
    # distinguishable even if two workers were given the same name
    worker_labels = {w: dict(per_worker[w].get("labels") or {})
                     for w in per_worker}
    # metric-history series stay PER WORKER (ages are relative to each
    # worker's own pull — summing or zipping across workers would
    # invent alignment the clocks never had)
    history: Dict[str, dict] = {}
    # capacity snapshots stay per-worker AND roll into a fleet view
    # (summed ceilings, min headroom); tenant tables merge into one
    # fleet-wide heavy-hitter table
    capacity_pw: Dict[str, dict] = {}
    tenants_pw: Dict[str, dict] = {}
    # correctness plane: canary streaks union fleet-wide, audit rings
    # feed the cross-worker divergence sentinel
    canary_pw: Dict[str, dict] = {}
    audit_pw: Dict[str, dict] = {}
    # memory ledgers stay per-worker AND roll into a fleet view
    # (pool bytes summed, unattributed residual kept per worker — a
    # summed residual would hide which host is leaking)
    memory_pw: Dict[str, dict] = {}
    for worker in sorted(per_worker):
        state = per_worker[worker]
        if isinstance(state.get("history"), dict):
            history[worker] = state["history"]
        if isinstance(state.get("capacity"), dict):
            capacity_pw[worker] = state["capacity"]
        if isinstance(state.get("tenants"), dict):
            tenants_pw[worker] = state["tenants"]
        if isinstance(state.get("canary"), dict):
            canary_pw[worker] = state["canary"]
        if isinstance(state.get("audit"), dict):
            audit_pw[worker] = state["audit"]
        if isinstance(state.get("memory"), dict):
            memory_pw[worker] = state["memory"]
        for name, m in state.get("metrics", {}).items():
            kind = m.get("kind")
            if kind == "counter":
                ent = counters.setdefault(name,
                                          {"total": 0, "per_worker": {}})
                ent["total"] += m["value"]
                ent["per_worker"][worker] = m["value"]
            elif kind == "gauge":
                ent = gauges.setdefault(name, {"per_worker": {}})
                ent["per_worker"][worker] = m["value"]
            elif kind == "histogram":
                ent = hists.setdefault(
                    name, {"buckets": {}, "sum": 0.0, "count": 0,
                           "per_worker_count": {}})
                for le, cum in m["buckets"].items():
                    ent["buckets"][le] = ent["buckets"].get(le, 0) + cum
                ent["sum"] += m["sum"]
                ent["count"] += m["count"]
                ent["per_worker_count"][worker] = m["count"]
    out = {"workers": sorted(per_worker), "worker_labels": worker_labels,
           "counters": counters, "gauges": gauges, "histograms": hists}
    if history:
        out["history"] = history
    if capacity_pw:
        out["capacity"] = {"per_worker": capacity_pw,
                           "fleet": _capacity.merge_states(capacity_pw)}
    if tenants_pw:
        out["tenants"] = _tenant.merge_states(tenants_pw)
    if canary_pw:
        out["canary"] = {"per_worker": canary_pw,
                         "fleet": _canary.merge_states(canary_pw)}
    if audit_pw:
        out["audit"] = _audit.merge_states(audit_pw)
    if memory_pw:
        out["memory"] = {"per_worker": memory_pw,
                         "fleet": _memory.merge_states(memory_pw)}
    return out


def _le_sort_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def fleet_prometheus_text(merged: dict) -> str:
    """Exposition text of a merge, families prefixed ``fleet:``."""
    wlabels = merged.get("worker_labels", {})

    def _labels(worker: str) -> str:
        return _stats.prom_labels({**wlabels.get(worker, {}),
                                   "worker": worker})

    lines = []
    for name, ent in sorted(merged["counters"].items()):
        pn = "fleet:" + _stats._prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_stats._prom_num(ent['total'])}")
        for worker, v in sorted(ent["per_worker"].items()):
            lines.append(pn + _labels(worker) + f" {_stats._prom_num(v)}")
    for name, ent in sorted(merged["gauges"].items()):
        pn = "fleet:" + _stats._prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        for worker, v in sorted(ent["per_worker"].items()):
            lines.append(pn + _labels(worker) + f" {_stats._prom_num(v)}")
    for name, ent in sorted(merged["histograms"].items()):
        pn = "fleet:" + _stats._prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        for le in sorted(ent["buckets"], key=_le_sort_key):
            lines.append(pn + f'_bucket{{le="{le}"}} {ent["buckets"][le]}')
        lines.append(f"{pn}_sum {_stats._prom_num(ent['sum'])}")
        lines.append(f"{pn}_count {ent['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


class FleetAggregator:
    """Pulls per-worker snapshots over STATS_PULL and merges them.

    ``workers`` maps a stable worker label (``trainer-0``, ``ps-1``) to
    the host:port of any RPCServer that worker runs.  ``pull()`` skips
    unreachable workers (counted, remembered in ``last_errors``) so a
    dead trainer never takes the fleet view down with it.
    """

    def __init__(self, workers: Mapping[str, str], trainer_id: int = 0,
                 connect_timeout: float = 2.0):
        self.workers: Dict[str, str] = dict(workers)
        self.last_errors: Dict[str, str] = {}
        self.connect_timeout = connect_timeout
        self._trainer_id = trainer_id
        self._client = None

    def _rpc(self):
        if self._client is None:
            from ..distributed import transport
            self._client = transport.RPCClient(self._trainer_id)
        return self._client

    def add_worker(self, name: str, endpoint: str) -> None:
        self.workers[name] = endpoint

    def remove_worker(self, name: str) -> None:
        self.workers.pop(name, None)
        self.last_errors.pop(name, None)

    def _pull_over_rpc(self, msg_type: int, parse, ok_counter: str,
                       err_counter: str) -> Dict[str, dict]:
        """Concurrent {worker: parse(payload)} fan-out for one of the
        centrally-served observability messages (STATS_PULL /
        TRACE_PULL): k unreachable workers cost ONE connect timeout,
        not k of them — /metrics with an aggregator attached must stay
        inside scrape deadlines."""
        from concurrent.futures import ThreadPoolExecutor
        from ..distributed import transport
        client = self._rpc()
        sc = _stats.scope("fleet")
        out: Dict[str, dict] = {}
        errors: Dict[str, str] = {}

        def one(item):
            worker, ep = item
            try:
                # fast-fail: a never-reachable worker costs ONE bounded
                # probe, not the request path's connect-retry loop (which
                # doubles the connect deadline per dead endpoint)
                if not transport.RPCClient._probe(
                        ep, min(1.0, self.connect_timeout)):
                    raise ConnectionError(f"no listener at {ep}")
                payload = client._raw_request(
                    ep, msg_type, connect_timeout=self.connect_timeout)
                out[worker] = parse(payload)
                sc.counter(ok_counter).inc()
            except Exception as e:
                sc.counter(err_counter).inc()
                errors[worker] = repr(e)[:200]

        items = sorted(self.workers.items())
        if items:
            with ThreadPoolExecutor(
                    max_workers=min(8, len(items)),
                    thread_name_prefix="fleet-pull") as pool:
                list(pool.map(one, items))
        self.last_errors = errors
        return out

    def pull(self) -> Dict[str, dict]:
        """{worker: export_state()} for every reachable worker."""
        from ..distributed import transport
        return self._pull_over_rpc(transport.STATS_PULL, parse_snapshot,
                                   "pulls", "pull_errors")

    def pull_traces(self) -> Dict[str, dict]:
        """{worker: trace snapshot} over TRACE_PULL for every reachable
        worker — the fleet half of trace stitching (unreachable workers
        are skipped and counted like metric pulls)."""
        from ..distributed import transport
        return self._pull_over_rpc(transport.TRACE_PULL,
                                   parse_trace_snapshot,
                                   "trace_pulls", "trace_pull_errors")

    def stitched_trace(self, include_self: Optional[str] = None) -> dict:
        """One Chrome/Perfetto JSON stitched from every reachable
        worker's span ring; ``include_self`` adds THIS process's ring
        under that label (trainer 0 usually wants its own spans in the
        picture)."""
        snaps = self.pull_traces()
        if include_self:
            snaps.setdefault(include_self, _trace.local_trace_snapshot())
        return _trace.stitch_chrome_trace(snaps)

    def merged(self) -> dict:
        return merge_snapshots(self.pull())

    def to_prometheus_text(self) -> str:
        return fleet_prometheus_text(self.merged())

    def export(self) -> dict:
        """JSON-ready merge + pull-error map (bench.py artifact form)."""
        merged = self.merged()
        merged["pull_errors"] = dict(self.last_errors)
        return merged
