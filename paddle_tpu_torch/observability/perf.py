"""Performance attribution plane: per-plan cost and memory records with
rooflines.

The port of ``paddle_tpu/observability/perf.py``.  The reference
harvests each compiled executable's XLA ``cost_analysis()`` and
``memory_analysis()``.  The port compiles nothing: it interprets the
planned ops one by one, and its hand-written kernels are called through
``ctypes``, where ``torch.utils.flop_counter`` cannot see them.  So a
record is made by a **cost walk**: the first pass of a freshly built
plan notes each top-level op's input and output shapes (metadata, no
device read; :func:`op_meta`), and :func:`cost_walk` prices each op
with one rule per op type, in XLA's conventions:

- 2 flops a multiply-add (``mul``, ``matmul``, ``conv2d``: 2·M·K·N);
- elementwise arithmetic 1 flop an output element, transcendentals
  (exp, log, tanh, sigmoid, ...) counted apart;
- ``bytes accessed``: each op's inputs read once and outputs written
  once, which is what the op-by-op interpreter moves;
- the ops that reach a kernel count the work of their bound formulas
  in ``PERF.md`` §6: ``fused_attention`` 4·D flops a (query, key) pair
  forward (K1) and 6·D + 8·D backward (K2 + K3), every pair of the
  shapes (causal: the lower triangle); ``lstm`` 2·H·4H a (row, step)
  and its grad three times that (K6/K7); ``gru`` 2·H·3H and 18·H²
  (K8a/K8b); an int8 ``mul`` 2·M·K·N (K5); the sparse optimizers their
  per-element update math (K10), ``lookup_table`` none (K9).

The walk prices one pass; a ``run_steps`` record covers K passes.  It
never runs the step again.  ``memory`` gives the argument bytes (feeds
+ state read), the output bytes (fetches + state written), the bytes
written in place (``alias_bytes``) and, on a card, the temp bytes: the
peak allocated across the first pass less the bytes live before it.

Each ``Executor.run`` feeds its wall time back into the record (its
roofline position against :func:`platform.platform_peaks`, the card's
dense bf16 peak and HBM rate).  :func:`sample_device_memory` reads
``torch.cuda.memory_stats`` and ``mem_get_info`` per card, plus host
RSS, into ``device_mem.*`` gauges.  Served by the debug server as
``/profilez`` and ``/memz`` (JSON, ``?text=1`` for text);
``tools/dump_metrics.py --profilez/--memz`` reads them.

Strictly opt-in: with ``FLAGS_perf_attribution`` unset the executor
makes one flag read per run and nothing else.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from . import debug_server as _debug_server
from . import stats as _stats
from ..core import flags as _flags

# bounded: a shape-churning process must not leak perf records
_RECORD_CAP = 256
# wall-time samples retained per record for the roofline summary
_WALL_WINDOW = 64

_lock = threading.Lock()
_records: "OrderedDict[str, PerfRecord]" = OrderedDict()
_seq = 0

_perf_metrics = None


def enabled() -> bool:
    """Is cost/memory attribution on (``FLAGS_perf_attribution``)?"""
    try:
        return bool(_flags.get_flags("perf_attribution"))
    except KeyError:  # pragma: no cover - flag always defined
        return False


def _pm():
    """Cached perf metric handles (same rationale as the executor's)."""
    global _perf_metrics
    m = _perf_metrics
    if m is None:
        sc = _stats.scope("perf")
        import types as _t
        m = _t.SimpleNamespace(
            executables=sc.counter(
                "executables", "plans harvested for cost/memory "
                "attribution"),
            harvest_errors=sc.counter("harvest_errors"),
            achieved_gflops=sc.gauge(
                "last_achieved_gflops",
                "achieved GFLOP/s of the most recently observed step"),
            achieved_gbps=sc.gauge(
                "last_achieved_gbps",
                "achieved HBM GB/s of the most recently observed step"),
            peak_frac=sc.gauge(
                "last_frac_of_peak_flops",
                "achieved/peak FLOP/s of the most recent step (0 when "
                "the platform peak is unknown)"),
        )
        _perf_metrics = m
    return m


# -- the cost walk -----------------------------------------------------------

def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _describe(v):
    """(shape, itemsize, extra bytes) of one environment value, from
    metadata only: a ``SelectedRows`` is its values' shape with its
    rows as the extra bytes; None for a value that is no tensor."""
    values = getattr(v, "values", None)
    if values is not None and getattr(v, "rows", None) is not None:
        shape, item, _ = _describe(values)
        rshape, ritem, _ = _describe(v.rows)
        return shape, item, _numel(rshape) * ritem
    if hasattr(v, "element_size") and hasattr(v, "shape"):
        return tuple(int(d) for d in v.shape), int(v.element_size()), 0
    return None


def op_meta(op, env) -> tuple:
    """One top-level op as the walk reads it: (type, attrs, inputs,
    outputs), each slot a list of (shape, itemsize, extra bytes) or
    None, read from the run's environment after the op ran (a shape
    and dtype read, never a device read)."""
    def side(slots):
        out = {}
        for slot, names in slots.items():
            out[slot] = [_describe(env[n]) if n in env else None
                         for n in names]
        return out
    return (op.type, op.attrs, side(op.inputs), side(op.outputs))


def _shape(side, slot, j=0):
    vals = side.get(slot) or ()
    return vals[j][0] if j < len(vals) and vals[j] is not None else None


def _bytes(side) -> int:
    return sum(_numel(m[0]) * m[1] + m[2]
               for vals in side.values() for m in vals if m is not None)


def _out_elems(outs) -> int:
    return sum(_numel(m[0]) for vals in outs.values() for m in vals
               if m is not None)


def _grad_outs(outs) -> List[tuple]:
    return [m[0] for slot, vals in outs.items() if slot.endswith("@GRAD")
            for m in vals if m is not None]


def _mul_mkn(attrs, ins):
    x, y = _shape(ins, "X"), _shape(ins, "Y")
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    return _numel(x[:xn]), _numel(x[xn:]), _numel(y[yn:])


def _matmul_k(attrs, ins) -> int:
    x = _shape(ins, "X")
    if len(x) == 1:
        return x[0]
    return x[-2] if attrs.get("transpose_X", False) else x[-1]


def _attn_pairs(attrs, ins) -> tuple:
    B, H, Tq, D = _shape(ins, "Q")
    Tk = _shape(ins, "K")[2]
    if attrs.get("causal", False) and Tq == Tk:
        return B * H * Tq * (Tq + 1) // 2, D
    return B * H * Tq * Tk, D


def _rnn_hlive(ins, gates) -> tuple:
    B, T, G = _shape(ins, "Input")
    return G // gates, B * T


# per-element math of the optimizer rules (the K10 update's, PERF.md §6;
# the dense rules count the same)
_UPDATE_FLOPS = {"sgd": 2, "momentum": 4, "adam": 14, "adagrad": 7}

# ops that move or index data: no arithmetic
_NO_FLOPS = frozenset((
    "reshape", "transpose", "concat", "slice", "squeeze", "unsqueeze",
    "expand", "gather", "lookup_table", "assign", "assign_value",
    "fill_constant", "fill_constant_batch_size_like", "uniform_random",
    "gaussian_random", "cast", "shape", "increment", "array_read",
    "array_write", "lod_reset", "sequence_pad", "sequence_unpad",
    "sequence_reverse", "sequence_slice", "sequence_concat",
    "sequence_expand", "sequence_expand_as", "sequence_enumerate",
    "sequence_reshape", "sequence_first_step", "sequence_last_step",
    "max_sequence_len", "sequence_mask", "arg_max"))

# transcendentals per element (XLA counts exp, log, tanh, logistic...)
_TRANSCENDENTAL = {"tanh": 1, "sigmoid": 1, "log": 1, "gelu": 1,
                   "sigmoid_cross_entropy_with_logits": 2}

# flops per input element of the normalizing and reducing ops
_PER_IN = {"softmax": 4, "layer_norm": 8, "batch_norm": 8,
           "softmax_with_cross_entropy": 5, "mean": 1, "reduce_sum": 1,
           "sequence_softmax": 4, "square_error_cost": 3, "top_k": 1,
           "accuracy": 1, "cross_entropy": 1, "sequence_pool": 1}
_EXP_PER_IN = frozenset(("softmax", "sequence_softmax",
                         "softmax_with_cross_entropy", "cross_entropy"))


def op_cost(meta) -> tuple:
    """(flops, transcendentals, bytes accessed) of one op (module doc)."""
    typ, attrs, ins, outs = meta
    nbytes = _bytes(ins) + _bytes(outs)
    grad = typ.endswith("_grad")
    base = typ[:-5] if grad else typ
    if base == "mul" or base == "fused_fc":
        M, K, N = _mul_mkn(attrs, ins)
        n = len(_grad_outs(outs)) if grad else 1
        extra = 0 if grad or base == "mul" else M * N   # bias
        return 2 * M * K * N * n + extra, 0, nbytes
    if base == "matmul":
        K = _matmul_k(attrs, ins)
        if grad:
            o = _shape(ins, "Out@GRAD") or _shape(ins, "Out")
            return 2 * _numel(o) * K * len(_grad_outs(outs)), 0, nbytes
        o = _shape(outs, "Out")
        return 2 * _numel(o) * K, 0, nbytes
    if base in ("conv2d", "depthwise_conv2d"):
        f = _shape(ins, "Filter")
        o = _shape(ins, "Output@GRAD") if grad else _shape(outs, "Output")
        n = len(_grad_outs(outs)) if grad else 1
        return 2 * _numel(o) * _numel(f[1:]) * n, 0, nbytes
    if base == "fused_attention":
        pairs, D = _attn_pairs(attrs, ins)
        if grad:
            return 14 * D * pairs, 2 * pairs, nbytes
        return 4 * D * pairs, pairs, nbytes
    if base in ("lstm", "gru"):
        gates = 4 if base == "lstm" else 3
        H, live = _rnn_hlive(ins, gates)
        if base == "lstm":
            f = (6 if grad else 2) * live * H * 4 * H
        else:
            f = (18 * live * H * H) if grad else 2 * live * H * 3 * H
        return f, (2 if grad else 1) * live * H * gates, nbytes
    if base in _UPDATE_FLOPS and not grad:
        g = (ins.get("Grad") or [None])[0]
        n = _numel(g[0]) if g is not None else _numel(_shape(ins, "Param"))
        return _UPDATE_FLOPS[base] * n, 0, nbytes
    if base in _NO_FLOPS:
        return 0, 0, nbytes
    if base in _PER_IN:
        # the reduced or normalized input's elements (a grad op: the
        # gradients it writes)
        n = _out_elems(outs) if grad else max(
            (_numel(m[0]) for vals in ins.values() for m in vals
             if m is not None), default=0)
        t = n if base in _EXP_PER_IN and not grad else 0
        return _PER_IN[base] * n, t, nbytes
    if base == "pool2d":
        k = attrs.get("ksize", (1, 1))
        area = _numel(k) if not attrs.get("global_pooling") else \
            _numel((_shape(ins, "X") or (1, 1, 1, 1))[2:])
        o = _shape(ins, "Out@GRAD") if grad else _shape(outs, "Out")
        return _numel(o) * area, 0, nbytes
    # elementwise arithmetic and activations: an output element a flop
    # (a grad op: each gradient it writes)
    n = _out_elems(outs)
    return n, _TRANSCENDENTAL.get(base, 0) * n, nbytes


def cost_walk(metas, steps: int = 1) -> dict:
    """The cost dict (XLA's key names) of one pass over ``metas``
    (:func:`op_meta` records), times ``steps``."""
    fl = tr = nb = 0
    for m in metas:
        f, t, b = op_cost(m)
        fl, tr, nb = fl + f, tr + t, nb + b
    return {"flops": float(fl * steps), "transcendentals": float(tr * steps),
            "bytes accessed": float(nb * steps)}


class PerfRecord:
    """Cost/memory attribution + live wall-time window for ONE plan
    (one executor-cache slot)."""

    __slots__ = ("key", "source", "mode", "flops", "bytes_accessed",
                 "transcendentals", "memory", "compile_ms", "steps",
                 "walls", "created_ts")

    def __init__(self, key: str, source: str, mode: str,
                 cost: dict, memory: dict,
                 compile_ms: Optional[float] = None):
        self.key = key
        self.source = source          # "compile" (a plan build)
        self.mode = mode              # "run" | "run_steps"
        self.flops = float(cost.get("flops", 0.0) or 0.0)
        self.bytes_accessed = float(cost.get("bytes accessed", 0.0) or 0.0)
        self.transcendentals = float(cost.get("transcendentals", 0.0) or 0.0)
        self.memory = dict(memory)
        self.compile_ms = compile_ms
        self.steps = 0
        self.walls: deque = deque(maxlen=_WALL_WINDOW)
        self.created_ts = time.time()

    def observe(self, wall_ms: float) -> None:
        # under the module lock: /profilez sorts the walls window from
        # the HTTP thread while the executor appends from the training
        # thread (deque iteration raises on concurrent mutation)
        with _lock:
            self.steps += 1
            self.walls.append(float(wall_ms))

    def wall_ms_p50(self) -> float:
        with _lock:
            w = sorted(self.walls)
        return w[len(w) // 2] if w else 0.0

    def summary(self, peaks: Optional[dict] = None) -> dict:
        wall = self.wall_ms_p50()  # once: one lock+sort, and the
        # reported p50 always matches the rates computed from it
        out = {
            "key": self.key,
            "source": self.source,
            "mode": self.mode,
            "steps": self.steps,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "memory": dict(self.memory),
            "compile_ms": self.compile_ms,
            "wall_ms_p50": round(wall, 3),
        }
        out.update(roofline_numbers(
            self.flops, self.bytes_accessed,
            wall / 1e3 if wall > 0 else None, peaks=peaks))
        return out


def roofline_numbers(flops: float, bytes_accessed: float,
                     seconds: Optional[float],
                     peaks: Optional[dict] = None) -> dict:
    """The shared roofline arithmetic: achieved rates from ``seconds``,
    arithmetic intensity, position vs the platform peak table.

    ``peaks`` defaults to ``platform.platform_peaks()``; pass
    ``{"flops": None}``-shaped dicts to skip the peak comparison.
    Per-step vs per-dispatch normalization cancels in the rates: a
    run_steps record's flops cover K steps, and so does its wall.
    """
    out: Dict[str, object] = {}
    if flops and bytes_accessed:
        out["intensity_flops_per_byte"] = round(flops / bytes_accessed, 3)
    if seconds and seconds > 0:
        if flops:
            out["achieved_gflops"] = round(flops / seconds / 1e9, 3)
        if bytes_accessed:
            out["achieved_gbps"] = round(bytes_accessed / seconds / 1e9, 3)
    if peaks is None:
        peaks = platform_peaks_cached()
    peak_fl = peaks.get("flops")
    peak_bw = peaks.get("hbm_bytes_per_s")
    if peak_fl and peak_bw:
        out["peak_gflops"] = round(peak_fl / 1e9, 1)
        out["peak_gbps"] = round(peak_bw / 1e9, 1)
        if peaks.get("nominal"):
            out["peaks_nominal"] = True
        if flops and bytes_accessed:
            balance = peak_fl / peak_bw  # machine balance, flops/byte
            out["machine_balance_flops_per_byte"] = round(balance, 3)
            out["bound"] = ("compute"
                            if flops / bytes_accessed >= balance
                            else "memory")
        if seconds and seconds > 0:
            frac_fl = flops / seconds / peak_fl if flops else 0.0
            frac_bw = (bytes_accessed / seconds / peak_bw
                       if bytes_accessed else 0.0)
            if flops:
                out["frac_of_peak_flops"] = round(frac_fl, 4)
            if bytes_accessed:
                out["frac_of_peak_hbm"] = round(frac_bw, 4)
            # position against the roofline ceiling: how close the
            # dominant axis is to its limit
            out["roofline_frac"] = round(max(frac_fl, frac_bw), 4)
    return out


_peaks_cache = None


def platform_peaks_cached() -> dict:
    """``platform.platform_peaks()`` memoized (the card never changes
    within a process)."""
    global _peaks_cache
    if _peaks_cache is None:
        try:
            from .. import platform as _platform
            _peaks_cache = _platform.platform_peaks()
        except Exception:  # pragma: no cover - CUDA runtime failure
            _peaks_cache = {"device_kind": "unknown", "platform": "unknown",
                            "flops": None, "hbm_bytes_per_s": None}
    return _peaks_cache


def harvest(analyze, source: str, mode: str,
            compile_ms: Optional[float] = None) -> Optional[PerfRecord]:
    """Build + register a :class:`PerfRecord` for a freshly built plan;
    ``analyze()`` returns its (cost dict, memory dict) (the executor's
    cost walk).  Never raises — attribution must never fail a run; a
    walk that fails is counted in ``perf.harvest_errors`` and skipped."""
    global _seq
    if not enabled():
        return None
    try:
        cost, memory = analyze()
    except Exception:
        _pm().harvest_errors.inc()
        return None
    with _lock:
        _seq += 1
        key = f"exe-{_seq}"
    rec = PerfRecord(key, source, mode, cost, memory, compile_ms=compile_ms)
    with _lock:
        _records[key] = rec
        while len(_records) > _RECORD_CAP:
            _records.popitem(last=False)
    _pm().executables.inc()
    return rec


def observe_step(rec: PerfRecord, program_key: str, wall_ms: float) -> None:
    """Feed one measured step wall time into a record (the executor's
    ``_record_step`` calls this with the StepStats wall).  The first
    observation renames the record to the plan's telemetry program_key
    so /profilez and the StepStats ring share an identity."""
    with _lock:
        if rec.key != program_key:
            _records.pop(rec.key, None)
            rec.key = program_key
        if _records.get(program_key) is not rec:
            # first observation renames in; an evicted-then-reobserved
            # record (its cache entry still holds it) re-enters here
            # regardless of key — a still-running plan must stay
            # visible on /profilez.  Re-enforce the table bound
            _records[program_key] = rec
            while len(_records) > _RECORD_CAP:
                _records.popitem(last=False)
    rec.observe(wall_ms)
    if wall_ms > 0:
        m = _pm()
        secs = wall_ms / 1e3
        m.achieved_gflops.set(round(rec.flops / secs / 1e9, 3))
        m.achieved_gbps.set(round(rec.bytes_accessed / secs / 1e9, 3))
        peaks = platform_peaks_cached()
        if peaks.get("flops"):
            m.peak_frac.set(round(rec.flops / secs / peaks["flops"], 4))


def records() -> List[PerfRecord]:
    with _lock:
        return list(_records.values())


def get_record(key: str) -> Optional[PerfRecord]:
    with _lock:
        return _records.get(key)


def reset() -> None:
    """Drop every record (tests / config isolation)."""
    with _lock:
        _records.clear()


def _host_rss_bytes() -> Optional[int]:
    try:
        import resource
        import sys
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * resource.getpagesize()
        except OSError:
            # non-Linux fallback: PEAK rss from getrusage — ru_maxrss
            # is bytes on macOS, kilobytes on Linux/BSD
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return peak if sys.platform == "darwin" else peak * 1024
    except Exception:  # pragma: no cover - exotic hosts
        return None


_MEM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
             "largest_free_block_bytes")


def _card_memory(i: int) -> dict:
    """The reference's per-device keys for card ``i``: the caching
    allocator's allocated bytes (current and peak), the card's total
    memory as the limit, and its free bytes (``mem_get_info``; the
    allocator reports no largest free block)."""
    import torch
    ms = torch.cuda.memory_stats(i)
    free, total = torch.cuda.mem_get_info(i)
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total), "largest_free_block_bytes": None,
            "free_bytes": int(free)}


def sample_device_memory(set_gauges: bool = True) -> dict:
    """Live device-memory snapshot: per card ``torch.cuda.memory_stats``
    and ``mem_get_info`` (:func:`_card_memory`), plus host RSS; on the
    CPU one ``cpu`` entry with no byte counts (host RSS only).
    ``set_gauges`` mirrors every reported number into ``device_mem.*``
    gauges so the fleet STATS_PULL merge picks them up."""
    import torch
    out: Dict[str, object] = {"ts": time.time(), "devices": []}
    sc = _stats.scope("device_mem") if set_gauges else None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n):
        rec = {"id": i, "kind": torch.cuda.get_device_name(i),
               "platform": "gpu"}
        try:
            mem = _card_memory(i)
        except Exception as e:  # pragma: no cover - CUDA runtime failure
            mem = {k: None for k in _MEM_KEYS}
            rec["error"] = repr(e)[:200]
        rec.update(mem)
        if sc is not None:
            for key, v in mem.items():
                if v is not None:
                    sc.gauge(f"d{i}.{key}").set(v)
        out["devices"].append(rec)
    if n == 0:
        out["devices"].append({"id": 0, "kind": "cpu", "platform": "cpu",
                               **{k: None for k in _MEM_KEYS}})
    rss = _host_rss_bytes()
    out["host_rss_bytes"] = rss
    if sc is not None and rss is not None:
        sc.gauge("host_rss_bytes",
                 "resident set size of this process").set(rss)
    return out


# -- debug-server payloads (/memz, /profilez) -------------------------------

def memz() -> dict:
    # a read-only GET must not change the exported metric surface:
    # gauges only when the perf plane is opted in
    out = sample_device_memory(set_gauges=enabled())
    # memory-anatomy fold-in (FLAGS_memory_attribution): who owns the
    # bytes the allocator reports.  Lazy import + flag guard keep the
    # flag-off page byte-identical.
    from . import memory as _memory
    if _memory.enabled():
        out["attribution"] = _memory.ledger(set_gauges=False)
    return out


def profilez() -> dict:
    peaks = platform_peaks_cached()
    return {"ts": time.time(),
            "enabled": enabled(),
            "platform_peaks": peaks,
            "records": [r.summary(peaks=peaks) for r in records()]}


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return str(n)


def memz_text(d: Optional[dict] = None) -> str:
    d = d or memz()
    lines = [f"device memory @ {time.strftime('%H:%M:%S')}"]
    for dev in d.get("devices", []):
        lines.append(
            f"  dev {dev['id']} ({dev.get('kind') or dev.get('platform')}): "
            f"in_use={_fmt_bytes(dev.get('bytes_in_use'))} "
            f"peak={_fmt_bytes(dev.get('peak_bytes_in_use'))} "
            f"limit={_fmt_bytes(dev.get('bytes_limit'))}")
    lines.append(f"  host rss: {_fmt_bytes(d.get('host_rss_bytes'))}")
    if "error" in d:
        lines.append(f"  error: {d['error']}")
    led = d.get("attribution")
    if isinstance(led, dict):
        lines.append("  attribution (FLAGS_memory_attribution):")
        for name, p in sorted((led.get("pools") or {}).items()):
            lines.append(
                f"    {name} [{p.get('kind')}]: "
                f"used={_fmt_bytes(p.get('used'))} "
                f"parked={_fmt_bytes(p.get('parked'))} "
                f"reserved={_fmt_bytes(p.get('reserved'))}")
        for dev, rec in sorted((led.get("devices") or {}).items()):
            lines.append(
                f"    {dev}: in_use={_fmt_bytes(rec.get('bytes_in_use'))} "
                f"attributed={_fmt_bytes(rec.get('attributed'))} "
                f"unattributed={_fmt_bytes(rec.get('unattributed_bytes'))}")
    return "\n".join(lines) + "\n"


def profilez_text(d: Optional[dict] = None) -> str:
    d = d or profilez()
    peaks = d.get("platform_peaks", {})
    lines = [f"perf attribution ({'on' if d.get('enabled') else 'OFF'}) — "
             f"{peaks.get('device_kind') or peaks.get('platform')}"
             + (" [nominal peaks]" if peaks.get("nominal") else "")]
    for r in d.get("records", []):
        lines.append(
            f"  {r['key']} [{r['source']}/{r['mode']}] steps={r['steps']} "
            f"flops={r['flops']:.3g} bytes={r['bytes_accessed']:.3g} "
            f"peak_mem={_fmt_bytes(r.get('memory', {}).get('peak_bytes'))}")
        parts = []
        if "intensity_flops_per_byte" in r:
            parts.append(f"intensity={r['intensity_flops_per_byte']} f/B")
        if "achieved_gflops" in r:
            parts.append(f"achieved={r['achieved_gflops']} GF/s")
        if "achieved_gbps" in r:
            parts.append(f"{r['achieved_gbps']} GB/s")
        if "frac_of_peak_flops" in r:
            parts.append(f"{100 * r['frac_of_peak_flops']:.2f}% peak flops")
        if "frac_of_peak_hbm" in r:
            parts.append(f"{100 * r['frac_of_peak_hbm']:.2f}% peak hbm")
        if "bound" in r:
            parts.append(f"{r['bound']}-bound")
        if parts:
            lines.append("      " + "  ".join(parts))
    if not d.get("records"):
        lines.append("  (no records — FLAGS_perf_attribution=1 and run a "
                     "step)")
    return "\n".join(lines) + "\n"


def export() -> dict:
    """JSON-ready bundle: records + live memory."""
    return {"profilez": profilez(), "memz": memz()}


def _platform_statusz() -> dict:
    from .. import platform as _platform
    return _platform.device_inventory()


# /statusz hardware card: fleet dashboards label perf series by device
_debug_server.register_provider("platform", _platform_statusz)
