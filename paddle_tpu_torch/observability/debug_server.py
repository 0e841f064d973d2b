"""In-process debug HTTP server: /metrics, /healthz, /statusz, /stepz.

The port's copy of ``paddle_tpu/observability/debug_server.py``.

The Borgmon/Prometheus pull model for the telemetry core: every process
(trainer, pserver, master) can expose its :mod:`stats` registry and
:mod:`step_stats` ring on a loopback HTTP port so operators and
scrapers reach telemetry *without* attaching to the process.  Strictly
opt-in: with ``FLAGS_debug_server_port`` unset (0, the default) no
socket is opened and no thread is started — ``maybe_start_from_flags``
is a flag read and nothing else.

Endpoints (all GET):

- ``/metrics``  Prometheus text from ``stats.to_prometheus_text()``;
  when a fleet aggregator is attached (``attach_aggregator``), its
  ``fleet:*``-prefixed cross-worker series are appended.
- ``/healthz``  JSON liveness: process uptime, steps recorded, age of
  the last ``Executor.run`` StepStats record (a serving process whose
  last-step age keeps growing is stuck even though the port answers).
- ``/statusz``  JSON process card: role, pid, flags, and every
  registered status provider (executor cache occupancy, ``TaskMaster``
  queue depths, ...).
- ``/stepz``    JSON ``observability.export()`` (metrics snapshot +
  step-stats summary/tail).
- ``/memz``     live device-memory snapshot (``torch.cuda.memory_stats``
  and ``mem_get_info`` per card + host RSS); ``/profilez`` the per-plan
  cost/memory attribution records with roofline positions
  (:mod:`perf`).  Both JSON by default, ``?text=1`` human text.
- ``/servingz`` the model-serving plane (``paddle_tpu_torch/serving``): per
  in-process ModelServer, the version router plus per-model QPS,
  queue-depth, batch-occupancy, shed and latency-percentile gauges.
- ``/fleetz``  the fleet-supervisor plane (``distributed/supervisor``):
  per-worker lifecycle state machine + restart budgets, with query
  params as the admin surface (resize/drain/resume/cut —
  ``tools/fleet.py`` is the CLI).
- ``/varz``    the metric history rings (:mod:`history`,
  ``FLAGS_metrics_history_interval_s``): ``?window=<s>`` bounds the
  returned series, ``?grep=<substr>`` filters metric names — "what
  changed in the last 10 minutes" without an external scraper.
- ``/sloz``    the SLO watchdog (:mod:`slo`, ``FLAGS_slo_rules``):
  rule table with live values, thresholds, breach state.

Built on stdlib ``http.server`` (ThreadingHTTPServer, daemon threads):
no new dependencies, safe to leave running in tests and serving
processes.  One process-wide singleton; ``start()``/``stop()`` are
idempotent and test-friendly.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from . import history as _history
from . import slo as _slo
from . import stats as _stats
from . import step_stats as _step_stats
from . import trace as _trace

_START_TIME = time.time()

# liveness activity marks beyond the training StepStats ring: the
# serving batcher and decode engine note each dispatch here so a pure
# inference process (which never appends StepStats) still reports a
# bounded last-activity age on /healthz instead of an ever-growing
# last-step age (it looked permanently stuck to any prober)
_activity: Dict[str, float] = {}


def note_activity(plane: str) -> None:
    """Record a liveness mark for ``plane`` ('serving', 'decode', ...).
    One clock read + dict store — safe on hot paths, no flag needed."""
    _activity[plane] = time.time()

_lock = threading.Lock()
_server: Optional["DebugServer"] = None
_providers: Dict[str, Callable[[], object]] = {}
_role: Optional[str] = None
_aggregator = None  # duck-typed: anything with .to_prometheus_text()
# /servingz sources: one per in-process ModelServer (keyed by its
# endpoint), each fn() returning that server's router + model gauges
_servingz: Dict[str, Callable[[], object]] = {}
# /decodez sources: one per in-process DecodeEngine (keyed by model
# name), each fn() returning that engine's slots/cache/queue gauges
_decodez: Dict[str, Callable[[], object]] = {}
# /fleetz sources: one per in-process fleet Supervisor (keyed by fleet
# name): (status_fn, admin_fn) — status_fn() returns the per-worker
# state-machine card, admin_fn(cmd_dict) applies resize/drain/resume/
# cut mutations (the tools/fleet.py surface)
_fleetz: Dict[str, tuple] = {}


def register_provider(name: str, fn: Callable[[], object]) -> None:
    """Add a /statusz section: ``fn()`` returns a JSON-able value.
    Re-registering a name replaces it (latest owner wins)."""
    with _lock:
        _providers[name] = fn


def unregister_provider(name: str) -> None:
    with _lock:
        _providers.pop(name, None)


def register_servingz(name: str, fn: Callable[[], object]) -> None:
    """Add a /servingz source (a ModelServer's ``manager.servingz``).
    Re-registering a name replaces it (latest owner wins)."""
    with _lock:
        _servingz[name] = fn


def unregister_servingz(name: str) -> None:
    with _lock:
        _servingz.pop(name, None)


def _servingz_payload() -> dict:
    with _lock:
        sources = dict(_servingz)
    if not sources:
        return {"serving": "no model server registered in this process"}
    out = {}
    for name, fn in sorted(sources.items()):
        try:
            out[name] = fn()
        except Exception as e:  # one broken server must not 500 the page
            out[name] = {"error": repr(e)[:200]}
    return out


def register_decodez(name: str, fn: Callable[[], object]) -> None:
    """Add a /decodez source (a DecodeEngine's ``decodez``).
    Re-registering a name replaces it (latest owner wins)."""
    with _lock:
        _decodez[name] = fn


def unregister_decodez(name: str) -> None:
    with _lock:
        _decodez.pop(name, None)


def _decodez_payload() -> dict:
    with _lock:
        sources = dict(_decodez)
    if not sources:
        return {"decode": "no decode engine registered in this process"}
    out = {}
    for name, fn in sorted(sources.items()):
        try:
            out[name] = fn()
        except Exception as e:  # one broken engine must not 500 the page
            out[name] = {"error": repr(e)[:200]}
    return out


def register_fleetz(name: str, status_fn: Callable[[], object],
                    admin_fn: Optional[Callable[[dict], object]] = None
                    ) -> None:
    """Add a /fleetz source (a Supervisor's ``status``/``_admin``).
    Re-registering a name replaces it (latest owner wins)."""
    with _lock:
        _fleetz[name] = (status_fn, admin_fn)


def unregister_fleetz(name: str) -> None:
    with _lock:
        _fleetz.pop(name, None)


def _fleetz_payload(query: str = "") -> tuple:
    """(status_code, payload) for /fleetz.  A bare GET lists every
    fleet's worker state machine; query params mutate — ``?resize=
    role:count``, ``?drain=worker``, ``?resume=[role]``, ``?cut=1
    [&wait=s]`` (``&fleet=name`` picks one when several run)."""
    from urllib.parse import parse_qs
    # keep_blank_values: the documented bare "?resume=" form must act,
    # not silently fall through to the status listing
    q = {k: v[0] for k, v in parse_qs(query,
                                      keep_blank_values=True).items()}
    with _lock:
        sources = dict(_fleetz)
    if not sources:
        return 200, {"fleet": "no supervisor registered in this process"}
    target = q.pop("fleet", None)
    cmd = {k: v for k, v in q.items()
           if k in ("resize", "drain", "resume", "cut", "wait")}
    # "wait" only modifies "cut" — alone it must not select the admin
    # path (a bare ?wait=30 falls through to the status listing)
    if any(k in cmd for k in ("resize", "drain", "resume", "cut")):
        if target is None and len(sources) > 1:
            return 400, {"error": "several fleets registered; pass "
                                  "&fleet=<name>",
                         "fleets": sorted(sources)}
        name = target if target is not None else next(iter(sources))
        ent = sources.get(name)
        if ent is None:
            return 404, {"error": f"no fleet {name!r}",
                         "fleets": sorted(sources)}
        _, admin_fn = ent
        if admin_fn is None:
            return 400, {"error": f"fleet {name!r} is read-only"}
        try:
            return 200, {name: admin_fn(cmd)}
        except Exception as e:
            return 400, {"error": repr(e)[:400]}
    out = {}
    for name, (status_fn, _) in sorted(sources.items()):
        if target is not None and name != target:
            continue
        try:
            out[name] = status_fn()
        except Exception as e:  # one broken fleet must not 500 the page
            out[name] = {"error": repr(e)[:200]}
    return 200, out


def set_role(role: Optional[str]) -> None:
    """Override the /statusz role (default: PADDLE_TRAINING_ROLE env)."""
    global _role
    _role = role


def attach_aggregator(agg) -> None:
    """Serve a FleetAggregator's merged series on /metrics (trainer 0 /
    the master call this; ``None`` detaches)."""
    global _aggregator
    _aggregator = agg


def _current_role() -> str:
    if _role:
        return _role
    return os.environ.get("PADDLE_TRAINING_ROLE", "STANDALONE")


def _healthz() -> dict:
    rec = _step_stats.recorder()
    last = rec.last_n(1)
    now = time.time()
    # liveness = the freshest of ANY dispatch plane: the training
    # StepStats ring, plus the serving/decode activity marks.  A pure
    # inference server's liveness must not age out on the training ring
    ages = {}
    if last:
        ages["train"] = round(now - last[0].ts, 3)
    # copy first: hot-path threads insert NEW plane keys concurrently,
    # and iterating the live dict could 500 a healthy process's probe
    for plane, ts in sorted(dict(_activity).items()):
        ages[plane] = round(now - ts, 3)
    out = {
        "status": "ok",
        "role": _current_role(),
        "uptime_s": round(now - _START_TIME, 3),
        "runtime_stats": _trace.flags_on(),
        "steps_recorded": rec.total_recorded,
        "last_step_age_s": (min(ages.values()) if ages else None),
        "activity_age_s": ages,
    }
    # load next to liveness (FLAGS_capacity_attribution): a drained-
    # but-saturated replica must read differently from an idle one.
    # Flag off ⇒ no key, payload identical to the pre-capacity build
    from . import capacity as _capacity
    if _capacity.enabled():
        hr = _capacity.headroom()
        if hr:
            out["headroom"] = hr
    return out


def _statusz() -> dict:
    from ..core import flags as _flags
    with _lock:
        providers = dict(_providers)
    out = {
        "role": _current_role(),
        "pid": os.getpid(),
        "argv": sys.argv,
        "uptime_s": round(time.time() - _START_TIME, 3),
        "constant_labels": _stats.default_registry().constant_labels(),
        "flags": _flags.all_flags(),
    }
    for name, fn in sorted(providers.items()):
        try:
            out[name] = fn()
        except Exception as e:  # one broken provider must not 500 the page
            out[name] = {"error": repr(e)[:200]}
    return out


class _Handler(BaseHTTPRequestHandler):
    # stderr-per-request logging would swamp training logs; count instead
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype + "; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _tracez(self, query: str) -> str:
        from urllib.parse import parse_qs
        q = parse_qs(query)

        def _flag(name: str) -> bool:
            return q.get(name, ["0"])[0] not in ("0", "", "false")

        if _flag("recent"):
            # the flight-recorder view, served LIVE (what a dump file
            # would contain right now): recent + in-flight spans, log
            # events, step-stats tail
            from . import flight as _flight
            return json.dumps(_flight.snapshot("tracez"), indent=2,
                              default=repr)
        snap = _trace.local_trace_snapshot()
        if _flag("raw"):
            # the TRACE_PULL snapshot form — what tools/stitch_trace.py
            # merges across workers
            return json.dumps(snap, indent=2)
        # default: this process's ring as a directly-loadable
        # Chrome/Perfetto trace (real pid + process/thread names)
        label = f"{snap['role'].lower()}-{snap['pid']}"
        return json.dumps(_trace.stitch_chrome_trace({label: snap}))

    def do_GET(self):  # noqa: N802 (http.server casing)
        path, _, query = self.path.partition("?")
        path = path.rstrip("/") or "/"
        sc = _stats.scope("debug_server")
        try:
            if path == "/metrics":
                text = _stats.to_prometheus_text()
                agg = _aggregator
                if agg is not None:
                    try:
                        text += agg.to_prometheus_text()
                    except Exception as e:
                        text += f"# fleet aggregation failed: {e!r}\n"
                self._reply(200, text, "text/plain; version=0.0.4")
            elif path == "/healthz":
                self._reply(200, json.dumps(_healthz(), indent=2),
                            "application/json")
            elif path == "/statusz":
                self._reply(200, json.dumps(_statusz(), indent=2,
                                            default=repr),
                            "application/json")
            elif path == "/stepz":
                from . import export
                self._reply(200, json.dumps(export(), indent=2),
                            "application/json")
            elif path == "/tracez":
                self._reply(200, self._tracez(query), "application/json")
            elif path in ("/memz", "/profilez"):
                # the perf plane (observability/perf.py): live
                # device-memory stats and per-plan cost/memory
                # attribution + rooflines.  JSON by default, ?text=1 for
                # the human rendering (tools/dump_metrics.py --memz /
                # --profilez is the operator CLI)
                from urllib.parse import parse_qs
                from . import perf as _perf
                q = parse_qs(query)
                text = q.get("text", ["0"])[0] not in ("0", "", "false")
                if path == "/memz":
                    body = (_perf.memz_text() if text
                            else json.dumps(_perf.memz(), indent=2))
                else:
                    body = (_perf.profilez_text() if text
                            else json.dumps(_perf.profilez(), indent=2))
                self._reply(200, body,
                            "text/plain" if text else "application/json")
            elif path == "/servingz":
                # the serving-plane debug page: router state + per-model
                # QPS / queue-depth / batch-occupancy / latency gauges
                # for every ModelServer in this process
                self._reply(200, json.dumps(_servingz_payload(), indent=2,
                                            default=repr),
                            "application/json")
            elif path == "/decodez":
                # the decode-plane debug page: per-engine slot table,
                # paged-cache occupancy, queue depth, tokens/s gauges
                self._reply(200, json.dumps(_decodez_payload(), indent=2,
                                            default=repr),
                            "application/json")
            elif path == "/fleetz":
                # the fleet-supervisor debug page: per-worker lifecycle
                # state machine (STARTING→LIVE→DRAINING→DEAD→REPLACING)
                # + restart budgets; query params resize/drain/resume/
                # cut a running fleet (tools/fleet.py is the CLI)
                code, payload = _fleetz_payload(query)
                self._reply(code, json.dumps(payload, indent=2,
                                             default=repr),
                            "application/json")
            elif path == "/varz":
                # the metric-history plane (observability/history.py):
                # bounded downsampled time series per counter/gauge,
                # ?window=<s> bounds the ages, ?grep filters names
                from urllib.parse import parse_qs
                q = parse_qs(query)
                window = q.get("window", [None])[0]
                window_s = float(window) if window else None
                pattern = q.get("grep", [""])[0]
                self._reply(200, json.dumps(
                    _history.varz(window_s, pattern), indent=2),
                    "application/json")
            elif path == "/sloz":
                # the SLO watchdog (observability/slo.py): rule table
                # with live values / thresholds / breach state
                self._reply(200, json.dumps(_slo.sloz(), indent=2,
                                            default=repr),
                            "application/json")
            elif path in ("/capacityz", "/tenantz"):
                # the saturation-anatomy plane (observability/
                # capacity.py + tenant.py): phase-level utilization,
                # operational-law headroom and per-tenant usage
                # metering.  JSON by default, ?text=1 for the human
                # rendering (tools/dump_metrics.py --capacityz /
                # --tenantz is the operator CLI)
                from urllib.parse import parse_qs
                from . import capacity as _capacity
                from . import tenant as _tenant
                q = parse_qs(query)
                text = q.get("text", ["0"])[0] not in ("0", "", "false")
                if path == "/capacityz":
                    body = (_capacity.capacityz_text() if text
                            else json.dumps(_capacity.capacityz(),
                                            indent=2))
                else:
                    body = (_tenant.tenantz_text() if text
                            else json.dumps(_tenant.tenantz(), indent=2))
                self._reply(200, body,
                            "text/plain" if text else "application/json")
            elif path == "/allocz":
                # the memory-anatomy plane (observability/memory.py):
                # per-pool HBM/host/disk attribution ledger, per-device
                # PJRT reconciliation, allocation event ring.  JSON by
                # default, ?text=1 for the human rendering
                # (tools/dump_metrics.py --allocz is the operator CLI)
                from urllib.parse import parse_qs
                from . import memory as _memory
                q = parse_qs(query)
                text = q.get("text", ["0"])[0] not in ("0", "", "false")
                body = (_memory.allocz_text() if text
                        else json.dumps(_memory.allocz(), indent=2,
                                        default=repr))
                self._reply(200, body,
                            "text/plain" if text else "application/json")
            elif path == "/quantz":
                # the low-precision-serving plane (kernels/quant.py):
                # per-layer calibration records (scales, clip
                # fractions), quantized-matmul launch/fallback
                # counters, quantized KV cache pools.  JSON by
                # default, ?text=1 for the human rendering
                # (tools/dump_metrics.py --quantz is the operator CLI)
                from urllib.parse import parse_qs
                from ..kernels import quant as _quant
                q = parse_qs(query)
                text = q.get("text", ["0"])[0] not in ("0", "", "false")
                body = (_quant.quantz_text() if text
                        else json.dumps(_quant.quantz(), indent=2,
                                        default=repr))
                self._reply(200, body,
                            "text/plain" if text else "application/json")
            elif path == "/canaryz":
                # the correctness-anatomy plane (observability/
                # canary.py + audit.py): golden-probe streak table plus
                # the divergence audit ring.  JSON by default, ?text=1
                # for the human rendering (tools/dump_metrics.py
                # --canaryz is the operator CLI)
                from urllib.parse import parse_qs
                from . import audit as _audit
                from . import canary as _canary
                q = parse_qs(query)
                text = q.get("text", ["0"])[0] not in ("0", "", "false")
                if text:
                    body = _canary.canaryz_text()
                else:
                    payload = _canary.canaryz()
                    payload.update(_audit.auditz())
                    body = json.dumps(payload, indent=2, default=repr)
                self._reply(200, body,
                            "text/plain" if text else "application/json")
            elif path == "/chaosz":
                # fault-injection control plane (distributed/faults.py):
                # ?inject=<spec> arms rules, ?clear=1 removes runtime
                # rules, bare GET lists what's armed.  tools/chaos.py is
                # the operator CLI over this endpoint.
                from urllib.parse import parse_qs, unquote
                from ..distributed import faults as _faults
                q = parse_qs(query)
                if q.get("inject"):
                    try:
                        added = _faults.inject(unquote(q["inject"][0]))
                    except ValueError as e:
                        self._reply(400, json.dumps(
                            {"error": str(e)}) + "\n", "application/json")
                        return
                    self._reply(200, json.dumps(
                        {"injected": added}, indent=2), "application/json")
                elif q.get("clear"):
                    self._reply(200, json.dumps(
                        {"cleared": _faults.clear()}), "application/json")
                else:
                    self._reply(200, json.dumps(
                        {"rules": _faults.list_rules()}, indent=2),
                        "application/json")
            elif path == "/":
                self._reply(200, "\n".join(
                    ["paddle_tpu_torch debug server", "",
                     "/metrics  /healthz  /statusz  /stepz",
                     "/tracez  (?raw=1 span snapshot, ?recent=1 flight "
                     "recorder)",
                     "/memz  /profilez  (?text=1 human rendering)",
                     "/servingz  (model-server router + batching gauges)",
                     "/decodez  (decode engines: slots, paged cache, "
                     "queue)",
                     "/fleetz  (supervised fleet state machine; "
                     "?resize=role:n ?drain=w ?resume= ?cut=1)",
                     "/varz  (metric history rings; ?window=<s> "
                     "?grep=<substr>)",
                     "/sloz  (SLO watchdog rule table)",
                     "/capacityz  (phase utilization + headroom; "
                     "?text=1)",
                     "/tenantz  (per-tenant usage metering; ?text=1)",
                     "/allocz  (memory-attribution ledger + event ring; "
                     "?text=1)",
                     "/quantz  (int8 calibration, quantized matmul "
                     "fallbacks, KV dtype; ?text=1)",
                     "/canaryz  (golden canary streaks + divergence "
                     "audit; ?text=1)",
                     "/chaosz  (?inject=<spec> arm faults, ?clear=1)", ""]),
                    "text/plain")
            else:
                sc.counter("not_found").inc()
                self._reply(404, f"no such page: {path}\n", "text/plain")
                return
            sc.counter("requests" + path.replace("/", ".")).inc()
        except Exception as e:  # pragma: no cover - handler last resort
            try:
                self._reply(500, f"internal error: {e!r}\n", "text/plain")
            except Exception:
                pass


class DebugServer:
    """One ThreadingHTTPServer on a daemon thread (see module doc)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"debug-server-{host}:{self.port}")

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def server() -> Optional[DebugServer]:
    """The running singleton, or None (the flag-off steady state)."""
    return _server


def start(port: int = 0, host: Optional[str] = None) -> DebugServer:
    """Start (or return) the process-wide server.  ``port=0`` binds an
    ephemeral port — tests read ``.port`` back."""
    global _server
    with _lock:
        if _server is not None:
            return _server
        from ..core import flags as _flags
        if host is None:
            try:
                host = _flags.get_flags("debug_server_host")
            except KeyError:  # pragma: no cover
                host = "127.0.0.1"
        srv = DebugServer(port=port, host=host)
        srv.start()
        _server = srv
        return srv


def stop() -> None:
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()


def maybe_start_from_flags() -> Optional[DebugServer]:
    """The wiring hook (Executor init, RPCServer start): starts the
    singleton iff ``FLAGS_debug_server_port`` > 0.  With the flag at its
    default 0 this is a dict lookup — no socket, no thread.  The
    metric-history sampler and SLO watchdog ride the same hook (each
    behind its OWN flag — they work without the HTTP server; flags at
    defaults, each check is one dict lookup)."""
    from ..core import flags as _flags
    from . import canary as _canary
    _history.maybe_start_from_flags()
    _slo.maybe_start_from_flags()
    _canary.maybe_start_from_flags()
    try:
        port = int(_flags.get_flags("debug_server_port"))
    except KeyError:  # pragma: no cover
        return None
    if port <= 0:
        return _server
    try:
        return start(port=port)
    except OSError as e:
        # a second process on the host with the same flag value: telemetry
        # must never take training down — warn and run without the server
        print(f"[debug-server] cannot bind port {port}: {e}",
              file=sys.stderr, flush=True)
        return None
