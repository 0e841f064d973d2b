"""Model server: the serving plane's RPC front door + replica announce.

The port's copy of ``paddle_tpu/serving/server.py``.

Rides the repo's own framed-TCP transport (one more
:class:`~paddle_tpu_torch.distributed.transport.RPCServer` service, like the
pserver/master/registry): an ``INFER`` frame carries a request's feed
tensors in the zero-copy batched serde, the reply streams the fetch
tensors back scatter-gather, and the existing per-request distributed
tracing stitches client → server → ``serving::dispatch`` →
``executor::step`` spans end to end with no new wire format.

Wire protocol (both payloads ride the batched serde):

- ``INFER`` (msg 21): ``name`` = model name, payload =
  ``serde.dumps_batch`` of the feed ``(name, array)`` pairs.  Reply
  payload is 1 tag byte + body: ``R`` + serde batch of fetch pairs on
  success, ``O`` + JSON :class:`Overloaded` detail on load-shed (typed,
  never a generic error).  Anything else (unknown model, bad feed)
  surfaces as the transport's ERR frame.
- ``SERVING_ADMIN`` (msg 22): JSON command — ``{"cmd": "status"}``,
  ``{"cmd": "swap"|"load", "model":, "version":, "model_dir":, ...}``,
  ``{"cmd": "activate"|"retire", ...}`` — JSON reply.  This is what
  ``tools/serve.py --swap`` drives.

Replica groups: ``registry_ep`` set ⇒ the server announces one TTL
lease per served model under the logical key
``serving/<model>/<replica_id>`` (value: this server's endpoint), with
the active version + live QPS riding the lease's data payload and the
fleet health plane seeing a ``SERVING``-role heartbeat.  The thin
:class:`~paddle_tpu_torch.serving.client.ServingClient` discovers replicas
from the same registry and fails over health-gated.  No registry ⇒ no
lease traffic, a plain static-endpoint server.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

from ..observability import flight as _flight

from .batcher import Draining, Overloaded, RequestTooLong
from .model_registry import ModelManager
from ..distributed import faults as _faults
from ..distributed import registry as _registry
from ..distributed import serde, transport
from ..observability import audit as _audit
from ..observability import canary as _canary
from ..observability import debug_server as _debug_server
from ..observability import memory as _memory

# message types: 21/22 keep the one-namespace msg-type space clear of
# transport 1-14, master 16-20, and the observability pulls 24/25
INFER = 21
SERVING_ADMIN = 22

transport.MSG_NAMES.update({INFER: "infer",
                            SERVING_ADMIN: "serving_admin"})

# INFER reply tag bytes (first payload byte)
# reserved serde feed name carrying an optional utf-8 tenant id
# (uint8 bytes); never a real model feed, popped before validation
TENANT_FEED_KEY = "__tenant__"

_TAG_RESULT = b"R"
_TAG_OVERLOAD = b"O"
_TAG_TOO_LONG = b"L"
_TAG_DRAINING = b"D"


def replica_key(model: str, replica_id: str) -> str:
    """The registry lease key a serving replica announces under."""
    return f"serving/{model}/{replica_id}"


def parse_replica_key(logical: str):
    """``(model, replica_id)`` from a serving lease key, else None."""
    parts = logical.split("/", 2)
    if len(parts) == 3 and parts[0] == "serving":
        return parts[1], parts[2]
    return None


class ServingService:
    """``handle()`` contract of transport.RPCServer services."""

    def __init__(self, manager: ModelManager, on_change=None,
                 endpoint: str = "", replica_id: str = ""):
        self.manager = manager
        # server hook: re-announce registry leases after admin changes
        self._on_change = on_change
        self.endpoint = endpoint
        # replica-qualifies the corrupt-fault site so chaos can hit
        # exactly one replica (``corrupt:serving_reply@r1``)
        self.replica_id = replica_id
        # graceful drain: once set, new INFERs get a typed Draining
        # reply (the lease is already deregistered — only stragglers
        # racing the deregistration land here) while accepted requests
        # keep flowing to completion
        self.draining = False
        # in-flight handler count: stop(drain=True) waits for it to
        # reach zero AFTER the batcher drains — a handler still between
        # its future resolving and returning the reply must not have
        # its connection severed by the socket close (the reply would
        # be lost AFTER the batcher swore the request was answered)
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    def handle(self, msg_type, trainer_id, name, payload):
        with self._inflight_cv:
            self._inflight += 1
        try:
            return self._handle(msg_type, trainer_id, name, payload)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        """Block until no handler is inside :meth:`handle` (bounded)."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._inflight_cv.wait(timeout=min(left, 0.2))
        return True

    def _handle(self, msg_type, trainer_id, name, payload):
        if msg_type == INFER:
            if self.draining:
                e = Draining(name, self.endpoint)
                return transport.OK, [
                    _TAG_DRAINING + json.dumps(e.to_dict()).encode("utf-8")]
            feed = dict(serde.loads_batch(payload, copy=False))
            # wire-optional tenant id: a reserved serde pair the client
            # appends ONLY when set (absent ⇒ frames byte-identical to
            # tenant-unaware builds; old servers ignore the extra feed)
            tenant = None
            t_arr = feed.pop(TENANT_FEED_KEY, None)
            if t_arr is not None:
                import numpy as _np
                tenant = bytes(_np.asarray(t_arr, _np.uint8)).decode(
                    "utf-8", "replace") or None
            try:
                fut, sm = self.manager.serve_request(name, feed,
                                                     tenant=tenant)
            except Overloaded as e:
                return transport.OK, [
                    _TAG_OVERLOAD + json.dumps(e.to_dict()).encode("utf-8")]
            except RequestTooLong as e:
                # typed like Overloaded, but terminal: no replica would
                # accept this request, so the client must NOT fail over
                return transport.OK, [
                    _TAG_TOO_LONG + json.dumps(e.to_dict()).encode("utf-8")]
            # bounded wait: a wedged batcher must surface as an ERR frame
            # to this client, not a connection thread parked forever
            from ..core import flags as _flags
            outs = fut.result(timeout=float(_flags.get_flags("rpc_deadline")))
            # reply names come from the model that ANSWERED — a re-route
            # for names could race a hot-swap onto a different version
            pairs = list(zip(sm.predictor.fetch_names, outs))
            if _faults.active():
                # silent-data-corruption chaos site: applied BEFORE the
                # divergence digest, so an injected SDC looks to the
                # sentinel exactly like a real one (wrong bytes leave
                # the replica, digest and all)
                nbits = _faults.corrupt_fault(
                    f"serving_reply@{self.replica_id}", "serving_reply")
                if nbits and pairs:
                    fname, fval = pairs[0]
                    pairs[0] = (fname, _faults.corrupt_array(fval, nbits))
            if _audit.enabled():
                _audit.note_reply(name, str(sm.version),
                                  _audit.request_hash(feed),
                                  _audit.digest_pairs(pairs))
            return transport.OK, [_TAG_RESULT] + serde.dumps_batch_vec(pairs)
        if msg_type == SERVING_ADMIN:
            body = json.loads(bytes(payload).decode("utf-8"))
            out = self._admin(body)
            return transport.OK, json.dumps(out, default=repr).encode("utf-8")
        return transport.ERR, f"serving: unknown msg {msg_type}".encode()

    def _admin(self, body: dict) -> dict:
        cmd = body.get("cmd")
        m = self.manager
        if cmd == "status":
            return m.servingz()
        if cmd in ("load", "swap"):
            kw = {k: body[k] for k in
                  ("model_dir", "buckets", "sample_shapes", "max_delay_ms",
                   "max_queue_rows", "queue_delay_slo_ms", "max_seq_len")
                  if k in body}
            if cmd == "load":
                sm = m.load(body["model"], body["version"],
                            activate=bool(body.get("activate", True)), **kw)
                out = {"loaded": f"{sm.name}@{sm.version}",
                       "warm": sm.warm_info}
            else:
                out = m.swap(body["model"], body["version"], **kw)
            if self._on_change is not None:
                self._on_change()
            return out
        if cmd == "activate":
            m.activate(body["model"], body["version"])
            return {"active": m.active_version(body["model"])}
        if cmd == "retire":
            m.retire(body["model"], body["version"])
            return {"retired": f"{body['model']}@{body['version']}"}
        raise ValueError(f"serving_admin: unknown cmd {cmd!r}")


class ModelServer:
    """One serving process: RPC endpoint + model manager + announces.

    ``registry_ep`` (optional) turns on replica-group membership; with
    it unset the server opens exactly one listening socket and nothing
    else.  ``manager`` may be shared/prebuilt (in-process tests);
    otherwise the server owns one and closes it on :meth:`stop`.
    """

    def __init__(self, endpoint: str = "127.0.0.1:0",
                 manager: Optional[ModelManager] = None,
                 registry_ep: Optional[str] = None,
                 replica_id: Optional[str] = None,
                 lease_ttl: float = _registry.DEFAULT_TTL):
        self._own_manager = manager is None
        self.manager = manager if manager is not None else ModelManager()
        self.service = ServingService(self.manager,
                                      on_change=self._sync_announcements)
        self._server = transport.RPCServer(endpoint, self.service)
        self.registry_ep = registry_ep
        self.lease_ttl = lease_ttl
        self.replica_id = replica_id or f"{self.endpoint}"
        self.service.replica_id = self.replica_id
        self._canary_client: Optional[transport.RPCClient] = None
        self._hb_lock = threading.Lock()
        self._heartbeats: Dict[str, _registry.Heartbeat] = {}
        self._started = False

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def endpoint(self) -> str:
        host = self._server.endpoint.rsplit(":", 1)[0]
        return f"{host}:{self.port}"

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._server.start()
        self._started = True
        self.service.endpoint = self.endpoint
        _debug_server.register_servingz(self.endpoint,
                                        self.manager.servingz)
        # correctness plane: the golden prober self-arms in any serving
        # process (no-op with FLAGS_canary_probe off)
        _canary.maybe_start_from_flags()
        self._sync_announcements()
        self._sync_canary_targets()

    def stop(self, drain: bool = False, drain_timeout: float = 30.0
             ) -> None:
        """Shut the replica down.  ``drain=True`` is the graceful
        sequence — ordered so a discovery-based client NEVER loses a
        request to the shutdown:

        1. deregister the registry leases FIRST (``bye=True``): clients
           fail over to the remaining replicas before this socket dies;
        2. flip the service to draining: a straggler INFER that raced
           the deregistration gets a typed :class:`Draining` reply (it
           rotates, like Overloaded) instead of being accepted into a
           batcher about to close;
        3. finish every in-flight batch within ``drain_timeout`` (the
           batcher drain gate), THEN close the socket and the manager.

        ``drain=False`` keeps the old immediate-stop behavior."""
        # before draining the heartbeats: an admin-swap handler thread
        # finishing after stop() calls _sync_announcements, which must
        # not re-announce leases for a dead server
        self._started = False
        with self._hb_lock:
            hbs, self._heartbeats = dict(self._heartbeats), {}
        for hb in hbs.values():
            hb.stop(bye=True)
        if drain:
            self.service.draining = True
            deadline = time.monotonic() + drain_timeout
            for sm in self.manager.models():
                left = max(0.1, deadline - time.monotonic())
                if not sm.batcher.drain(timeout=left):
                    _flight.note("serving_drain_timeout",
                                 model=f"{sm.name}@{sm.version}",
                                 endpoint=self.endpoint)
            # the batcher resolving every future is necessary but not
            # sufficient: a handler thread can still be BETWEEN its
            # future resolving and writing the reply when the socket
            # close below severs its connection (seen as a flaky
            # ConnectionError on the very request drain promised to
            # answer).  Wait for the handlers themselves
            if not self.service.wait_idle(
                    max(0.1, deadline - time.monotonic())):
                _flight.note("serving_drain_handler_timeout",
                             endpoint=self.endpoint)
        _debug_server.unregister_servingz(self.endpoint)
        for sm in self.manager.models():
            _canary.unregister_target(replica_key(sm.name, self.replica_id))
        # drain: the transport grants mid-reply connections a bounded
        # grace so the last replies reach the wire before severing
        self._server.stop(graceful_s=2.0 if drain else 0.0)
        if self._own_manager:
            self.manager.close()

    # -- convenience passthroughs (announce-aware) -------------------------
    def load(self, *args, **kw):
        sm = self.manager.load(*args, **kw)
        self._sync_announcements()
        self._sync_canary_targets()
        return sm

    def swap(self, *args, **kw):
        out = self.manager.swap(*args, **kw)
        self._sync_announcements()
        self._sync_canary_targets()
        return out

    # -- registry announce -------------------------------------------------
    def _model_health(self, model: str):
        def probe() -> dict:
            sm = None
            try:
                sm = self.manager._route(model)  # active version
            except KeyError:
                pass
            if sm is None:
                return {"step": 0}
            snap = sm.batcher.stats.snapshot()
            return {"step": snap.get("requests", 0)}
        return probe

    def _model_data(self, model: str):
        def data() -> dict:
            version = self.manager.active_version(model)
            out = {"model": model, "version": version,
                   "endpoint": self.endpoint}
            try:
                sm = self.manager._route(model)
                snap = sm.batcher.stats.snapshot()
                out["qps"] = snap.get("qps", 0.0)
                out["queue_rows"] = sm.batcher.queue_rows()
                if "p99_ms" in snap:
                    out["p99_ms"] = snap["p99_ms"]
                # latency anatomy rides the lease payload (present iff
                # FLAGS_phase_attribution): the fleet sees WHERE each
                # replica's tail goes, not just that it grew
                ph = snap.get("phases")
                if ph and ph.get("slowest_phase"):
                    out["slowest_phase"] = ph["slowest_phase"]
                    out["phase_total_p99_ms"] = ph.get("total_p99_ms")
                # capacity headroom rides the same lease payload
                # (present iff FLAGS_capacity_attribution and the
                # tracker has completed work): a drained-but-saturated
                # replica reads differently from an idle one fleet-wide
                cap = sm.batcher.stats.capacity()
                if cap is not None:
                    hr = cap.headroom()
                    if hr is not None:
                        out.update(hr)
            except KeyError:
                pass
            # correctness plane rides the same lease (canary streaks
            # present iff FLAGS_canary_probe and this replica is a
            # probed target; reply digests present iff
            # FLAGS_divergence_check) — the supervisor's sentinel
            # groups digests ACROSS replicas with zero new RPCs
            can = _canary.lease_rider(replica_key(model, self.replica_id))
            if can is not None:
                out["canary"] = can
            dig = _audit.recent_digests()
            if dig is not None and model in dig:
                out["digests"] = {model: dig[model]}
            # memory anatomy rides the same lease (present iff
            # FLAGS_memory_attribution and pools registered): the
            # ElasticController reads measured byte headroom per role
            mem = _memory.lease_rider()
            if mem is not None:
                out.update(mem)
            return out
        return data

    # -- golden canary targets ---------------------------------------------
    def _canary_submit(self, model: str):
        """A probe submit fn taking the REAL path: loopback RPC through
        the wire INFER handler, so serde, batcher, device, reply
        assembly — and any silent corruption on the way — are all
        inside the probed surface."""
        def submit(feeds: dict, tenant: Optional[str]):
            import numpy as np
            pairs = [(n, np.asarray(v)) for n, v in sorted(feeds.items())]
            if tenant:
                pairs.append((TENANT_FEED_KEY,
                              np.frombuffer(str(tenant).encode("utf-8"),
                                            np.uint8)))
            if self._canary_client is None:
                self._canary_client = transport.RPCClient(0)
            body = self._canary_client._raw_request(
                self.endpoint, INFER, model, serde.dumps_batch_vec(pairs))
            body = memoryview(bytes(body)) if not isinstance(
                body, memoryview) else body
            tag, rest = bytes(body[:1]), body[1:]
            if tag != _TAG_RESULT:
                raise RuntimeError(f"canary probe got reply tag {tag!r}")
            return serde.loads_batch(rest, copy=True)
        return submit

    def _sync_canary_targets(self) -> None:
        """Mirror :meth:`_sync_announcements` for the prober's target
        registry (works registry-less too) — a no-op unless armed."""
        if not _canary.enabled() or not self._started:
            return
        for sm in self.manager.models():
            if sm.state not in ("RETIRED",):
                _canary.register_target(
                    replica_key(sm.name, self.replica_id), sm.name,
                    self._canary_submit(sm.name))

    def _sync_announcements(self) -> None:
        """One registry heartbeat per served MODEL NAME: the lease
        (``serving/<model>/<replica>`` → this endpoint) is the replica
        group membership; its data payload carries the live version so
        a hot-swap is visible fleet-wide within one lease refresh."""
        if not self.registry_ep or not self._started:
            return
        names = {sm.name for sm in self.manager.models()
                 if sm.state not in ("RETIRED",)}
        with self._hb_lock:
            for model in sorted(names - set(self._heartbeats)):
                hb = _registry.Heartbeat(
                    self.registry_ep, replica_key(model, self.replica_id),
                    self.endpoint, ttl=self.lease_ttl, role="SERVING",
                    health_fn=self._model_health(model),
                    data_fn=self._model_data(model))
                hb.start()
                self._heartbeats[model] = hb
            for model in sorted(set(self._heartbeats) - names):
                self._heartbeats.pop(model).stop(bye=True)
