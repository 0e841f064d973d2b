"""Decode server: the generative plane's streaming RPC front door.

The port's copy of ``paddle_tpu/decode/server.py``.

One more :class:`~paddle_tpu_torch.distributed.transport.RPCServer` service
(like the pserver/master/registry/serving endpoints), with one new
message type:

- ``DECODE`` (msg 23): ``name`` = model name, payload = JSON request
  ``{"prompt": [ids], "max_new_tokens":, "temperature":, "top_k":,
  "seed":, "eos_id":, "chunk_tokens":}``.  The reply is a STREAM — the
  transport sends one frame per chunk as the engine generates (the
  multi-frame handler contract ``transport.STREAM``), each payload one
  tag byte + body:

  * ``T`` + ``serde.dumps_batch`` of ``[("tokens", int32[k])]`` — a
    chunk of ``chunk_tokens`` generated tokens (default 1: true
    token-by-token streaming), riding the zero-copy batched serde;
  * ``F`` + JSON ``{"n_tokens":, "finish": "eos"|"length"}`` — end of
    stream;
  * ``O`` / ``L`` + JSON — typed :class:`Overloaded` /
    :class:`RequestTooLong` detail (single-frame reply, like the
    serving plane's INFER tags).

- ``DECODE_ADMIN`` (msg 26): JSON command — ``{"cmd": "status"}``
  returns the per-engine ``/decodez`` payloads.

Replica groups: ``registry_ep`` set ⇒ one TTL lease per served model
under ``decode/<model>/<replica_id>`` with role ``DECODE`` and the live
tokens/s riding the lease data — the registry announce path, so
:class:`~paddle_tpu_torch.decode.client.DecodeClient` discovers replicas and
health-gates exactly like the one-shot serving client.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

import numpy as np

from .engine import DecodeEngine, SamplingParams
from ..distributed import registry as _registry
from ..distributed import serde, transport
from ..observability import audit as _audit
from ..observability import canary as _canary
from ..observability import flight as _flight
from ..observability import memory as _memory
from ..serving.batcher import Draining, Overloaded, RequestTooLong

# one msg-type namespace across every service: transport 1-14,
# master 15-20, serving 21/22, observability 24/25 — decode takes 23/26
DECODE = 23
DECODE_ADMIN = 26

transport.MSG_NAMES.update({DECODE: "decode",
                            DECODE_ADMIN: "decode_admin"})

_TAG_TOKENS = b"T"
_TAG_FIN = b"F"
_TAG_OVERLOAD = b"O"
_TAG_TOO_LONG = b"L"
_TAG_DRAINING = b"D"


def replica_key(model: str, replica_id: str) -> str:
    """The registry lease key a decode replica announces under."""
    return f"decode/{model}/{replica_id}"


def parse_replica_key(logical: str):
    """``(model, replica_id)`` from a decode lease key, else None."""
    parts = logical.split("/", 2)
    if len(parts) == 3 and parts[0] == "decode":
        return parts[1], parts[2]
    return None


class DecodeService:
    """``handle()`` contract of transport.RPCServer services; DECODE
    replies stream (``transport.STREAM``)."""

    def __init__(self, engines: Dict[str, DecodeEngine]):
        self.engines = dict(engines)
        # graceful drain: once set, new DECODE submits get a typed
        # Draining reply (the leases are already deregistered); the
        # streams already running keep generating to their FIN
        self.draining = False
        self.endpoint = ""

    def handle(self, msg_type, trainer_id, name, payload):
        if msg_type == DECODE:
            if self.draining:
                e = Draining(name, self.endpoint)
                return transport.OK, [
                    _TAG_DRAINING + json.dumps(e.to_dict()).encode("utf-8")]
            body = json.loads(bytes(payload).decode("utf-8"))
            eng = self.engines.get(name)
            if eng is None:
                return transport.ERR, \
                    f"decode: unknown model {name!r}".encode()
            sampling = SamplingParams.from_dict(body)
            chunk = max(1, int(body.get("chunk_tokens", 1)))
            # wire-optional tenant id: present only when the client set
            # one (old peers ignore unknown JSON keys — interop both
            # ways, absent ⇒ byte-identical request bodies)
            tenant = body.get("tenant")
            if not isinstance(tenant, str) or not tenant:
                tenant = None
            try:
                handle = eng.submit(body.get("prompt") or [], sampling,
                                    tenant=tenant)
            except Overloaded as e:
                return transport.OK, [
                    _TAG_OVERLOAD + json.dumps(e.to_dict()).encode("utf-8")]
            except RequestTooLong as e:
                return transport.OK, [
                    _TAG_TOO_LONG + json.dumps(e.to_dict()).encode("utf-8")]
            return transport.STREAM, self._stream(handle, chunk)
        if msg_type == DECODE_ADMIN:
            body = json.loads(bytes(payload).decode("utf-8"))
            if body.get("cmd") == "status":
                return transport.OK, json.dumps(
                    {m: e.decodez() for m, e in sorted(self.engines.items())},
                    default=repr).encode("utf-8")
            return transport.ERR, \
                f"decode_admin: unknown cmd {body.get('cmd')!r}".encode()
        return transport.ERR, f"decode: unknown msg {msg_type}".encode()

    @staticmethod
    def _stream(handle, chunk_tokens: int):
        """Frame generator: T-chunks as tokens arrive, then FIN.

        Two failure disciplines:
        - every token wait is BOUNDED by FLAGS_rpc_deadline — a wedged
          engine surfaces as a transport ERR frame, never a connection
          thread parked forever (the serving plane's INFER contract);
        - a client disconnect abandons this generator (the transport's
          STREAM path closes it), and the ``finally`` cancels the
          request — the engine frees the slot + cache blocks instead
          of generating into the void."""
        from ..core import flags as _flags
        deadline = float(_flags.get_flags("rpc_deadline"))
        buf = []
        try:
            while True:
                tok = handle.next_token(timeout=deadline)
                if tok is None:
                    break
                buf.append(tok)
                if len(buf) >= chunk_tokens:
                    yield [_TAG_TOKENS] + serde.dumps_batch_vec(
                        [("tokens", np.asarray(buf, np.int32))])
                    buf = []
            if buf:
                yield [_TAG_TOKENS] + serde.dumps_batch_vec(
                    [("tokens", np.asarray(buf, np.int32))])
            final = handle.result(timeout=0.0)
            yield [_TAG_FIN + json.dumps(
                {"n_tokens": final["n_tokens"],
                 "finish": final["finish"]}).encode("utf-8")]
        finally:
            handle.cancel()   # no-op when the stream finished normally


class DecodeServer:
    """One decode-serving process: RPC endpoint + engines + announces.

    ``engines``: model name → prebuilt :class:`DecodeEngine` (the
    server owns them and closes them on :meth:`stop` unless
    ``own_engines=False``)."""

    def __init__(self, endpoint: str = "127.0.0.1:0",
                 engines: Optional[Dict[str, DecodeEngine]] = None,
                 registry_ep: Optional[str] = None,
                 replica_id: Optional[str] = None,
                 lease_ttl: float = _registry.DEFAULT_TTL,
                 own_engines: bool = True):
        self.engines: Dict[str, DecodeEngine] = dict(engines or {})
        self._own_engines = own_engines
        self.service = DecodeService(self.engines)
        self._server = transport.RPCServer(endpoint, self.service)
        self.registry_ep = registry_ep
        self.lease_ttl = lease_ttl
        self.replica_id = replica_id or f"{self.endpoint}"
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

    def add_engine(self, name: str, engine: DecodeEngine) -> None:
        self.engines[name] = engine
        self.service.engines[name] = engine
        self._sync_announcements()
        self._sync_canary_targets()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._server.start()
        self._started = True
        self.service.endpoint = self.endpoint
        # correctness plane: the golden prober self-arms in any decode
        # process (no-op with FLAGS_canary_probe off)
        _canary.maybe_start_from_flags()
        self._sync_announcements()
        self._sync_canary_targets()

    def stop(self, drain: bool = False, drain_timeout: float = 60.0
             ) -> None:
        """Shut the replica down.  ``drain=True`` is the graceful
        sequence (the serving plane's discipline, stream-shaped):
        deregister the leases FIRST so clients discover away from this
        replica before the socket dies, answer straggler submits with a
        typed :class:`Draining` reply, let every in-flight stream
        generate to its FIN within ``drain_timeout``, then close."""
        self._started = False
        with self._hb_lock:
            hbs, self._heartbeats = dict(self._heartbeats), {}
        for hb in hbs.values():
            hb.stop(bye=True)
        if drain:
            self.service.draining = True
            deadline = time.monotonic() + drain_timeout
            for name, eng in sorted(self.engines.items()):
                left = max(0.1, deadline - time.monotonic())
                if not eng.drain(timeout=left):
                    _flight.note("decode_drain_timeout", model=name,
                                 endpoint=self.endpoint)
        for model in self.engines:
            _canary.unregister_target(replica_key(model, self.replica_id))
        # drain: mid-reply connections (a stream's trailing FIN frame)
        # get a bounded grace before the transport severs them
        self._server.stop(graceful_s=2.0 if drain else 0.0)
        if self._own_engines:
            for eng in self.engines.values():
                eng.close()

    def install_sigterm_drain(self, drain_timeout: float = 60.0) -> None:
        """Arm SIGTERM as the graceful-drain trigger (what a supervisor
        shrink or an orchestrator rolling restart sends).  The handler
        runs :meth:`stop(drain=True)` on a daemon thread — signal
        handlers must return fast — and only AFTER the drain completes
        re-delivers SIGTERM under the PREVIOUS disposition, so the
        flight recorder's dump-then-die handler (or plain default
        termination) still runs, but post-drain instead of cutting the
        streams it was about to dump.  The previous disposition is
        restored immediately in the handler, so a SECOND SIGTERM during
        the drain escalates to the old immediate behavior.  Main
        thread only (signal module contract)."""
        import os as _os
        import signal as _signal

        prev = _signal.getsignal(_signal.SIGTERM)

        def _on_term(signum, frame):
            _flight.note("decode_sigterm_drain", endpoint=self.endpoint)
            # restore FIRST (handlers may only be set from the main
            # thread — the drain thread can't do it later)
            _signal.signal(_signal.SIGTERM, prev)

            def _drain_then_exit():
                try:
                    self.stop(drain=True, drain_timeout=drain_timeout)
                finally:
                    # hand the signal to its original disposition:
                    # flight dump + death, or default termination
                    _os.kill(_os.getpid(), _signal.SIGTERM)

            threading.Thread(target=_drain_then_exit, daemon=True,
                             name="decode-drain").start()

        _signal.signal(_signal.SIGTERM, _on_term)

    # -- registry announce -------------------------------------------------
    def _model_health(self, model: str):
        def probe() -> dict:
            eng = self.engines.get(model)
            return {"step": eng.stats.tokens.value if eng else 0}
        return probe

    def _model_data(self, model: str):
        def data() -> dict:
            out = {"model": model, "endpoint": self.endpoint}
            eng = self.engines.get(model)
            if eng is not None:
                z = eng.decodez()
                out["tokens"] = z["tokens"]
                out["queue_depth"] = z["queue_depth"]
                out["slots_active"] = sum(
                    s is not None for s in z["slots"])
                # token-level tail SLOs ride the lease payload so the
                # fleet sees each replica's TTFT/TBT p99 without
                # scraping it (present iff FLAGS_phase_attribution)
                for k in ("ttft_p99_ms", "tbt_p99_ms"):
                    if k in z:
                        out[k] = z[k]
                # capacity headroom rides the same lease payload
                # (present iff FLAGS_capacity_attribution with
                # completed work): the fleet reads saturation, not
                # just liveness
                cap = eng.stats.capacity()
                if cap is not None:
                    hr = cap.headroom()
                    if hr is not None:
                        out.update(hr)
            # correctness plane rides the same lease (canary streaks
            # present iff FLAGS_canary_probe; per-stream token-hash
            # digests present iff FLAGS_divergence_check) — the
            # supervisor's sentinel groups them across replicas
            can = _canary.lease_rider(replica_key(model, self.replica_id))
            if can is not None:
                out["canary"] = can
            dig = _audit.recent_digests()
            if dig is not None and model in dig:
                out["digests"] = {model: dig[model]}
            # memory anatomy rides the same lease (present iff
            # FLAGS_memory_attribution and pools registered): measured
            # KV-pool byte headroom for the ElasticController
            mem = _memory.lease_rider()
            if mem is not None:
                out.update(mem)
            return out
        return data

    # -- golden canary targets ---------------------------------------------
    def _canary_submit(self, model: str):
        """A probe submit fn through the real decode submit path
        (engine admission -> prefill -> continuous-batch steps).
        Golden feeds: ``prompt`` (int ids) plus an optional
        ``max_new_tokens`` scalar; the reply is the greedy token
        stream as ``[("tokens", int32[n])]`` so the prober's generic
        pair comparison applies (exact match — token ids carry no
        rtol)."""
        def submit(feeds: dict, tenant: Optional[str]):
            eng = self.engines.get(model)
            if eng is None:
                raise RuntimeError(f"canary probe: no engine {model!r}")
            prompt = np.asarray(feeds["prompt"], np.int32).reshape(-1)
            mnt = 8
            if "max_new_tokens" in feeds:
                mnt = int(np.asarray(
                    feeds["max_new_tokens"]).reshape(-1)[0])
            handle = eng.submit(prompt,
                                SamplingParams(max_new_tokens=mnt),
                                tenant=tenant)
            from ..core import flags as _flags
            final = handle.result(
                timeout=float(_flags.get_flags("rpc_deadline")))
            return [("tokens", np.asarray(final["tokens"], np.int32))]
        return submit

    def _sync_canary_targets(self) -> None:
        """Mirror :meth:`_sync_announcements` for the prober's target
        registry (works registry-less too) — a no-op unless armed."""
        if not _canary.enabled() or not self._started:
            return
        for model in self.engines:
            _canary.register_target(
                replica_key(model, self.replica_id), model,
                self._canary_submit(model))

    def _sync_announcements(self) -> None:
        """One registry heartbeat per served model (the serving plane's
        announce discipline with role DECODE)."""
        if not self.registry_ep or not self._started:
            return
        names = set(self.engines)
        with self._hb_lock:
            for model in sorted(names - set(self._heartbeats)):
                hb = _registry.Heartbeat(
                    self.registry_ep, replica_key(model, self.replica_id),
                    self.endpoint, ttl=self.lease_ttl, role="DECODE",
                    health_fn=self._model_health(model),
                    data_fn=self._model_data(model))
                hb.start()
                self._heartbeats[model] = hb
            for model in sorted(set(self._heartbeats) - names):
                self._heartbeats.pop(model).stop(bye=True)
