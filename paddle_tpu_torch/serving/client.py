"""Thin serving client: replica discovery + health-gated failover.

The port's copy of ``paddle_tpu/serving/client.py``.

The trainer-side counterpart of :class:`~paddle_tpu_torch.serving.server
.ModelServer`.  Two addressing modes:

- **static**: ``ServingClient(endpoints=["host:port", ...])`` —
  round-robin over a fixed replica list;
- **registry**: ``ServingClient(registry_ep="host:port")`` — replicas
  are discovered from the serving leases
  (``serving/<model>/<replica>``) the servers announce, re-polled every
  ``refresh_s``; replicas whose fleet-health state is DEAD are never
  routed to (health gating), and a replica that refuses a connection is
  benched for ``cooldown_s`` before it is tried again.

Failover policy per request: connection failures rotate to the next
live replica (an INFER that never reached a server is safe to resend);
a typed :class:`Overloaded` reply also rotates — some other replica may
have queue headroom — and only surfaces to the caller when EVERY live
replica shed the request.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batcher import Draining, Overloaded, RequestTooLong
from . import server as _server
from ..distributed import registry as _dist_registry
from ..distributed import serde, transport


class ServingClient:
    def __init__(self, endpoints: Optional[Sequence[str]] = None,
                 registry_ep: Optional[str] = None, trainer_id: int = 0,
                 refresh_s: float = 2.0, cooldown_s: float = 2.0,
                 connect_timeout_s: float = 5.0):
        if not endpoints and not registry_ep:
            raise ValueError("ServingClient needs endpoints or registry_ep")
        self._static = list(endpoints or [])
        self.registry_ep = registry_ep
        self.refresh_s = refresh_s
        self.cooldown_s = cooldown_s
        # interactive inference must not ride out the transport's
        # trainer-bring-up connect grace on a dead replica: bound each
        # connect attempt and let failover rotate instead
        self.connect_timeout_s = connect_timeout_s
        self._client = transport.RPCClient(trainer_id)
        self._lock = threading.Lock()
        self._rr: Dict[str, int] = {}            # model -> round-robin idx
        self._down: Dict[str, float] = {}        # endpoint -> benched-until
        self._cache: Dict[str, Tuple[float, List[str]]] = {}

    # -- discovery ---------------------------------------------------------
    def _discover(self, model: str) -> List[str]:
        """Live replica endpoints for ``model`` from the registry
        leases, DEAD replicas health-gated out.  Static mode returns
        the fixed list."""
        if not self.registry_ep:
            return list(self._static)
        with self._lock:
            ent = self._cache.get(model)
            if ent is not None and time.monotonic() < ent[0]:
                return list(ent[1])
        try:
            snap = _dist_registry.fetch_snapshot(self._client,
                                                 self.registry_ep)
        except Exception:
            # registry blip (restart, partition): the replicas are very
            # likely still serving — route on the last-known set rather
            # than failing the request on a discovery error
            with self._lock:
                ent = self._cache.get(model)
                if ent is not None and ent[1]:
                    return list(ent[1])
            raise
        try:
            health = _dist_registry.fetch_health(self._client,
                                                 self.registry_ep)
        except Exception:
            health = {}
        eps = []
        for logical, lease in sorted((snap.get("leases") or {}).items()):
            parsed = _server.parse_replica_key(logical)
            if parsed is None or parsed[0] != model:
                continue
            if (health.get(logical) or {}).get("state") == "DEAD":
                continue
            eps.append(lease["endpoint"])
        with self._lock:
            self._cache[model] = (time.monotonic() + self.refresh_s, eps)
        return eps

    def replicas(self, model: str) -> List[str]:
        """The endpoints a request for ``model`` may route to."""
        return self._discover(model)

    def _routable(self, model: str) -> List[str]:
        eps = self._discover(model)
        now = time.monotonic()
        with self._lock:
            live = [e for e in eps if self._down.get(e, 0.0) <= now]
            # every replica benched: desperation beats refusing outright
            return live or eps

    def _bench(self, endpoint: str) -> None:
        with self._lock:
            self._down[endpoint] = time.monotonic() + self.cooldown_s

    # -- inference ---------------------------------------------------------
    def infer_pairs(self, model: str,
                    feed: Dict[str, np.ndarray],
                    tenant: Optional[str] = None) -> List[Tuple[str, object]]:
        """One inference: returns the server's fetch ``(name, array)``
        pairs, failing over across replicas (module doc).  ``tenant``
        rides as a reserved serde pair ONLY when set — absent, the
        frame is byte-identical to tenant-unaware builds, and an old
        server ignores the extra feed (interop both ways)."""
        pairs = [(n, np.asarray(v)) for n, v in sorted(feed.items())]
        if tenant:
            pairs.append((_server.TENANT_FEED_KEY,
                          np.frombuffer(str(tenant).encode("utf-8"),
                                        np.uint8)))
        payload = serde.dumps_batch_vec(pairs)
        eps = self._routable(model)
        if not eps:
            raise RuntimeError(f"no live replicas for model {model!r}")
        with self._lock:
            start = self._rr.get(model, 0)
            self._rr[model] = start + 1
        last_exc: Optional[Exception] = None
        for i in range(len(eps)):
            ep = eps[(start + i) % len(eps)]
            try:
                body = self._client._raw_request(
                    ep, _server.INFER, model, payload,
                    connect_timeout=self.connect_timeout_s)
            except ConnectionError as e:
                self._bench(ep)
                last_exc = e
                continue
            body = memoryview(bytes(body)) if not isinstance(
                body, memoryview) else body
            tag, rest = bytes(body[:1]), body[1:]
            if tag == _server._TAG_OVERLOAD:
                last_exc = Overloaded.from_dict(
                    json.loads(bytes(rest).decode("utf-8")))
                continue  # another replica may have headroom
            if tag == _server._TAG_DRAINING:
                # graceful shutdown straggler: the replica already
                # deregistered — bench it so the next refresh window
                # doesn't re-route here, and rotate NOW
                self._bench(ep)
                last_exc = Draining.from_dict(
                    json.loads(bytes(rest).decode("utf-8")))
                continue
            if tag == _server._TAG_TOO_LONG:
                # terminal: every replica enforces the same max_seq_len,
                # so failing over would just repeat the rejection
                raise RequestTooLong.from_dict(
                    json.loads(bytes(rest).decode("utf-8")))
            return serde.loads_batch(rest, copy=True)
        raise last_exc if last_exc is not None else RuntimeError(
            f"no replica answered for model {model!r}")

    def infer(self, model: str,
              feed: Dict[str, np.ndarray],
              tenant: Optional[str] = None) -> List[np.ndarray]:
        """Fetch arrays in the server's fetch order."""
        return [np.asarray(v)
                for _, v in self.infer_pairs(model, feed, tenant=tenant)]

    # -- admin -------------------------------------------------------------
    def admin(self, endpoint: str, command: dict) -> dict:
        """One SERVING_ADMIN command against a specific server (status,
        load, swap, activate, retire — see :mod:`server`)."""
        out = self._client._raw_request(
            endpoint, _server.SERVING_ADMIN, command.get("cmd", ""),
            json.dumps(command).encode("utf-8"))
        return json.loads(bytes(out).decode("utf-8"))
