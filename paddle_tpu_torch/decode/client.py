"""Thin streaming decode client: replica discovery + token iterator.

The port's copy of ``paddle_tpu/decode/client.py``.

The generative counterpart of
:class:`~paddle_tpu_torch.serving.client.ServingClient`.  A DECODE request's
reply is a FRAME STREAM (one frame per token chunk — see
:mod:`paddle_tpu_torch.decode.server` for the tag grammar), so each
generation opens its OWN connection off the shared RPC pool: a stream
occupies its connection until the FIN frame, and striped reuse would
interleave two streams' frames.

Failover policy: a connection failure BEFORE the first token rotates
to the next replica (nothing was generated — safe to resend); after
the first token it surfaces — the stream is stateful and a blind
resend would bill the prompt twice.  A typed ``Overloaded`` rotates;
``RequestTooLong`` raises immediately (every replica enforces the same
bound).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import server as _server
from ..distributed import registry as _dist_registry
from ..distributed import serde, transport
from ..serving.batcher import Draining, Overloaded, RequestTooLong


class DecodeClient:
    def __init__(self, endpoints: Optional[Sequence[str]] = None,
                 registry_ep: Optional[str] = None, trainer_id: int = 0,
                 refresh_s: float = 2.0,
                 connect_timeout: float = 10.0):
        if not endpoints and not registry_ep:
            raise ValueError("DecodeClient needs endpoints or registry_ep")
        self._static = list(endpoints or [])
        self.registry_ep = registry_ep
        self.refresh_s = refresh_s
        self.connect_timeout = connect_timeout
        # discovery + admin ride the shared striped pool; streams don't
        self._rpc = transport.RPCClient(trainer_id)
        self._lock = threading.Lock()
        self._rr: Dict[str, int] = {}
        self._cache: Dict[str, Tuple[float, List[str]]] = {}

    # -- discovery (the ServingClient pattern over decode/ leases) ---------
    def replicas(self, model: str) -> List[str]:
        if not self.registry_ep:
            return list(self._static)
        with self._lock:
            ent = self._cache.get(model)
            if ent is not None and time.monotonic() < ent[0]:
                return list(ent[1])
        snap = _dist_registry.fetch_snapshot(self._rpc, self.registry_ep)
        try:
            health = _dist_registry.fetch_health(self._rpc,
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

    # -- generation --------------------------------------------------------
    def generate_stream(self, model: str, prompt, max_new_tokens: int = 32,
                        temperature: float = 0.0, top_k: int = 0,
                        seed: int = 0, eos_id: Optional[int] = None,
                        chunk_tokens: int = 1,
                        tenant: Optional[str] = None):
        """Yield generated token ids as they stream; the generator's
        return value (``StopIteration.value``) is the FIN dict.
        ``tenant`` adds a wire-optional id for per-tenant metering —
        the key is included ONLY when set, so requests without one are
        byte-identical to tenant-unaware builds (old servers ignore
        the unknown key)."""
        body = {
            "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature), "top_k": int(top_k),
            "seed": int(seed), "eos_id": eos_id,
            "chunk_tokens": int(chunk_tokens)}
        if tenant:
            body["tenant"] = str(tenant)
        req = json.dumps(body).encode("utf-8")
        eps = self.replicas(model)
        if not eps:
            raise RuntimeError(f"no live decode replicas for {model!r}")
        with self._lock:
            start = self._rr.get(model, 0)
            self._rr[model] = start + 1
        last_exc: Optional[Exception] = None
        for i in range(len(eps)):
            ep = eps[(start + i) % len(eps)]
            stream = self._open_stream(ep, model, req)
            try:
                # force the first frame NOW: connection failures and
                # typed Overloaded can still rotate replicas (nothing
                # was generated); after this, the stream is stateful
                first = next(stream, None)
            except (ConnectionError, OSError) as e:
                last_exc = e
                continue
            except Overloaded as e:
                last_exc = e   # another replica may have slot headroom
                continue
            except Draining as e:
                last_exc = e   # graceful shutdown straggler: rotate
                continue
            return self._relay(first, stream)
        raise last_exc if last_exc is not None else RuntimeError(
            f"no decode replica answered for {model!r}")

    @staticmethod
    def _relay(first, stream):
        def gen():
            item = first
            while item is not None:
                if isinstance(item, dict):   # FIN
                    return item
                for t in item:
                    yield int(t)
                item = next(stream, None)
            return {}
        return gen()

    def generate(self, model: str, prompt, timeout: float = 120.0,
                 **kw) -> dict:
        """Blocking aggregate: ``{"tokens": [...], "finish":, ...}``."""
        toks: List[int] = []
        final = {}
        gen = self.generate_stream(model, prompt, **kw)
        deadline = time.monotonic() + timeout
        while True:
            try:
                toks.append(next(gen))
            except StopIteration as stop:
                final = stop.value or {}
                break
            if time.monotonic() > deadline:
                gen.close()
                raise TimeoutError(
                    f"decode of {model!r} exceeded {timeout}s")
        out = {"tokens": toks}
        out.update(final)
        return out

    def _open_stream(self, endpoint: str, model: str, payload: bytes):
        """Dedicated-connection frame reader: yields int32 token arrays
        (T frames) then the FIN dict; raises typed Overloaded /
        RequestTooLong / RuntimeError (ERR frame).  The connection
        closes with the generator (FIN, error, or caller .close())."""
        def frames():
            host, port = endpoint.rsplit(":", 1)
            io = transport._connect_io(host, int(port),
                                       self.connect_timeout)
            try:
                bufs = transport._pack_body_vec(
                    _server.DECODE, 0, model, [payload])
                transport._send_frame_any(io, bufs)
                while True:
                    body = io.recv_frame()
                    if body is None:
                        raise ConnectionError(
                            f"decode replica {endpoint} closed mid-stream")
                    rtype, _, _, rpayload = transport._unpack_body(body)
                    if rtype == transport.ERR:
                        raise RuntimeError(
                            "decode stream failed: "
                            + bytes(rpayload).decode("utf-8", "replace"))
                    tag = bytes(rpayload[:1])
                    rest = rpayload[1:]
                    if tag == _server._TAG_TOKENS:
                        pairs = serde.loads_batch(rest, copy=True)
                        yield np.asarray(pairs[0][1], np.int32)
                    elif tag == _server._TAG_FIN:
                        yield json.loads(bytes(rest).decode("utf-8"))
                        return
                    elif tag == _server._TAG_OVERLOAD:
                        raise Overloaded.from_dict(
                            json.loads(bytes(rest).decode("utf-8")))
                    elif tag == _server._TAG_TOO_LONG:
                        raise RequestTooLong.from_dict(
                            json.loads(bytes(rest).decode("utf-8")))
                    elif tag == _server._TAG_DRAINING:
                        raise Draining.from_dict(
                            json.loads(bytes(rest).decode("utf-8")))
                    else:
                        raise RuntimeError(
                            f"decode stream: unknown tag {tag!r}")
            finally:
                try:
                    io.close()
                except Exception:
                    pass

        return frames()

    # -- admin -------------------------------------------------------------
    def status(self, endpoint: str) -> dict:
        out = self._rpc._raw_request(
            endpoint, _server.DECODE_ADMIN, "status",
            json.dumps({"cmd": "status"}).encode("utf-8"))
        return json.loads(bytes(out).decode("utf-8"))
