"""Framed-TCP variable transport: RPC client/server for pserver mode.

The port's copy of ``paddle_tpu/distributed/transport.py``.

TPU-native replacement for the reference's gRPC transport
(``paddle/fluid/operators/distributed/grpc_client.h:175-206``,
``grpc_server.cc:82,117``, ``rpc_server.cc`` request barriers).  Runs over
DCN between TPU-VM hosts; intra-pod dense traffic rides XLA collectives
instead (parallel/), so this path only carries pserver/sparse variables.

The byte transport is pluggable (FLAGS_rpc_transport):

- ``native`` (default): the C transport in ``native/paddle_tpu_native.cc``
  — connect/accept/framing/partial-IO in C with TCP_NODELAY, mirroring
  the reference's C++ gRPC byte layer under Python request handlers
  (``request_handler_impl.cc`` split).
- ``python``: stdlib sockets (always available fallback).

Wire format (little-endian): one ``u32 body_len``-prefixed frame per
request and per response, body = ``u8 msg_type | i32 trainer_id |
u16 name_len | name | payload``.

Connections are persistent; each client connection is a serial
request/response channel (guarded by a lock), and the client fans out to
many endpoints concurrently via a shared thread pool — the analogue of the
reference's async completion queues + ``Wait`` (``grpc_client.h:180-213``).
``FLAGS_rpc_conns_per_endpoint`` stripes several connections per endpoint
so concurrent requests to ONE pserver (a batched round's sub-batches, a
storm of small vars) no longer serialize on a single connection lock —
the multi-channel ``grpc_client`` role (``GetChannel`` channel pools).
Server handlers may block (sync-mode barriers), so both server backends
are thread-per-connection like the reference's handler thread pools.

Batched frames (``SEND_VARS``/``GET_VARS``) carry many ``(name, value)``
pairs per round trip, and large tensor bodies are sent scatter-gather
(``socket.sendmsg``/``sendmsg(iovec)`` in the native backend) straight
from the ndarray — see ``serde.dumps_batch_vec``.
"""
from __future__ import annotations

import ctypes
import os
import socket
import socketserver
import sys as _sys
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import serde
from ..observability import flight as _flight
from ..observability import stats as _obs_stats
from ..observability import trace as _trace
from ..observability.trace import flags_on as _telemetry_on

# message types (request)
SEND_VAR = 1
GET_VAR = 2
BATCH_BARRIER = 3
FETCH_BARRIER = 4
COMPLETE = 5
PREFETCH = 6
CHECKPOINT_NOTIFY = 7
# batched var transport: one frame carries many (name, value) pairs —
# the round-trip-per-variable cost of SEND_VAR/GET_VAR amortized to one
# RPC per pserver per round (the reference's async completion-queue
# pipelining, collapsed into explicit batch frames).  Message-type ids
# share ONE namespace across every service (registry.py holds 8-10 and
# 13, master.py 16-20, STATS_PULL 24) so telemetry labels stay
# unambiguous
SEND_VARS = 11
GET_VARS = 12
# HA pserver replication (ps_ops.PServerLoop): the primary streams every
# applied SEND_VARS batch / barrier to its backup under a monotonic
# apply-sequence number; only flows when a backup is configured
REPLICATE = 14
# fleet observability (observability/aggregate.py): answered centrally by
# _serve_io for EVERY service object, so any RPCServer — pserver, master,
# registry — can be scraped for its process-local metric snapshot
STATS_PULL = 24
# distributed tracing (observability/trace.py): pull this process's
# bounded span ring — answered centrally like STATS_PULL, so trainer 0
# (or tools/stitch_trace.py) can stitch a fleet-wide trace from any
# worker's RPC port
TRACE_PULL = 25
# message types (response)
OK = 0
ERR = 255
# streaming handler verdict (NOT a wire status — never leaves the
# server): a service returning ``(STREAM, iterator)`` has _serve_io
# send one OK frame per yielded chunk on the SAME connection, in
# order, then resume the request loop.  The receiver owns framing the
# end of the stream at the application layer (the decode plane's FIN
# tag) — the transport just moves frames.  This is what the DECODE
# msg type rides: token chunks stream over the existing zero-copy
# scatter-gather send path with no new wire format.
STREAM = 254

MSG_NAMES = {SEND_VAR: "send_var", GET_VAR: "get_var",
             SEND_VARS: "send_vars", GET_VARS: "get_vars",
             BATCH_BARRIER: "batch_barrier", FETCH_BARRIER: "fetch_barrier",
             COMPLETE: "complete", PREFETCH: "prefetch",
             CHECKPOINT_NOTIFY: "checkpoint_notify",
             REPLICATE: "replicate",
             STATS_PULL: "stats_pull", TRACE_PULL: "trace_pull"}

_HDR = struct.Struct("<BiH")  # msg_type, trainer_id, name_len

# Trace-context frame extension: the high bit of msg_type says "a
# compact trace context (trace.WIRE_CTX_SIZE bytes) sits between the
# name and the payload".  Real message types stay < 0x80 (ERR=255 is a
# response type and is excluded from the flag check), so a frame
# WITHOUT the extension is byte-identical to the pre-trace wire format
# — old peers interop untouched as long as sampling is off, which is
# the default.  Enable FLAGS_trace_sample_rate only on an upgraded
# fleet.
TRACE_CTX_FLAG = 0x80

_CONNECT_TIMEOUT = 120.0

# RPC latency buckets (ms): LAN round trips through multi-second
# sync-barrier waits and tunneled DCN links
_RPC_MS_BUCKETS = (0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                   250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def _backend() -> str:
    from ..core import flags

    try:
        want = flags.get_flags("rpc_transport")
    except KeyError:  # pragma: no cover
        want = "native"
    if want == "native" and _native_lib() is None:
        return "python"
    return want


_native = None
_native_failed = False


def _native_lib():
    global _native, _native_failed
    if _native is None and not _native_failed:
        try:
            from ..data import native as _n
            _native = _n.load()
        except Exception:  # pragma: no cover - build env without g++
            _native_failed = True
    return _native


def _pack_body(msg_type: int, trainer_id: int, name: str,
               payload: bytes, ctx: Optional[bytes] = None) -> bytes:
    nm = name.encode("utf-8")
    if ctx:
        return (_HDR.pack(msg_type | TRACE_CTX_FLAG, trainer_id, len(nm))
                + nm + ctx + payload)
    return _HDR.pack(msg_type, trainer_id, len(nm)) + nm + payload


def _pack_body_vec(msg_type: int, trainer_id: int, name: str,
                   payload_bufs: Sequence,
                   ctx: Optional[bytes] = None) -> list:
    """Scatter-gather body: header bytes + the payload buffer list
    untouched (tensor bodies stay views; see serde.dumps_value_vec).
    Zero-length buffers are dropped so empty-payload control messages
    (barriers, COMPLETE) keep the single-buffer fast path.  ``ctx``
    (a sampled trace context) rides between name and payload under the
    TRACE_CTX_FLAG msg-type bit; None adds zero bytes."""
    nm = name.encode("utf-8")
    if ctx:
        head = (_HDR.pack(msg_type | TRACE_CTX_FLAG, trainer_id, len(nm))
                + nm + ctx)
    else:
        head = _HDR.pack(msg_type, trainer_id, len(nm)) + nm
    return [head, *[b for b in payload_bufs if len(b)]]


def _unpack_body_ext(body: bytes):
    """Returns (msg_type, trainer_id, name, payload, ctx_bytes) —
    ``payload`` is a zero-copy memoryview over ``body`` (a 64 MB inbound
    gradient frame must not pay a full slice copy before
    ``loads_batch(copy=False)`` builds its views); ``ctx_bytes`` is the
    raw trace-context extension or None.  A frame without the extension
    parses exactly as the pre-trace format."""
    raw, trainer_id, name_len = _HDR.unpack_from(body, 0)
    off = _HDR.size
    name = bytes(body[off:off + name_len]).decode("utf-8")
    off += name_len
    ctx = None
    msg_type = raw
    if raw != ERR and raw & TRACE_CTX_FLAG:
        msg_type = raw & ~TRACE_CTX_FLAG
        ctx = bytes(body[off:off + _trace.WIRE_CTX_SIZE])
        off += _trace.WIRE_CTX_SIZE
    return msg_type, trainer_id, name, memoryview(body)[off:], ctx


def _unpack_body(body: bytes):
    """4-tuple form of :func:`_unpack_body_ext` (trace context, if any,
    is parsed off and dropped)."""
    msg_type, trainer_id, name, payload, _ = _unpack_body_ext(body)
    return msg_type, trainer_id, name, payload


def _int_flag(name: str, default: int) -> int:
    from ..core import flags
    try:
        return int(flags.get_flags(name))
    except (KeyError, TypeError, ValueError):  # pragma: no cover
        return default


def _vectored_on() -> bool:
    from ..core import flags
    try:
        return bool(flags.get_flags("rpc_vectored_io"))
    except KeyError:  # pragma: no cover
        return True


def _send_frame_any(io, bufs: list) -> Tuple[int, bool]:
    """Send one frame from a buffer list; returns (nbytes, vectored).

    Single-buffer bodies and flag-off runs take the classic one-buffer
    path; everything else goes scatter-gather (``sendmsg``/``writev`` —
    no Python-level concat of tensor bytes)."""
    nbytes = serde.buffers_nbytes(bufs)
    if nbytes >= 1 << 32:
        # the u32 frame-length prefix cannot carry it; without this
        # guard the native path would TRUNCATE the length silently and
        # desynchronize the stream.  Shard the variable (slice_var_up)
        # or lower FLAGS_rpc_stripe_chunk_bytes to keep frames smaller.
        raise ValueError(
            f"RPC frame of {nbytes} bytes exceeds the u32 frame limit "
            "(4 GiB); split the batch or shard the variable")
    if len(bufs) == 1:
        io.send_frame(bufs[0] if isinstance(bufs[0], bytes)
                      else bytes(bufs[0]))
        return nbytes, False
    if _vectored_on():
        io.send_frame_vec(bufs)
        return nbytes, True
    io.send_frame(b"".join(bufs))
    return nbytes, False


# ---------------------------------------------------------------------------
# byte-frame IO backends
# ---------------------------------------------------------------------------

class _PyIO:
    """u32-framed stdlib-socket IO."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    @classmethod
    def connect(cls, host: str, port: int, timeout: float) -> "_PyIO":
        deadline = time.time() + timeout
        last = None
        while True:
            # per-attempt timeout capped by the REMAINING deadline so a
            # SYN-black-holing peer honors short failover deadlines
            attempt = max(0.2, min(30.0, deadline - time.time()))
            try:
                s = socket.create_connection((host, port), timeout=attempt)
                s.settimeout(None)
                return cls(s)
            except OSError as e:  # pserver may not be up yet
                last = e
                if time.time() > deadline:
                    raise ConnectionError(
                        f"cannot reach pserver at {host}:{port}: {last}")
                time.sleep(0.1)

    def send_frame(self, body: bytes) -> None:
        try:
            self.sock.sendall(struct.pack("<I", len(body)) + body)
        except OSError as e:
            # normalize EVERY socket failure (EPIPE, EBADF, ETIMEDOUT,
            # ...) to ConnectionError: the retry/at-most-once discipline
            # in RPCClient keys on that type
            raise ConnectionError(f"send failed: {e}") from e

    # sendmsg iovec batches stay comfortably under IOV_MAX (1024 on
    # Linux); a 256-var batch is ~513 buffers
    _IOV_BATCH = 512

    def send_frame_vec(self, buffers: Sequence) -> None:
        """Scatter-gather frame: u32 length prefix + every buffer via
        ``socket.sendmsg`` — tensor bytes go from the ndarray views to
        the kernel with no userspace concat copy."""
        views = [b if isinstance(b, (bytes, bytearray))
                 else memoryview(b).cast("B") for b in buffers]
        total = sum(len(v) for v in views)
        views.insert(0, struct.pack("<I", total))
        idx, off = 0, 0
        try:
            while idx < len(views):
                batch = [memoryview(views[idx])[off:],
                         *views[idx + 1:idx + self._IOV_BATCH]]
                sent = self.sock.sendmsg(batch)
                while idx < len(views) and sent >= len(views[idx]) - off:
                    sent -= len(views[idx]) - off
                    idx, off = idx + 1, 0
                off += sent
        except OSError as e:
            raise ConnectionError(f"vectored send failed: {e}") from e

    def recv_frame(self) -> Optional[bytes]:
        raw = self._recv_exact(4)
        if raw is None:
            return None
        (blen,) = struct.unpack("<I", raw)
        return self._recv_exact(blen)

    def _recv_exact(self, n: int) -> Optional[bytes]:
        chunks = []
        while n:
            try:
                b = self.sock.recv(min(n, 1 << 20))
            except OSError:
                return None
            if not b:
                return None
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class _NativeIO:
    """C-transport IO (framing + partial reads/writes in native code).

    Handle lifetime: exactly one thread sends/receives on an IO at a time
    (client conns serialize under _Conn.lock; the server's serving thread
    is the sole reader).  ``shutdown`` only wakes a blocked reader;
    ``close`` frees — both serialized by ``_hlock`` so a raced shutdown
    never touches a freed handle."""

    def __init__(self, handle):
        self._h = handle
        self._lib = _native_lib()
        self._hlock = threading.Lock()

    @classmethod
    def connect(cls, host: str, port: int, timeout: float) -> "_NativeIO":
        lib = _native_lib()
        h = lib.ptq_conn_connect(host.encode(), int(port), float(timeout))
        if not h:
            raise ConnectionError(f"cannot reach pserver at {host}:{port}")
        return cls(h)

    def send_frame(self, body: bytes) -> None:
        h = self._h
        if not h:
            raise ConnectionError("native transport: connection closed")
        if self._lib.ptq_conn_send_frame(h, body, len(body)) != 0:
            raise ConnectionError("native transport: send failed")

    def send_frame_vec(self, buffers: Sequence) -> None:
        """Scatter-gather frame through the C transport's sendmsg/iovec
        path (``ptq_conn_send_frame_vec``): buffer addresses are taken
        via zero-copy uint8 views; ``arrs`` pins them for the call."""
        h = self._h
        if not h:
            raise ConnectionError("native transport: connection closed")
        arrs = [np.frombuffer(b, np.uint8) for b in buffers]
        n = len(arrs)
        ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
        lens = (ctypes.c_size_t * n)(*[a.nbytes for a in arrs])
        if self._lib.ptq_conn_send_frame_vec(h, ptrs, lens, n) != 0:
            raise ConnectionError("native transport: vectored send failed")

    def recv_frame(self) -> Optional[bytes]:
        h = self._h
        if not h:
            return None
        n = ctypes.c_size_t()
        p = self._lib.ptq_conn_recv_frame(h, ctypes.byref(n))
        if not p:
            return None
        try:
            return ctypes.string_at(p, n.value)
        finally:
            self._lib.ptq_buffer_free(p)

    def shutdown(self) -> None:
        with self._hlock:
            if self._h:
                self._lib.ptq_conn_shutdown(self._h)

    def close(self) -> None:
        with self._hlock:
            if self._h:
                self._lib.ptq_conn_close(self._h)
                self._h = None


def _connect_io(host: str, port: int, timeout: float):
    if _backend() == "native":
        return _NativeIO.connect(host, port, timeout)
    return _PyIO.connect(host, port, timeout)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def _handle_request(service, msg_type: int, tid: int, name: str, payload):
    """One request against the service, with the observability messages
    (STATS_PULL/TRACE_PULL) answered centrally so EVERY service —
    pserver, master, registry — is scrapable without changes."""
    if msg_type == STATS_PULL:
        from ..observability import aggregate as _obs_aggregate
        return OK, _obs_aggregate.local_snapshot_payload()
    if msg_type == TRACE_PULL:
        from ..observability import aggregate as _obs_aggregate
        return OK, _obs_aggregate.local_trace_payload()
    return service.handle(msg_type, tid, name, payload)


def _serve_io(io, service) -> None:
    """Request loop for one connection (either backend).

    ``service.handle`` may return its payload as ``bytes`` or as a
    scatter-gather buffer list (a ``GET_VARS`` reply streams tensor
    views with no concat copy).  A frame carrying a sampled trace
    context gets a server-side span parented under the inbound context
    — the cross-process half of the Dapper stitch; the span covers the
    WHOLE handle (including any sync-barrier block, which is exactly
    the wait a stitched timeline needs to show)."""
    from . import faults as _faults
    if _faults.active() and _faults.accept_fault():
        return               # injected refuse_accept: slam the connection
    while True:
        body = io.recv_frame()
        if body is None:
            return
        # busy marker for graceful stops: from request received to
        # reply written this connection must not be severed by
        # stop(graceful_s=...) — the serving plane's drain promises the
        # accepted request's REPLY, not just its handler return
        io.busy = True
        tel = _telemetry_on()
        t0 = time.perf_counter() if tel else None
        msg_type, tid, name, payload, wctx = _unpack_body_ext(body)
        if _faults.active() and _faults.server_fault(
                MSG_NAMES.get(msg_type, str(msg_type))) is not None:
            # injected drop_conn: sever before the handler runs — to the
            # peer this is indistinguishable from the server dying with
            # the request in flight (the retry/at-most-once paths' case)
            return
        sctx = _trace.ctx_from_wire(wctx) if wctx else None
        try:
            if sctx is not None:
                with _trace.start_span(
                        "rpc.server::" + MSG_NAMES.get(msg_type,
                                                       str(msg_type)),
                        cat="rpc", parent=sctx, root=False,
                        tags={"trainer_id": tid}):
                    rtype, rpayload = _handle_request(service, msg_type,
                                                      tid, name, payload)
            else:
                rtype, rpayload = _handle_request(service, msg_type, tid,
                                                  name, payload)
        except Exception as e:
            rtype, rpayload = ERR, repr(e).encode("utf-8")
        if rtype is None:
            # handler-requested drop: close WITHOUT responding — the
            # lost-response window of a peer dying mid-request (the
            # at-most-once failure-path tests inject through this)
            return
        if rtype == STREAM:
            # multi-frame reply: one OK frame per yielded chunk (bytes
            # or scatter-gather buffer list).  A generator fault mid-
            # stream becomes a trailing ERR frame — the client sees a
            # typed error, not a silent truncation; a ConnectionError
            # means the peer went away, stop serving this conn.
            try:
                for chunk in rpayload:
                    bufs = _pack_body_vec(
                        OK, tid, name,
                        chunk if isinstance(chunk, list) else [chunk])
                    _send_frame_any(io, bufs)
                    if tel:
                        _obs_stats.scope("rpc.server").counter(
                            "stream_frames").inc()
            except ConnectionError:
                # peer vanished mid-stream: close the generator NOW so
                # its finally-cleanup (the decode plane cancels the
                # abandoned request there) runs deterministically, not
                # at some future GC
                close = getattr(rpayload, "close", None)
                if callable(close):
                    try:
                        close()
                    except Exception:
                        pass
                return
            except Exception as e:
                try:
                    _send_frame_any(io, _pack_body_vec(
                        ERR, tid, name, [repr(e).encode("utf-8")]))
                except ConnectionError:
                    return
            io.busy = False
            continue
        resp_bufs = _pack_body_vec(rtype, tid, name,
                                   rpayload if isinstance(rpayload, list)
                                   else [rpayload])
        if tel:
            sc = _obs_stats.scope("rpc.server")
            sc.counter("requests." + MSG_NAMES.get(msg_type,
                                                   str(msg_type))).inc()
            sc.counter("bytes_in").inc(len(body))
            sc.counter("bytes_out").inc(serde.buffers_nbytes(resp_bufs))
            if msg_type in (SEND_VARS, GET_VARS) and len(payload) >= 4:
                # batch frames carry their pair count up front
                sc.counter("batched_vars").inc(
                    struct.unpack_from("<I", payload)[0])
            if rtype == ERR:
                sc.counter("handler_errors").inc()
            # includes any time the handler BLOCKED on a sync-mode
            # barrier — a saturated histogram tail here is the signature
            # of one slow trainer stalling the round
            sc.histogram("handle_ms", buckets=_RPC_MS_BUCKETS).observe(
                (time.perf_counter() - t0) * 1e3)
        try:
            nbytes, vectored = _send_frame_any(io, resp_bufs)
            if tel and vectored:
                _obs_stats.scope("rpc.server").counter(
                    "vectored_bytes").inc(nbytes)
        except ConnectionError:
            return
        io.busy = False


class RPCServer:
    """Serves variable requests against a pluggable service object.

    ``service.handle(msg_type, trainer_id, name, payload)`` returns
    ``(resp_type, resp_payload)`` and may block (barriers).  Reference:
    ``AsyncGRPCServer`` + ``RequestHandler`` (``grpc_server.cc:82``,
    ``request_handler_impl.cc``).
    """

    def __init__(self, endpoint: str, service):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self.service = service
        self._impl = (_NativeServer(host, int(port), service)
                      if _backend() == "native"
                      else _PyServer(host, int(port), service))
        # Explicit readiness signal (VERDICT r4 #5): both impls have
        # BOUND AND LISTENING by now, so announce it — launchers wait on
        # the file instead of poll-connecting (the reference's
        # _wait_ps_ready sleep loop, test_dist_base.py:232, improved).
        ready_dir = os.environ.get("PADDLE_READY_DIR")
        if ready_dir:
            os.makedirs(ready_dir, exist_ok=True)
            path = os.path.join(ready_dir, f"{host}:{self._impl.port}.ready")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(self.endpoint)
            os.replace(tmp, path)  # atomic: waiters never see a partial

    @property
    def port(self) -> int:
        return self._impl.port

    def start(self) -> None:
        # every serving process is debug-scrapable when the flag asks
        # for it (no-op, no socket, at the default flag value 0), and
        # leaves a flight-recorder post-mortem when armed
        from ..observability import debug_server as _debug_server
        _debug_server.maybe_start_from_flags()
        _flight.arm_from_flags()
        self._impl.start()

    def stop(self, graceful_s: float = 0.0) -> None:
        """``graceful_s > 0``: bounded wait for connections that are
        mid-reply (request received, reply not yet written) before
        severing — the serving drain's reply guarantee.  Default 0
        keeps the immediate-stop behavior everywhere else."""
        self._impl.stop(graceful_s)


_HOST_NORM_CACHE: Dict[str, str] = {}


def _normalize_host(host: str) -> str:
    """Canonical spelling of a ready-file host: wildcard binds collapse
    to ``*``, names resolve to their address, loopback spellings agree —
    so ``0.0.0.0``/hostname vs ``127.0.0.1`` endpoint lists still match
    (ADVICE r5: a live server must never time out over a spelling)."""
    host = host.strip().lower()
    if host in ("0.0.0.0", "::", "*", ""):
        return "*"
    if host == "localhost":
        return "127.0.0.1"
    cached = _HOST_NORM_CACHE.get(host)
    if cached is None:
        try:
            cached = socket.gethostbyname(host)
        except OSError:
            cached = host
        _HOST_NORM_CACHE[host] = cached
    return cached


def _ready_file_present(ready_dir: str, endpoint: str) -> bool:
    """True when a ready-file announces ``endpoint`` — matched verbatim
    first, then by port with normalized hosts (a server that bound
    ``0.0.0.0``/a hostname announces under that spelling).

    A wildcard-only match (``0.0.0.0:PORT.ready``) names no host, so on
    a SHARED ready-dir it could belong to another machine's same-port
    server — it is only trusted after a connect probe confirms a local
    listener."""
    if os.path.exists(os.path.join(ready_dir, endpoint + ".ready")):
        return True
    host, _, port = endpoint.rpartition(":")
    want = _normalize_host(host)
    suffix = f":{port}.ready"
    try:
        entries = os.listdir(ready_dir)
    except OSError:
        return False
    wildcard = False
    for fn in entries:
        if not fn.endswith(suffix):
            continue
        got = _normalize_host(fn[:-len(suffix)])
        if got == want:
            return True  # exact host match wins over any wildcard file
        wildcard = wildcard or got == "*" or want == "*"
    return wildcard and RPCClient._probe(endpoint, 1.0)


def wait_server_ready(endpoints, timeout: float = 90.0,
                      ready_dir: Optional[str] = None,
                      log_every: float = 2.0,
                      probe_grace: Optional[float] = None,
                      registry_ep: Optional[str] = None) -> None:
    """Block until every endpoint's server is listening.

    With ``PADDLE_READY_DIR`` set (the deterministic path — every
    RPCServer in that environment announces itself with an atomic
    ready-file), this waits on the files: no connection attempts, no
    races with a server mid-bind.  Ready filenames are matched with
    normalized hosts (wildcard binds, hostnames and loopback spellings
    all agree), and after ``probe_grace`` seconds (default
    ``min(5, timeout/2)``) a still-missing file falls back to a connect
    probe — a live server whose announcement went to a different
    ready-dir (or spelling) can no longer time the caller out.  Without
    a ready-dir, probe connects from the start (the reference
    ``_wait_ps_ready`` role, test_dist_base.py:232, bounded by
    ``timeout``).

    The wait is never silent: every probe round that leaves servers
    pending increments ``rpc.wait_server.retries``, and a progress line
    goes to stderr every ``log_every`` seconds — a launcher stuck here
    for 90 s used to look identical to a hang.

    With a registry (``registry_ep`` or ``FLAGS_pserver_registry``), the
    endpoints are treated as LOGICAL keys re-resolved each round: when a
    key's resolution flips mid-wait (a backup was promoted, a
    replacement re-registered), the probe retargets the new physical
    address immediately and the grace clock restarts — instead of
    waiting out the full grace against the dead address.  Every flip is
    counted in ``rpc.wait_server.repromotes``.
    """
    t_start = time.monotonic()
    deadline = t_start + timeout
    next_log = t_start + log_every
    ready_dir = ready_dir or os.environ.get("PADDLE_READY_DIR")
    if probe_grace is None:
        probe_grace = min(5.0, timeout / 2.0)
    probe_after = t_start + probe_grace
    pending = [e.strip() for e in endpoints]
    if registry_ep is None:
        from ..core import flags as _flags
        try:
            registry_ep = _flags.get_flags("pserver_registry") or None
        except KeyError:  # pragma: no cover
            registry_ep = None
    resolved: Dict[str, str] = {}
    reg_client = None
    next_resolve = t_start
    while pending:
        if registry_ep and time.monotonic() >= next_resolve:
            next_resolve = time.monotonic() + 0.5
            from . import registry as _registry_mod
            if reg_client is None:
                reg_client = RPCClient(0)
            for ep in pending:
                if ep == registry_ep:
                    continue
                try:
                    phys = _registry_mod.resolve(reg_client, registry_ep, ep)
                except ConnectionError:
                    break         # registry itself not up yet: keep probing
                if phys is None:
                    continue
                old = resolved.get(ep)
                resolved[ep] = phys
                if old is not None and old != phys:
                    # the endpoint flipped under us (backup promoted /
                    # replacement registered): retarget and restart the
                    # grace instead of riding out the dead address
                    probe_after = time.monotonic() + probe_grace
                    if _telemetry_on():
                        _obs_stats.counter(
                            "rpc.wait_server.repromotes",
                            "wait_server_ready probe retargets after a "
                            "mid-wait promotion/re-registration").inc()
                    print(f"[wait_server_ready] {ep} re-resolved "
                          f"{old} -> {phys}; restarting probe round",
                          file=_sys.stderr, flush=True)
        still = []
        for ep in pending:
            target = resolved.get(ep, ep)
            if ready_dir:
                ok = _ready_file_present(ready_dir, target)
                if not ok and target != ep:
                    ok = _ready_file_present(ready_dir, ep)
                if not ok and time.monotonic() >= probe_after:
                    # grace expired: trust a live listener over a
                    # missing announcement file
                    ok = RPCClient._probe(target, 1.0)
                    if ok and _telemetry_on():
                        _obs_stats.counter(
                            "rpc.wait_server.probe_fallbacks",
                            "endpoints accepted via the connect-probe "
                            "fallback after the ready-file grace "
                            "period").inc()
            else:
                ok = RPCClient._probe(target, 1.0)
            if not ok:
                still.append(ep)
        pending = still
        if not pending:
            return
        if _telemetry_on():
            _obs_stats.counter(
                "rpc.wait_server.retries",
                "probe rounds that left at least one server pending in "
                "wait_server_ready").inc()
        now = time.monotonic()
        if now >= next_log:
            print(f"[wait_server_ready] {now - t_start:.1f}s: waiting for "
                  f"{len(pending)} server(s): {', '.join(pending[:4])}"
                  + (" ..." if len(pending) > 4 else ""),
                  file=_sys.stderr, flush=True)
            next_log = now + log_every
        if now > deadline:
            raise TimeoutError(
                f"servers not ready after {timeout:.0f}s: {pending} "
                + (f"(no ready-file in {ready_dir})" if ready_dir
                   else "(connect probe failed)"))
        time.sleep(0.05)


class _PyServer:
    def __init__(self, host: str, port: int, service):
        outer_service = service

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                _serve_io(_PyIO(self.request), outer_service)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name=f"rpc-server-{host}:{port}")

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread.start()

    def stop(self, graceful_s: float = 0.0) -> None:
        # socketserver's shutdown never severs ACCEPTED connections
        # (daemon handler threads finish their writes naturally), so
        # graceful_s needs no extra wait on this backend
        self._server.shutdown()
        self._server.server_close()


class _NativeServer:
    """Accept loop over the native listener; thread per connection."""

    def __init__(self, host: str, port: int, service):
        self._lib = _native_lib()
        self._l = self._lib.ptq_listener_create(host.encode(), port)
        if not self._l:
            raise OSError(f"cannot bind {host}:{port}")
        self._service = service
        self._conns = []
        self._threads = []
        self._closing = False
        self._port = self._lib.ptq_listener_port(self._l)
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name=f"rpc-native-{host}:{port}")

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> None:
        self._thread.start()

    def _accept_loop(self) -> None:
        while True:
            h = self._lib.ptq_listener_accept(self._l)
            if not h:
                # listener shut down (stop()): the accept loop frees it
                lstn, self._l = self._l, None
                if lstn:
                    self._lib.ptq_listener_close(lstn)
                return
            io = _NativeIO(h)
            with self._lock:
                self._conns.append(io)

            def serve(io=io):
                try:
                    _serve_io(io, self._service)
                finally:
                    with self._lock:
                        if io in self._conns:
                            self._conns.remove(io)
                        if threading.current_thread() in self._threads:
                            self._threads.remove(threading.current_thread())
                    io.close()  # the serving thread OWNS the handle

            t = threading.Thread(target=serve, daemon=True)
            with self._lock:
                self._threads.append(t)
            t.start()

    def stop(self, graceful_s: float = 0.0) -> None:
        lstn = self._l
        self._closing = True
        if lstn:
            if self._thread.is_alive():
                # wake the blocked accept; the accept loop owns the
                # listener and frees it on the way out
                self._lib.ptq_listener_shutdown(lstn)
            else:
                self._l = None
                self._lib.ptq_listener_close(lstn)
        # quiesce the ACCEPT LOOP first: a connection accepted while we
        # snapshot would escape both the shutdown and the join below
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        if graceful_s > 0:
            # graceful stop (the serving drain): a connection between
            # "request received" and "reply written" (_serve_io busy
            # marker) gets its reply OUT before we sever — shutdown()
            # on a mid-reply connection loses a reply the drain already
            # promised.  Idle connections (blocked readers) don't wait
            deadline = time.monotonic() + graceful_s
            for io in conns:
                while getattr(io, "busy", False) \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
        for io in conns:
            io.shutdown()  # wake readers; serving threads free handles
        # JOIN the woken threads (bounded): a daemon thread still inside
        # the C++ transport when the interpreter finalizes dies via
        # pthread_exit, whose forced unwind aborts through g++ frames
        # ("FATAL: exception not rethrown") — seen as flaky pserver
        # crash-on-exit under load
        for t in threads:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class _Conn:
    def __init__(self, endpoint: str, connect_timeout: float):
        host, port = endpoint.rsplit(":", 1)
        self.lock = threading.Lock()
        self.io = _connect_io(host, int(port), connect_timeout)


class RPCClient:
    """Trainer-side client: ``FLAGS_rpc_conns_per_endpoint`` striped
    persistent connections per endpoint + a shared pool for concurrent
    fan-out (``GRPCClient`` analogue).  Stripe selection prefers an idle
    connection, so concurrent requests to one pserver pipeline across
    stripes instead of serializing on one connection lock."""

    def __init__(self, trainer_id: int = 0):
        self.trainer_id = trainer_id
        # endpoint -> fixed-size stripe list (None = not yet connected);
        # stripe width is latched per endpoint at first use
        self._conns: Dict[str, List[Optional[_Conn]]] = {}
        self._rr: Dict[str, int] = {}
        self._was_connected: set = set()
        self._conns_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="rpc-client")
        # elastic re-binding (distributed/registry.py): when a registry is
        # configured, op endpoints are LOGICAL keys resolved to the current
        # physical endpoint; re-resolved on connection failure
        from ..core import flags
        try:
            self._registry = flags.get_flags("pserver_registry") or None
        except KeyError:  # pragma: no cover
            self._registry = None
        self._resolved: Dict[str, str] = {}
        # HA barrier sequencing: one monotonic round counter per logical
        # endpoint (the dedup key the pserver uses to make barriers
        # idempotent); only touched when the transpiler emitted ha mode
        self._barrier_seq: Dict[str, int] = {}
        self._barrier_seq_lock = threading.Lock()

    def set_registry(self, endpoint: Optional[str]) -> None:
        self._registry = endpoint or None
        self._resolved.clear()

    def _resolve(self, logical: str, refresh: bool = False,
                 avoid: Optional[str] = None) -> str:
        """logical -> physical endpoint via the registry (identity when no
        registry).  ``refresh`` polls until a LIVE registration different
        from ``avoid`` (a dead endpoint) appears, up to the rpc deadline —
        covering the window between a pserver dying and its replacement
        re-registering from the shard checkpoint."""
        if self._registry is None or logical == self._registry:
            return logical
        if not refresh and logical in self._resolved:
            return self._resolved[logical]
        from . import registry as _registry_mod
        deadline = time.monotonic() + _CONNECT_TIMEOUT
        reg_err = None
        while True:
            try:
                phys = _registry_mod.resolve(self, self._registry, logical)
                reg_err = None
            except ConnectionError as e:
                # registry briefly unreachable (its own conn dropped under
                # load): indistinguishable from not-yet-registered — poll
                phys, reg_err = None, e
            if phys is not None:
                # same address as the dead server: could be its stale lease
                # (TTL not yet expired) OR a supervisor restart on the SAME
                # port — distinguish by probing the socket; a live listener
                # means the replacement is up
                if phys != avoid or self._probe(phys):
                    self._resolved[logical] = phys
                    return phys
            if time.monotonic() > deadline:
                raise ConnectionError(
                    f"no live pserver re-registered for {logical!r} "
                    f"within the deadline (registry {self._registry}"
                    + (", which is itself UNREACHABLE" if reg_err else "")
                    + ")") from reg_err
            time.sleep(0.3)

    @staticmethod
    def _probe(endpoint: str, timeout: float = 1.0) -> bool:
        try:
            host, port = endpoint.rsplit(":", 1)
            socket.create_connection((host, int(port)), timeout).close()
            return True
        except (OSError, ValueError):
            # ValueError: a LOGICAL key (no host:port shape) that has no
            # physical resolution yet — not probeable, so not ready
            return False

    def _conn(self, endpoint: str, timeout: float = _CONNECT_TIMEOUT) -> _Conn:
        with self._conns_lock:
            pool = self._conns.get(endpoint)
            if pool is None:
                pool = self._conns[endpoint] = \
                    [None] * max(1, _int_flag("rpc_conns_per_endpoint", 2))
            was = endpoint in self._was_connected
            # stripe choice: an idle live connection first (``locked()``
            # is a hint — a raced grab just means one extra queued
            # request), then an unopened slot, then round-robin
            idx = None
            for i, x in enumerate(pool):
                if x is not None and not x.lock.locked():
                    idx = i
                    break
            if idx is None:
                for i, x in enumerate(pool):
                    if x is None:
                        idx = i
                        break
            if idx is None:
                idx = self._rr.get(endpoint, 0) % len(pool)
                self._rr[endpoint] = idx + 1
            c = pool[idx]
        if c is not None:
            return c
        # Reconnect deadline policy: the LONG deadline exists for initial
        # bring-up (pservers may start after trainers).  A previously-
        # connected endpoint reconnects with a SHORT deadline only when a
        # registry exists to fail over to — static-endpoint mode keeps the
        # long deadline so an in-place pserver restart is ridden out.
        if was and self._registry is not None:
            timeout = min(timeout, 5.0)
        # connect OUTSIDE the lock: a dead endpoint's blocking connect
        # must not stall requests to healthy pservers
        c = _Conn(endpoint, timeout)
        with self._conns_lock:
            pool = self._conns.get(endpoint)
            if pool is not None and idx < len(pool):
                winner = pool[idx]
                if winner is None:
                    pool[idx] = c
                    self._was_connected.add(endpoint)
                    return c
            else:
                winner = None
        # raced another creator (or the pool was dropped): keep theirs
        try:
            c.io.close()
        except Exception:
            pass
        return winner if winner is not None else self._conn(endpoint, timeout)

    def _drop_conn(self, endpoint: str, c: "_Conn") -> None:
        with self._conns_lock:
            pool = self._conns.get(endpoint)
            if pool:
                for i, x in enumerate(pool):
                    if x is c:
                        pool[i] = None
        try:
            with c.lock:  # never free under a peer thread's send/recv
                c.io.close()
        except Exception:
            pass

    # messages safe to auto-retry after a connection error: read-only or
    # idempotent on the server.  SEND_VAR/SEND_VARS (async mode applies
    # grads on arrival) and BATCH_BARRIER (closes a round) could have been
    # applied before the response was lost — retrying would double-count,
    # so they surface the error instead (the reference's at-most-once
    # discipline for mutating RPCs).  A batch frame is all-or-nothing on
    # the wire (the server decodes it only once fully received), so
    # SEND_VARS keeps the same discipline as N SEND_VARs.
    _RETRYABLE = frozenset((GET_VAR, GET_VARS, PREFETCH, FETCH_BARRIER,
                            CHECKPOINT_NOTIFY, STATS_PULL))

    def _raw_request(self, endpoint: str, msg_type: int, name: str = "",
                     payload=b"", retry_all: bool = False,
                     connect_timeout: Optional[float] = None,
                     n_vars: int = 0):
        """``payload``: bytes, or a scatter-gather buffer list (batched
        frames — sent via sendmsg/iovec, no concat copy).

        Under a sampled trace context this opens a client span and
        injects ITS context into the frame's trace extension, so the
        server's span parents under this request (not the whole step);
        with nothing sampled the frame is byte-identical to the
        pre-trace wire."""
        tel = _telemetry_on()
        t0 = time.perf_counter() if tel else None
        sc = _obs_stats.scope("rpc.client") if tel else None
        tctx = _trace.current()
        span = (_trace.start_span(
            "rpc.client::" + MSG_NAMES.get(msg_type, str(msg_type)),
            cat="rpc", root=False,
            tags={"endpoint": endpoint, "n_vars": n_vars} if n_vars
            else {"endpoint": endpoint})
            if tctx is not None and tctx.sampled else _trace.NOOP)
        with span:
            return self._raw_request_framed(endpoint, msg_type, name,
                                            payload, retry_all,
                                            connect_timeout, n_vars,
                                            tel, t0, sc)

    def _raw_request_framed(self, endpoint, msg_type, name, payload,
                            retry_all, connect_timeout, n_vars, tel, t0, sc):
        from . import faults as _faults
        if _faults.active() and _faults.client_fault(
                MSG_NAMES.get(msg_type, str(msg_type))) is not None:
            # injected client-side drop: behave exactly like the wire
            # dying before the first byte (the retry discipline decides)
            raise ConnectionError(
                f"injected fault: connection to {endpoint} dropped")
        req_bufs = _pack_body_vec(msg_type, self.trainer_id, name,
                                  payload if isinstance(payload, list)
                                  else [payload], ctx=_trace.inject())
        body = None
        for attempt in (0, 1):
            # retry connects get a short deadline: the long one is only for
            # initial bring-up (pservers may start after trainers).  Callers
            # with their own fast-fail policy (fleet metric pulls that must
            # not hang the scrape on one dead worker) pass connect_timeout.
            c = self._conn(endpoint,
                           connect_timeout if connect_timeout is not None
                           else _CONNECT_TIMEOUT if attempt == 0 else 5.0)
            try:
                with c.lock:
                    req_len, vectored = _send_frame_any(c.io, req_bufs)
                    body = c.io.recv_frame()
                if body is None:
                    raise ConnectionError(
                        f"pserver {endpoint} closed the connection")
                break
            except ConnectionError:
                # stale cached connection (pserver restarted, or the port
                # was reassigned): reconnect once for idempotent requests
                self._drop_conn(endpoint, c)
                if tel:
                    sc.counter("conn_errors").inc()
                if attempt or not (retry_all
                                   or msg_type in self._RETRYABLE):
                    raise
                if tel:
                    sc.counter("retries").inc()
        rtype, _, _, rpayload = _unpack_body(body)
        if tel:
            sc.counter("requests." + MSG_NAMES.get(msg_type,
                                                   str(msg_type))).inc()
            sc.counter("bytes_sent").inc(req_len)
            sc.counter("bytes_recv").inc(len(body))
            if vectored:
                sc.counter("vectored_bytes").inc(req_len)
            if n_vars:
                # vars carried per batched frame: frames-per-round vs
                # batched_vars is the round-trip amortization ratio
                sc.counter("batched_vars").inc(n_vars)
            sc.histogram("latency_ms", buckets=_RPC_MS_BUCKETS).observe(
                (time.perf_counter() - t0) * 1e3)
            if rtype == ERR:
                sc.counter("server_errors").inc()
        if rtype == ERR:
            raise RuntimeError(
                f"pserver {endpoint} error for {name!r}: "
                f"{bytes(rpayload).decode('utf-8', 'replace')}")
        return rpayload

    def _request(self, endpoint: str, msg_type: int, name: str = "",
                 payload=b"", n_vars: int = 0, idempotent: bool = False,
                 connect_timeout=None):
        """``idempotent=True`` marks a normally-non-retryable message as
        safe to re-send (the HA barrier carries a round sequence number
        the server dedups on), so a failover or transient drop retries
        it instead of surfacing the error.  ``connect_timeout`` bounds
        each connect attempt (best-effort callers like checkpoint
        notify must not ride out the full crash-recovery grace on a
        dead endpoint)."""
        phys = self._resolve(endpoint)
        try:
            return self._raw_request(phys, msg_type, name, payload,
                                     n_vars=n_vars, retry_all=idempotent,
                                     connect_timeout=connect_timeout)
        except ConnectionError:
            if self._registry is None or endpoint == self._registry:
                raise
            # the pserver behind this logical endpoint is gone: wait for a
            # replacement registration and retry there.
            new_phys = self._resolve(endpoint, refresh=True, avoid=phys)
            if _telemetry_on():
                _obs_stats.scope("rpc.client").counter("failovers").inc()
            if new_phys != phys:
                # a promotion/re-registration happened: bump the global
                # epoch so OTHER cached resolutions (this client's and
                # every other client's) re-resolve before their next use
                # — correlated failures move whole hosts, not one port
                bump_promotion_epoch()
            # loud by design: operators should see every elastic failover
            # (and the flight recorder should remember it post-mortem)
            print(f"[rpc-failover] {endpoint} msg={msg_type}: "
                  f"{phys} -> {new_phys}", file=_sys.stderr, flush=True)
            # field must not be named "msg" — that is note()'s own first
            # parameter (passing it kwargs-style raised TypeError and
            # killed the failover instead of retrying)
            _flight.note("rpc_failover", endpoint=endpoint,
                         msg_type=MSG_NAMES.get(msg_type, str(msg_type)),
                         old=phys, new=new_phys)
            if idempotent:
                return self._raw_request(new_phys, msg_type, name, payload,
                                         n_vars=n_vars, retry_all=True,
                                         connect_timeout=connect_timeout)
            if new_phys == phys and msg_type not in self._RETRYABLE:
                # same address answering the probe: could be the SAME live
                # server after a transient drop — re-sending a SEND_VAR or
                # BATCH_BARRIER there could double-apply (sync rounds
                # would close early).  Keep at-most-once and surface the
                # error; only a DIFFERENT replacement address proves a new
                # server instance, where a duplicate of the lost-response
                # request lands on checkpoint-restored state (one extra
                # async grad — the reference's elastic-mode tolerance).
                raise
            # Non-idempotent messages (SEND_VAR/SEND_VARS/BATCH_BARRIER/
            # ...) get ONE attempt at the replacement: with retry_all a
            # transient drop at the new server could apply the message
            # twice there — two duplicate grads, beyond the documented
            # one-extra-async-grad tolerance.  Read-only messages still
            # retry via _raw_request's own _RETRYABLE gate.
            return self._raw_request(new_phys, msg_type, name, payload,
                                     n_vars=n_vars,
                                     connect_timeout=connect_timeout)

    # -- public API (grpc_client.h:180-206 signatures) ---------------------
    def send_var(self, endpoint: str, name: str, value) -> None:
        self._request(endpoint, SEND_VAR, name,
                      serde.dumps_value_vec(value), n_vars=1)

    def get_var(self, endpoint: str, name: str):
        return serde.loads_value(self._request(endpoint, GET_VAR, name))

    # -- batched var transport ---------------------------------------------
    def send_vars(self, endpoint: str,
                  pairs: Sequence[Tuple[str, object]]) -> None:
        """One ``SEND_VARS`` frame carrying every ``(name, value)`` pair
        (at-most-once, like N ``SEND_VAR`` s — never silently retried).
        Batches whose tensor payload exceeds
        ``FLAGS_rpc_stripe_chunk_bytes`` are split at VAR granularity
        into per-stripe sub-batches sent concurrently, so a big dense
        round uses every striped connection; per-var semantics on the
        server are unchanged (a batch of N counts as N)."""
        pairs = list(pairs)
        if not pairs:
            return
        batches = self._stripe_batches(endpoint, pairs)
        if len(batches) == 1:
            self._request(endpoint, SEND_VARS, "",
                          serde.dumps_batch_vec(pairs), n_vars=len(pairs))
            return
        # sub-batches go on DEDICATED threads, never back onto the
        # shared fan-out pool: send_vars itself usually runs ON that
        # pool (ps_ops._send fans out per endpoint), and nested
        # submit+result on one bounded pool deadlocks once every worker
        # holds an outer task.  One sub-batch rides this thread.
        errs: List[BaseException] = []
        tctx = _trace.current()
        tctx = tctx if tctx is not None and tctx.sampled else None

        def _one(sub, _ctx=None):
            try:
                with _trace.activate(_ctx):
                    self._request(endpoint, SEND_VARS, "",
                                  serde.dumps_batch_vec(sub),
                                  n_vars=len(sub))
            except BaseException as e:  # noqa: BLE001 - reraised below
                errs.append(e)

        threads = [threading.Thread(target=_one, args=(sub, tctx),
                                    daemon=True)
                   for sub in batches[1:]]
        for t in threads:
            t.start()
        _one(batches[0])
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    def get_vars(self, endpoint: str, names: Sequence[str],
                 copy: bool = True) -> list:
        """One ``GET_VARS`` round trip for many variables, in request
        order.  Defaults to ``copy=True`` — writable owned arrays, same
        semantics as N ``get_var`` calls.  ``copy=False`` returns
        zero-copy read-only views over the response buffer (each view
        pins the WHOLE response — right for a consumer that uses and
        drops them within the round, like the recv host op)."""
        names = list(names)
        if not names:
            return []
        payload = serde.dumps_batch([(n, None) for n in names])
        resp = self._request(endpoint, GET_VARS, "", payload,
                             n_vars=len(names))
        pairs = serde.loads_batch(resp, copy=copy)
        if [n for n, _ in pairs] != names:
            raise RuntimeError(
                f"pserver {endpoint} GET_VARS answered out of order: "
                f"asked {names[:4]}..., got {[n for n, _ in pairs][:4]}...")
        return [v for _, v in pairs]

    def _stripe_batches(self, endpoint: str, pairs: list) -> List[list]:
        """Split a big batch into per-stripe sub-batches (greedy balance
        by tensor bytes).  Single frame when striping is off, the batch
        is small, or only one var."""
        n_stripes = max(1, _int_flag("rpc_conns_per_endpoint", 2))
        if n_stripes <= 1 or len(pairs) <= 1:
            return [pairs]
        chunk_min = _int_flag("rpc_stripe_chunk_bytes", 8 << 20)
        sizes = [serde.value_nbytes(v) for _, v in pairs]
        if chunk_min <= 0 or sum(sizes) < chunk_min:
            return [pairs]
        k = min(n_stripes, len(pairs))
        buckets: List[list] = [[] for _ in range(k)]
        fill = [0] * k
        for (pair, sz) in sorted(zip(pairs, sizes), key=lambda t: -t[1]):
            i = fill.index(min(fill))
            buckets[i].append(pair)
            fill[i] += sz
        return [b for b in buckets if b]

    def prefetch(self, endpoint: str, table_name: str, ids):
        return serde.loads_value(
            self._request(endpoint, PREFETCH, table_name, serde.dumps_value(ids)))

    def next_barrier_seq(self, endpoint: str) -> int:
        """The next HA barrier round number for ``endpoint`` (1-based,
        monotonic per logical endpoint for this client's lifetime)."""
        with self._barrier_seq_lock:
            seq = self._barrier_seq.get(endpoint, 0) + 1
            self._barrier_seq[endpoint] = seq
            return seq

    def batch_barrier(self, endpoint: str, seq: Optional[int] = None) -> None:
        """Close this trainer's round.  ``seq`` (HA mode — the transpiler
        emits it only when a backup is configured) rides in the name
        field as a per-trainer round number the pserver dedups on,
        making the barrier idempotent: a retry after a connection drop
        or a promotion can no longer close a round twice.  ``seq=None``
        keeps the older wire byte-identical."""
        if seq is None:
            self._request(endpoint, BATCH_BARRIER)
        else:
            self._request(endpoint, BATCH_BARRIER, str(int(seq)),
                          idempotent=True)

    def fetch_barrier(self, endpoint: str) -> None:
        self._request(endpoint, FETCH_BARRIER)

    def checkpoint_notify(self, endpoint: str, dirname: str,
                          connect_timeout=None) -> None:
        """Ask one pserver to checkpoint (``dirname`` may carry an
        explicit fleet-cut step, see ps_ops.ckpt_notify_name).  Rides
        the failover-aware ``_request`` path — CHECKPOINT_NOTIFY is
        retryable, so an HA promotion retargets instead of failing —
        with an optionally bounded per-attempt connect."""
        self._request(endpoint, CHECKPOINT_NOTIFY, dirname,
                      connect_timeout=connect_timeout)

    def complete(self, endpoint: str) -> None:
        """Best-effort: the last trainer's COMPLETE makes the pserver shut
        down, which can race the response/connection teardown — a dropped
        connection here means the server exited, i.e. success.  That
        includes failing to CONNECT at all: a pserver that already died
        (e.g. chaos-killed mid-snapshot) needs no COMPLETE.  Never
        retried (a duplicate COMPLETE would double-count the trainer)."""
        endpoint = self._resolve(endpoint)
        try:
            c = self._conn(endpoint)
        except ConnectionError:
            return              # already down: nothing to shut down
        try:
            with c.lock:
                c.io.send_frame(_pack_body(COMPLETE, self.trainer_id, "",
                                           b""))
                c.io.recv_frame()
        except ConnectionError:
            pass
        finally:
            self._drop_conn(endpoint, c)

    def parallel(self, calls):
        """Run [(fn, args...), ...] concurrently; reraise first error.
        A sampled trace context on the calling thread is re-homed onto
        the pool threads so per-endpoint RPC spans still stitch under
        the step root."""
        ctx = _trace.current()
        if ctx is not None and ctx.sampled:
            def _with_ctx(fn, *args):
                with _trace.activate(ctx):
                    return fn(*args)
            futs = [self._pool.submit(_with_ctx, fn, *args)
                    for fn, *args in calls]
        else:
            futs = [self._pool.submit(fn, *args) for fn, *args in calls]
        return [f.result() for f in futs]


# process-wide client singleton per trainer id (connections persist across
# executor steps, like the reference's RPCClient::GetInstance)
_clients: Dict[int, RPCClient] = {}
_clients_lock = threading.Lock()


def get_client(trainer_id: int = 0) -> RPCClient:
    with _clients_lock:
        c = _clients.get(trainer_id)
        if c is None:
            c = RPCClient(trainer_id)
            _clients[trainer_id] = c
        return c


# ---------------------------------------------------------------------------
# promotion epoch: a process-wide "the fleet topology moved" counter
# ---------------------------------------------------------------------------
# Bumped whenever a failover lands on a DIFFERENT physical address (a
# pserver replacement re-registered, or a backup was promoted).  The
# executor compares it before dispatching RPC host ops and drops every
# client's logical→physical cache on change, so endpoints that did NOT
# fail a request yet still re-resolve promptly after a promotion instead
# of timing out into their own failovers one by one.

_promotion_epoch = 0
_promotion_lock = threading.Lock()


def promotion_epoch() -> int:
    return _promotion_epoch


def bump_promotion_epoch() -> int:
    global _promotion_epoch
    with _promotion_lock:
        _promotion_epoch += 1
        return _promotion_epoch


def refresh_resolutions() -> None:
    """Drop every client's cached logical→physical resolution (they
    rebuild lazily from the registry on next use)."""
    with _clients_lock:
        clients = list(_clients.values())
    for c in clients:
        c._resolved.clear()
