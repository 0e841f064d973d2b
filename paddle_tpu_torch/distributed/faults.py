"""Fault injection for the chaos suite: scripted wire/process failures.

The port's copy of ``paddle_tpu/distributed/faults.py``.

The HA control plane (pserver replication, master failover) is only as
real as the failures it has survived, so the transport and the pserver
loop carry *injection points* that a chaos scenario arms with rules —
via ``FLAGS_fault_inject`` at process start, or at runtime through the
debug server's ``/chaosz`` endpoint (``tools/chaos.py`` drives a live
fleet that way).

Rule grammar (semicolon-separated rules)::

    kind[:target][:k=v[,k=v...]]

kinds
    ``drop_conn``     server: close the connection WITHOUT responding to
                      a matching request — the lost-response window of a
                      peer dying mid-request (retry/at-most-once paths).
    ``delay``         sleep ``ms`` before handling (server side) or
                      before sending (client side, ``side=client``).
    ``kill_after``    hard-kill THIS process (``os._exit(137)``) when the
                      matching request/event counter reaches ``n`` — the
                      "kill primary pserver after N batches" scenario.
    ``refuse_accept`` server: close every new connection immediately
                      (accept-then-slam), bounded by ``for_s``/``times``.
    ``diskfull``      file-write hook (``io_fault``): raise
                      ``OSError(ENOSPC)`` at a matching write — the
                      disk filling up mid-snapshot (the checkpoint
                      store's two-phase commit must leave the previous
                      COMPLETE step authoritative).
    ``io_err``        file-write hook: raise ``OSError(EIO)`` — a dying
                      disk / dead mount at a matching write.
    ``corrupt``       data-corruption hook (``corrupt_fault``): flip
                      ``bits`` bits of one element of a reply buffer or
                      parameter shard at a matching site — silent data
                      corruption, injectable like every other fault
                      class (the correctness plane's chaos hook:
                      ``corrupt:serving_reply:n=1`` corrupts the first
                      reply; the divergence sentinel / canary prober
                      must then detect AND name the replica).
    ``oom``           device-memory hook (``oom_fault``): raise a
                      realistic ``RESOURCE_EXHAUSTED`` out-of-memory
                      error at a matching dispatch site
                      (``decode_step``, ``serving_dispatch``) — the
                      memory plane's chaos hook, so OOM forensics and
                      the decode engine's preempt-and-recover path are
                      drillable without real HBM pressure
                      (``oom:decode_step:n=3`` OOMs the third step).

target
    an RPC message name (``send_vars``, ``batch_barrier``, ``get_task``,
    ...), a loop event (``apply_round``, ``apply_async``,
    ``lease_grant``), a file-write site (``ckpt_write`` — every
    checkpoint-store / io.py atomic write), a corruption site
    (``serving_reply``, ``param_shard`` — optionally replica-qualified
    as ``serving_reply@r1``), or ``*`` / empty for any.

params
    ``n=N``      trigger from the Nth matching hit (default 1)
    ``p=0.x``    per-hit probability once armed (default 1.0)
    ``times=K``  stop after K firings (default unlimited; kill fires once)
    ``ms=X``     delay milliseconds (``delay`` kind; default 100)
    ``bits=B``   bits to flip per firing (``corrupt`` kind; default 1)
    ``for_s=X``  rule disarms X seconds after installation
    ``side=client|server|any``  which hook honors it (default any)

Example: kill the primary pserver mid-round after 3 applied rounds::

    FLAGS_fault_inject="kill_after:apply_round:n=3"

Flap the wire under barriers, 30% of them, for 5 seconds::

    FLAGS_fault_inject="drop_conn:batch_barrier:p=0.3,for_s=5"

With the flag unset and no runtime rules installed (the default), every
hook is one cheap guard — no threads, no RPCs, no wire changes; the
transport is byte-identical to the fault-free build.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

from ..observability import flight as _flight
from ..observability import stats as _obs_stats
from ..observability.trace import flags_on as _telemetry_on

DROP_CONN = "drop_conn"
DELAY = "delay"
KILL_AFTER = "kill_after"
REFUSE_ACCEPT = "refuse_accept"
DISKFULL = "diskfull"
IO_ERR = "io_err"
CORRUPT = "corrupt"
OOM = "oom"
_KINDS = (DROP_CONN, DELAY, KILL_AFTER, REFUSE_ACCEPT, DISKFULL, IO_ERR,
          CORRUPT, OOM)
# kinds the file-write hook honors (a wildcard drop_conn rule must not
# be consumed — or fired — by a write site it can't apply to)
_IO_KINDS = (DISKFULL, IO_ERR, DELAY, KILL_AFTER)
# kinds only a dedicated dispatcher may consume — a wire/event hook
# must neither fire them nor burn their budget
_SITE_KINDS = (DISKFULL, IO_ERR, CORRUPT, OOM)

_lock = threading.Lock()
_runtime_rules: List["Rule"] = []
_flag_cache: Dict[str, List["Rule"]] = {}


class Rule:
    __slots__ = ("kind", "target", "n", "p", "times", "ms", "bits",
                 "for_s", "side", "source", "armed_at", "hits", "fires")

    def __init__(self, kind: str, target: str = "", n: int = 1,
                 p: float = 1.0, times: Optional[int] = None,
                 ms: float = 100.0, bits: int = 1,
                 for_s: Optional[float] = None,
                 side: str = "any", source: str = "runtime"):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(one of {', '.join(_KINDS)})")
        self.kind = kind
        self.target = "" if target in ("", "*") else target
        self.n = max(1, int(n))
        self.p = float(p)
        self.times = None if times is None else int(times)
        self.ms = float(ms)
        self.bits = max(1, int(bits))
        self.for_s = None if for_s is None else float(for_s)
        self.side = side
        self.source = source
        self.armed_at = time.monotonic()
        self.hits = 0
        self.fires = 0

    def matches(self, target: str, side: str, now: float) -> bool:
        if self.target and self.target != target:
            return False
        if self.side != "any" and self.side != side:
            return False
        if self.for_s is not None and now - self.armed_at > self.for_s:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        return True

    def fire(self) -> bool:
        """Count a matching hit; True when the rule actually fires."""
        self.hits += 1
        if self.hits < self.n:
            return False
        if self.p < 1.0 and random.random() >= self.p:
            return False
        self.fires += 1
        return True

    def to_dict(self) -> dict:
        return {"kind": self.kind, "target": self.target or "*",
                "n": self.n, "p": self.p, "times": self.times,
                "ms": self.ms, "bits": self.bits, "for_s": self.for_s,
                "side": self.side, "source": self.source,
                "hits": self.hits, "fires": self.fires}


def parse(spec: str, source: str = "runtime") -> List[Rule]:
    """Parse a rule-spec string; raises ValueError on malformed specs."""
    rules = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        fields = part.split(":", 2)
        kind = fields[0].strip()
        target = fields[1].strip() if len(fields) > 1 else ""
        kwargs = {}
        if len(fields) > 2 and fields[2].strip():
            for kv in fields[2].split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k not in ("n", "p", "times", "ms", "bits", "for_s",
                             "side"):
                    raise ValueError(f"unknown fault param {k!r} in {part!r}")
                kwargs[k] = v.strip() if k == "side" else float(v)
        for k in ("n", "times", "bits"):
            if k in kwargs:
                kwargs[k] = int(kwargs[k])
        rules.append(Rule(kind, target, source=source, **kwargs))
    return rules


def _flag_spec() -> str:
    from ..core import flags
    try:
        return str(flags.get_flags("fault_inject") or "")
    except KeyError:  # pragma: no cover - flag always defined
        return ""


def _flag_rules() -> List[Rule]:
    spec = _flag_spec()
    if not spec:
        return []
    cached = _flag_cache.get(spec)
    if cached is None:
        try:
            cached = parse(spec, source="flag")
        except ValueError:
            # a malformed flag must not take the transport down; loud once
            _flight.note("fault_inject_parse_error", spec=spec[:200])
            cached = []
        _flag_cache.clear()          # flag changed: old parse is garbage
        _flag_cache[spec] = cached
    return cached


def active() -> bool:
    """Cheap guard the hot-path hooks call first."""
    return bool(_runtime_rules) or bool(_flag_spec())


def inject(spec: str) -> List[dict]:
    """Install runtime rules (the /chaosz + tools/chaos.py path)."""
    rules = parse(spec, source="runtime")
    with _lock:
        _runtime_rules.extend(rules)
    _flight.note("fault_injected", spec=spec[:200])
    return [r.to_dict() for r in rules]


def clear() -> int:
    """Remove every runtime-injected rule (flag rules persist)."""
    with _lock:
        n = len(_runtime_rules)
        _runtime_rules.clear()
    if n:
        _flight.note("faults_cleared", n=n)
    return n


def list_rules() -> List[dict]:
    with _lock:
        rules = list(_runtime_rules)
    return [r.to_dict() for r in rules + _flag_rules()]


def _match(target: str, side: str) -> Optional[Rule]:
    now = time.monotonic()
    with _lock:
        rules = list(_runtime_rules)
    for r in rules + _flag_rules():
        # site-only kinds never fire (or burn their budget) on
        # wire/event hooks — io_fault / corrupt_fault dispatch them
        if r.kind in _SITE_KINDS:
            continue
        if r.matches(target, side, now) and r.fire():
            return r
    return None


def _fired(rule: Rule, target: str) -> None:
    if _telemetry_on():
        _obs_stats.counter(
            "faults.fired." + rule.kind,
            "injected faults that actually fired, by kind").inc()
    _flight.note("fault_fired", kind=rule.kind, target=target,
                 hits=rule.hits)


def server_fault(target: str) -> Optional[str]:
    """Hook for the RPC server request loop.  Returns ``None`` (no
    fault), ``"drop_conn"`` (close without responding) — delays sleep
    in place, kills never return."""
    if not active():
        return None
    rule = _match(target, "server")
    if rule is None:
        return None
    return _apply(rule, target)


def client_fault(target: str) -> Optional[str]:
    """Hook before a client sends a request frame.  ``"drop_conn"``
    asks the caller to sever the connection instead of sending.  Only
    rules EXPLICITLY marked ``side=client`` fire here — a default
    (``side=any``) rule belongs to the server hook, so one rule never
    double-fires on both ends of the same request."""
    if not active():
        return None
    now = time.monotonic()
    with _lock:
        rules = list(_runtime_rules)
    for r in rules + _flag_rules():
        if r.kind in _SITE_KINDS:
            continue
        if r.side == "client" and r.matches(target, "client", now) \
                and r.fire():
            return _apply(r, target)
    return None


def event(target: str) -> None:
    """Count a loop event (``apply_round``, ``lease_grant``, ...) —
    only ``kill_after`` and ``delay`` rules are meaningful here."""
    if not active():
        return
    rule = _match(target, "server")
    if rule is not None:
        _apply(rule, target)


def _apply(rule: Rule, target: str) -> Optional[str]:
    _fired(rule, target)
    if rule.kind == DELAY:
        time.sleep(rule.ms / 1e3)
        return None
    if rule.kind == KILL_AFTER:
        # a HARD death (no atexit, no finally, no goodbye): exactly what
        # a kill -9 / machine loss looks like to the rest of the fleet.
        # Flush the flight recorder first — a deliberately-killed worker
        # still leaves its black box (the chaos suite reads it).
        _flight.note("fault_kill", target=target, hits=rule.hits)
        _flight.dump(f"fault_kill_{target}")
        os._exit(137)
    if rule.kind in (DROP_CONN, REFUSE_ACCEPT):
        return DROP_CONN
    return None  # pragma: no cover - all kinds handled


def io_fault(target: str) -> None:
    """Hook at a file-write site (the checkpoint store's atomic-write
    discipline, shared with io.py saves).  A matching ``diskfull`` /
    ``io_err`` rule RAISES the corresponding ``OSError`` (errno ENOSPC
    / EIO) exactly where a real write error would surface, so the
    caller's fault handling — counted fault, flight note, previous
    COMPLETE step stays authoritative — is exercised against the real
    error path, not a mock.  ``delay``/``kill_after`` rules also honor
    write targets (a slow disk, a crash mid-write)."""
    if not active():
        return
    import errno
    now = time.monotonic()
    with _lock:
        rules = list(_runtime_rules)
    for r in rules + _flag_rules():
        if r.kind in _IO_KINDS and r.matches(target, "server", now) \
                and r.fire():
            if r.kind == DISKFULL:
                _fired(r, target)
                raise OSError(errno.ENOSPC,
                              "No space left on device (injected fault)",
                              target)
            if r.kind == IO_ERR:
                _fired(r, target)
                raise OSError(errno.EIO,
                              "Input/output error (injected fault)",
                              target)
            _apply(r, target)   # delay sleeps in place; kill never returns
            return


def corrupt_fault(*targets: str) -> Optional[int]:
    """Hook at a data-corruption site (serving reply assembly, the
    parameter-checksum walk).  Callers pass their site name plus any
    replica-qualified aliases (``"serving_reply@r1"``,
    ``"serving_reply"``) so one rule can hit exactly one replica OR the
    whole site class.  A matching ``corrupt`` rule fires and returns
    the number of bits to flip (``bits`` param); ``None`` = clean.
    Like ``io_fault``, this is the ONLY dispatcher for the kind."""
    if not active():
        return None
    now = time.monotonic()
    with _lock:
        rules = list(_runtime_rules)
    for r in rules + _flag_rules():
        if r.kind != CORRUPT:
            continue
        for t in targets:
            if r.matches(t, "server", now) and r.fire():
                _fired(r, t)
                return r.bits
    return None


def corrupt_array(arr, bits: int = 1):
    """Flip ``bits`` bits of ONE element of ``arr`` (a fresh copy) —
    the silent-data-corruption model: a plausible value, not garbage.
    The largest-magnitude element is hit (a zero bit-flips into a
    denormal no tolerance check could see), and bits flip from the top
    of the element's middle byte — a float's low exponent / high
    mantissa, so the value moves by a factor ~2: far outside any sane
    canary rtol, yet still a finite number the NaN/Inf sentinel cannot
    see."""
    import numpy as np
    a = np.array(arr, copy=True)
    if a.size == 0 or a.dtype.itemsize == 0:
        return a
    flat = a.reshape(-1)
    try:
        elem = int(np.argmax(np.abs(flat).astype(np.float64)))
    except (TypeError, ValueError):
        elem = 0
    view = flat.view(np.uint8)
    itemsize = a.dtype.itemsize
    for b in range(int(bits)):
        # walk down from the top bit of the middle byte, wrapping into
        # neighboring bytes of the same element when bits > 8
        idx = elem * itemsize + (itemsize // 2 + b // 8) % itemsize
        view[idx] ^= np.uint8(1 << (7 - (b % 8)))
    return a


class InjectedResourceExhausted(RuntimeError):
    """The injected OOM: stringifies like the reference's out-of-memory
    status (``RESOURCE_EXHAUSTED: Out of memory while trying to
    allocate N bytes``), which the memory plane's
    :func:`~paddle_tpu_torch.observability.memory.is_oom` recognises
    beside ``torch.cuda.OutOfMemoryError``, so the decode engine's
    preempt-and-recover path takes its production branch."""

    def __init__(self, target: str, nbytes: int = 1 << 30):
        self.target = target
        self.nbytes = int(nbytes)
        super().__init__(
            f"RESOURCE_EXHAUSTED: Out of memory while trying to "
            f"allocate {self.nbytes} bytes (injected fault at "
            f"{target})")


def oom_fault(target: str) -> None:
    """Hook at a device-dispatch site (the decode engine's step loop,
    the serving batcher's predictor dispatch).  A matching ``oom``
    rule RAISES :class:`InjectedResourceExhausted` exactly where a
    real device allocation failure would surface, so OOM forensics and
    recovery run against the real error path, not a mock.  Like
    ``io_fault``, this is the ONLY dispatcher for the kind."""
    if not active():
        return
    now = time.monotonic()
    with _lock:
        rules = list(_runtime_rules)
    for r in rules + _flag_rules():
        if r.kind == OOM and r.matches(target, "server", now) \
                and r.fire():
            _fired(r, target)
            raise InjectedResourceExhausted(target)


def accept_fault() -> bool:
    """Hook at connection accept: True = slam the connection shut."""
    if not active():
        return False
    now = time.monotonic()
    with _lock:
        rules = list(_runtime_rules)
    for r in rules + _flag_rules():
        if r.kind == REFUSE_ACCEPT and r.matches("accept", "server", now) \
                and r.fire():
            _fired(r, "accept")
            return True
    return False
