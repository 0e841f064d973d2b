"""Service discovery / elastic re-binding / HA promotion for pserver mode.

The port's copy of ``paddle_tpu/distributed/registry.py``.

Reference: the etcd-backed discovery of the Go pserver world —
``go/pserver/etcd_client.go:1`` (pservers register themselves under TTL
leases and claim shard slots) and ``go/pserver/client/etcd_client.go:1``
(trainers watch and re-resolve endpoints when the membership changes).

TPU-native redesign: one small registry service riding the SAME framed-TCP
transport as the variable RPC (no external etcd).  Keys are the LOGICAL
pserver endpoints the transpiler baked into the program (stable identity ≙
the etcd shard key); values are the CURRENT physical endpoint plus a TTL
lease refreshed by a heartbeat thread.  A pserver that dies and restarts
elsewhere re-registers the same logical key from its shard checkpoint;
trainers re-resolve on connection failure and carry on — no trainer
restart (the ``client.Client`` re-dial path of the reference).

The registry doubles as the fleet's health plane
(``observability/health.py``): each lease refresh may piggyback a
heartbeat payload (role, step counter, last error) that lands in a
:class:`HealthTable` with HEALTHY → SUSPECT → DEAD miss-threshold
transitions; ``REG_HEALTH`` returns the table, and a ``TaskMaster``
consulting it requeues a DEAD trainer's task leases immediately.

HA layer (the etcd lease/election analogue, rebuilt on the same table):

- **Standby registrations** — a replica registers under the SAME logical
  key with ``standby=<candidate_id>``.  While the primary's lease is
  live, standbys are invisible to ``REG_GET``.  When the primary's lease
  expires (the registry's own DEAD transition for that key), the lowest-
  id live standby is *promoted*: its address becomes the logical key's
  resolution, the promotion is appended to an ordered log, and the
  promoted worker learns of it in its next lease-refresh response (no
  extra RPC).  ``elect=True`` standbys (master candidates) also win an
  INITIAL election when no primary ever registered — lowest id wins —
  while plain standbys (pserver backups) only ever succeed a primary
  that existed, so a backup that boots first cannot steal the key.
- **Data mirror** — a registration may carry an opaque ``data`` payload
  (the HA master publishes its task-lease table here on every state
  transition, the per-change etcd put of ``go/master/service.go:207``).
- **REG_SNAPSHOT / watch replay** — returns the whole table (leases,
  standbys, data, promotion log) plus a monotonic change ``seq``;
  a standby polls it and applies snapshots with a newer seq — the etcd
  watch loop collapsed into cheap snapshot replay.

Enabled by ``FLAGS_pserver_registry=<host:port>`` on trainers and
pservers; off (empty) keeps the static-endpoint behavior.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import transport
from ..observability import canary as _canary
from ..observability import memory as _memory
from ..observability import flight as _flight
from ..observability import slo as _slo
from ..observability import stats as _obs_stats
from ..observability.health import HealthTable
from ..observability.trace import flags_on as _telemetry_on

# message types (continuing transport's numbering)
REG_SET = 8
REG_GET = 9
REG_HEALTH = 10
REG_SNAPSHOT = 13

# let the transport's RPC counters name these requests
# (rpc.client.requests.reg_set, not requests.8)
transport.MSG_NAMES.update({REG_SET: "reg_set", REG_GET: "reg_get",
                            REG_HEALTH: "reg_health",
                            REG_SNAPSHOT: "reg_snapshot"})

DEFAULT_TTL = 10.0

# promotion log retention: enough for any chaos scenario's full history
# without letting a long-lived registry grow without bound
_PROMOTION_LOG = 256


class _Standby:
    __slots__ = ("cand", "endpoint", "expiry", "ttl", "elect")

    def __init__(self, cand: int, endpoint: str, expiry: float, ttl: float,
                 elect: bool):
        self.cand = cand
        self.endpoint = endpoint
        self.expiry = expiry
        self.ttl = ttl
        self.elect = elect


class RegistryService:
    """handle() contract of transport.RPCServer services."""

    def __init__(self, health: Optional[HealthTable] = None):
        self._lock = threading.Lock()
        self._map: Dict[str, Tuple[str, float]] = {}  # logical -> (phys, expiry)
        # HA state --------------------------------------------------------
        self._standby: Dict[str, Dict[int, _Standby]] = {}
        self._had_primary: set = set()      # logicals that EVER had a primary
        # promotion fencing: logical -> the address DEPOSED by the last
        # promotion.  A zombie primary (lease lost to a partition, or a
        # supervisor restart with pre-promotion state) re-claiming its
        # old key while the promoted holder is live would flip-flop the
        # fleet between divergent replicas — it is refused ("demoted")
        # and must re-join as a standby.  The fence lifts if the
        # promoted holder itself dies with no standby (better the
        # zombie than nobody).
        self._fenced: Dict[str, str] = {}
        # revoked standbys: logical -> {physical endpoints}.  A primary
        # that LOST replication to its backup revokes the backup's
        # candidacy here (the registry is the promotion authority): a
        # replica missing acknowledged frames must never be promoted —
        # silent state rollback is worse than no failover.  Permanent
        # for the registry's lifetime (there is no resync protocol; a
        # resynced replacement re-joins under a fresh address).
        self._revoked: Dict[str, set] = {}
        self._data: Dict[str, object] = {}  # logical -> opaque mirror payload
        self._seq = 0                       # bumped on every table change
        self._promotions: List[dict] = []   # ordered promotion log
        self.health = health if health is not None else HealthTable()

    # -- HA helpers (call with self._lock held) ---------------------------
    def _promote_if_needed(self, logical: str, now: float) -> None:
        """The lease-expiry → promotion transition for one logical key:
        when the primary's lease is gone, hand the key to the lowest-id
        live standby (initial election requires ``elect``)."""
        ent = self._map.get(logical)
        if ent is not None and ent[1] >= now:
            return                      # primary lease still live
        cands = self._standby.get(logical)
        if not cands:
            return
        revoked = self._revoked.get(logical, ())
        live = [s for s in cands.values()
                if s.expiry >= now and s.endpoint not in revoked]
        if logical not in self._had_primary:
            live = [s for s in live if s.elect]
        if not live:
            return
        winner = min(live, key=lambda s: s.cand)
        old = ent[0] if ent is not None else None
        self._map[logical] = (winner.endpoint, now + winner.ttl)
        self._had_primary.add(logical)
        if old is not None and old != winner.endpoint:
            self._fenced[logical] = old
        del cands[winner.cand]
        self._seq += 1
        self._promotions.append({
            "ts": time.time(), "logical": logical, "old": old,
            "new": winner.endpoint, "cand": winner.cand, "seq": self._seq})
        del self._promotions[:-_PROMOTION_LOG]
        if _telemetry_on():
            _obs_stats.counter(
                "registry.promotions",
                "standby replicas promoted to primary after the "
                "primary's lease expired").inc()
        # the flight-recorder note chain a chaos post-mortem reads:
        # primary death (lease expiry) -> THIS promotion -> the trainers'
        # rpc_failover re-resolutions
        _flight.note("registry_promote", logical=logical, old=old,
                     new=winner.endpoint, cand=winner.cand)

    def _sweep(self, now: float) -> None:
        """Reap expired leases; promotion gets first claim on every key
        that just lost its primary (the DEAD transition must hand over,
        not silently forget)."""
        for k in list(self._standby):
            self._promote_if_needed(k, now)
            cands = self._standby[k]
            for cid in [c for c, s in cands.items() if s.expiry < now]:
                del cands[cid]
                self._seq += 1
            if not cands:
                del self._standby[k]
        for k in [k for k, (_, exp) in self._map.items() if exp < now]:
            del self._map[k]
            self._seq += 1

    def handle(self, msg_type, trainer_id, name, payload):
        if msg_type == REG_SET:
            body = json.loads(bytes(payload).decode("utf-8"))
            if body.get("bye"):
                # graceful exit: drop the lease AND the health entry so a
                # cleanly-finished worker never shows up as DEAD
                with self._lock:
                    if self._map.pop(name, None) is not None:
                        self._seq += 1
                    cands = self._standby.get(name)
                    cand = body.get("standby")
                    if cands is not None and cand is not None \
                            and cands.pop(int(cand), None) is not None:
                        self._seq += 1
                self.health.forget(name)
                return transport.OK, b""
            if body.get("revoke_standby"):
                # a primary lost replication to this standby: the replica
                # is missing acknowledged frames and must never win a
                # promotion.  Strike its candidacy and remember the
                # address (see self._revoked).
                target = body["revoke_standby"]
                with self._lock:
                    self._revoked.setdefault(name, set()).add(target)
                    cands = self._standby.get(name)
                    if cands is not None:
                        for cid in [c for c, s in cands.items()
                                    if s.endpoint == target]:
                            del cands[cid]
                        if not cands:
                            del self._standby[name]
                    self._seq += 1
                if _telemetry_on():
                    _obs_stats.counter(
                        "registry.standby_revokes",
                        "standby candidacies revoked after the primary "
                        "lost replication to them").inc()
                _flight.note("standby_revoked", logical=name,
                             endpoint=target)
                return transport.OK, b"{}"
            if "endpoint" not in body:
                # data-only publish (the HA master's per-transition state
                # put): no lease touched, just the mirror payload + seq
                with self._lock:
                    self._data[name] = body.get("data")
                    self._seq += 1
                return transport.OK, b"{}"
            if body.get("observe"):
                # health-only refresh (a withdrawn standby keeps its
                # fleet-health presence without renewing any candidacy
                # or claiming the key)
                hb = body.get("health")
                if hb is not None:
                    self.health.observe(
                        name, ttl=float(body["ttl"]),
                        role=hb.get("role", ""), step=hb.get("step"),
                        last_error=hb.get("last_error"),
                        trainer_id=hb.get("trainer_id"),
                        standby=hb.get("standby"), slo=hb.get("slo"),
                        slo_rules=hb.get("slo_rules"),
                        canary=hb.get("canary"),
                        canary_targets=hb.get("canary_targets"),
                        memory=hb.get("memory"),
                        memory_pools=hb.get("memory_pools"))
                return transport.OK, b"{}"
            ttl = float(body["ttl"])
            now = time.monotonic()
            resp = {}
            cand = body.get("standby")
            with self._lock:
                # sweep expired leases so retired logical endpoints don't
                # accumulate forever (REG_GET only reaps its own key) —
                # and so a standby whose primary just expired promotes
                self._sweep(now)
                if cand is not None and \
                        body["endpoint"] in self._revoked.get(name, ()):
                    # this replica's candidacy was revoked (it is missing
                    # acknowledged frames): refuse — it must re-join
                    # under a fresh, resynced incarnation
                    ent = self._map.get(name)
                    resp["revoked"] = True
                    resp["leader"] = (ent[0] if ent is not None
                                      and ent[1] >= now else None)
                elif cand is not None:
                    cand = int(cand)
                    ent = self._map.get(name)
                    if not (ent is not None and ent[1] >= now
                            and ent[0] == body["endpoint"]):
                        # file/refresh the candidacy BEFORE the promotion
                        # check, so this very registration can win an
                        # election (first elect-candidate up leads)
                        sb = self._standby.setdefault(name, {})
                        if cand not in sb:
                            self._seq += 1
                        sb[cand] = _Standby(cand, body["endpoint"],
                                            now + ttl, ttl,
                                            bool(body.get("elect")))
                    self._promote_if_needed(name, now)
                    ent = self._map.get(name)
                    if ent is not None and ent[0] == body["endpoint"]:
                        # this standby has been PROMOTED (by this refresh,
                        # or by an earlier REG_GET): refresh the primary
                        # lease it now holds and tell it so
                        self._map[name] = (body["endpoint"], now + ttl)
                        sb = self._standby.get(name)
                        if sb is not None:
                            sb.pop(cand, None)
                        resp["promoted"] = True
                    else:
                        resp["leader"] = ent[0] if ent is not None else None
                else:
                    ent = self._map.get(name)
                    if ent is not None and ent[1] >= now \
                            and ent[0] != body["endpoint"] \
                            and self._fenced.get(name) == body["endpoint"]:
                        # the address deposed by the last promotion is
                        # back while the promoted holder is LIVE: refuse
                        # the claim (see _fenced above)
                        resp["demoted"] = True
                        resp["leader"] = ent[0]
                    else:
                        if ent is None or ent[1] < now:
                            self._fenced.pop(name, None)
                        if (ent or (None,))[0] != body["endpoint"]:
                            self._seq += 1
                        self._map[name] = (body["endpoint"], now + ttl)
                        self._had_primary.add(name)
                if "data" in body:
                    self._data[name] = body["data"]
                    self._seq += 1
            hb = body.get("health")
            if hb is not None:
                self.health.observe(
                    name, ttl=ttl, role=hb.get("role", ""),
                    step=hb.get("step"), last_error=hb.get("last_error"),
                    trainer_id=hb.get("trainer_id"),
                    standby=hb.get("standby"), slo=hb.get("slo"),
                    slo_rules=hb.get("slo_rules"),
                    canary=hb.get("canary"),
                    canary_targets=hb.get("canary_targets"),
                    memory=hb.get("memory"),
                    memory_pools=hb.get("memory_pools"))
            # plain primary registrations keep the pre-HA empty response
            # byte-identical; only HA registrations carry an answer
            return (transport.OK,
                    json.dumps(resp).encode("utf-8") if resp else b"")
        if msg_type == REG_GET:
            now = time.monotonic()
            with self._lock:
                self._promote_if_needed(name, now)
                ent = self._map.get(name)
                if ent is not None and ent[1] < now:
                    del self._map[name]     # lease expired (lazy reap)
                    self._seq += 1
                    ent = None
            if ent is None:
                return transport.ERR, f"no live pserver for {name!r}".encode()
            return transport.OK, ent[0].encode("utf-8")
        if msg_type == REG_HEALTH:
            return transport.OK, json.dumps(
                self.health.snapshot()).encode("utf-8")
        if msg_type == REG_SNAPSHOT:
            return transport.OK, json.dumps(self.snapshot()).encode("utf-8")
        return transport.ERR, f"registry: unknown msg {msg_type}".encode()

    def snapshot(self) -> dict:
        """The whole table with a monotonic ``seq`` — the watch-replay
        payload a standby master mirrors.  Expiries are exported as
        REMAINING seconds (monotonic clocks don't cross processes)."""
        now = time.monotonic()
        with self._lock:
            self._sweep(now)
            return {
                "seq": self._seq,
                "leases": {k: {"endpoint": ep,
                               "ttl_left": round(exp - now, 3)}
                           for k, (ep, exp) in self._map.items()},
                "standbys": {k: {str(s.cand): {"endpoint": s.endpoint,
                                               "ttl_left": round(
                                                   s.expiry - now, 3),
                                               "elect": s.elect}
                                 for s in cands.values()}
                             for k, cands in self._standby.items()},
                "data": dict(self._data),
                "promotions": [dict(p) for p in self._promotions],
                "revoked": {k: sorted(v)
                            for k, v in self._revoked.items() if v},
            }


class RegistryServer:
    def __init__(self, endpoint: str,
                 health: Optional[HealthTable] = None):
        self.service = RegistryService(health)
        self._server = transport.RPCServer(endpoint, self.service)

    @property
    def health(self) -> HealthTable:
        return self.service.health

    @property
    def port(self) -> int:
        return self._server.port

    def start(self):
        self._server.start()

    def stop(self):
        self._server.stop()


def register(client: "transport.RPCClient", registry_ep: str, logical: str,
             physical: str, ttl: float = DEFAULT_TTL,
             health: Optional[dict] = None,
             standby: Optional[int] = None, elect: bool = False,
             data=None, observe: bool = False) -> dict:
    """One lease refresh.  ``standby=<candidate_id>`` registers as a
    replica for ``logical`` instead of claiming it (``elect=True`` also
    competes in the initial election); ``data`` publishes an opaque
    mirror payload next to the lease.  Returns the registry's response —
    ``{"promoted": True}`` tells a standby it now OWNS the key."""
    body = {"endpoint": physical, "ttl": ttl}
    if observe:
        body["observe"] = True  # health-only: renew/claim nothing
    if health is not None:
        body["health"] = health
    if standby is not None:
        body["standby"] = int(standby)
        if elect:
            body["elect"] = True
    if data is not None:
        body["data"] = data
    out = client._raw_request(registry_ep, REG_SET, logical,
                              json.dumps(body).encode("utf-8"),
                              retry_all=True)
    out = bytes(out)
    return json.loads(out.decode("utf-8")) if out else {}


def revoke_standby(client: "transport.RPCClient", registry_ep: str,
                   logical: str, endpoint: str) -> None:
    """Strike ``endpoint``'s standby candidacy for ``logical``: a
    primary that lost replication calls this so its now-stale backup —
    missing frames trainers were acked for — can never be promoted.
    Permanent for the registry's lifetime (no resync protocol exists; a
    resynced replacement re-joins under a fresh address)."""
    client._raw_request(registry_ep, REG_SET, logical,
                        json.dumps({"revoke_standby": endpoint,
                                    "ttl": 0}).encode("utf-8"),
                        retry_all=True)


def publish_data(client: "transport.RPCClient", registry_ep: str,
                 logical: str, data) -> None:
    """Data-only put (no lease touched): the HA master's per-transition
    state mirror (the etcd put of go/master/service.go:207)."""
    client._raw_request(registry_ep, REG_SET, logical,
                        json.dumps({"data": data}).encode("utf-8"),
                        retry_all=True)


def deregister(client: "transport.RPCClient", registry_ep: str,
               logical: str, standby: Optional[int] = None) -> None:
    """Graceful goodbye: remove the lease and the health entry (a clean
    exit must not age into SUSPECT/DEAD on the registry's books)."""
    body = {"bye": True}
    if standby is not None:
        body["standby"] = int(standby)
    client._raw_request(registry_ep, REG_SET, logical,
                        json.dumps(body).encode("utf-8"),
                        retry_all=True)


def resolve(client: "transport.RPCClient", registry_ep: str,
            logical: str) -> Optional[str]:
    try:
        out = client._raw_request(registry_ep, REG_GET, logical, b"",
                                  retry_all=True)
        return bytes(out).decode("utf-8")
    except RuntimeError:
        return None          # not registered / lease expired


def fetch_health(client: "transport.RPCClient", registry_ep: str,
                 connect_timeout: Optional[float] = None) -> Dict[str, dict]:
    """The registry's health table: {worker: {state, role, step, ...}}."""
    out = client._raw_request(registry_ep, REG_HEALTH, retry_all=True,
                              connect_timeout=connect_timeout)
    return json.loads(bytes(out).decode("utf-8"))


def fetch_snapshot(client: "transport.RPCClient", registry_ep: str,
                   connect_timeout: Optional[float] = None) -> dict:
    """One REG_SNAPSHOT: the full lease/standby/data table plus change
    seq — the standby master's watch-replay pull."""
    out = client._raw_request(registry_ep, REG_SNAPSHOT, retry_all=True,
                              connect_timeout=connect_timeout)
    return json.loads(bytes(out).decode("utf-8"))


class Heartbeat:
    """Daemon lease-refresher (etcd_client.go keepalive analogue).

    ``health_fn`` (optional) is called per refresh and its dict — role,
    step counter, last_error, trainer_id — rides the REG_SET into the
    registry's :class:`HealthTable`; a worker whose heartbeat stops is
    marked SUSPECT then DEAD by miss thresholds (health.py).  Static
    fields can be passed as ``role``/``trainer_id`` without a callable.

    HA extensions: ``standby=<candidate_id>`` heartbeats as a replica of
    ``logical`` (``elect=True`` competes in the initial election); when
    the registry answers a refresh with ``promoted``, the heartbeat
    flips itself to primary mode and fires ``on_promote()`` exactly once
    — promotion rides the lease keepalive, no extra RPC.  ``data_fn``
    (optional) publishes its return value next to the lease on every
    refresh (the leader master's state mirror).
    """

    def __init__(self, registry_ep: str, logical: str, physical: str,
                 ttl: float = DEFAULT_TTL, trainer_id: int = 0,
                 role: str = "", health_fn: Optional[Callable[[], dict]] = None,
                 standby: Optional[int] = None, elect: bool = False,
                 data_fn: Optional[Callable[[], object]] = None,
                 on_promote: Optional[Callable[[], None]] = None,
                 on_demote: Optional[Callable[[], None]] = None,
                 on_revoke: Optional[Callable[[], None]] = None):
        self.registry_ep = registry_ep
        self.logical = logical
        self.physical = physical
        self.ttl = ttl
        self.role = role
        self.trainer_id = trainer_id
        self.health_fn = health_fn
        self.standby = standby
        self.elect = elect
        self.data_fn = data_fn
        self.on_promote = on_promote
        self.on_demote = on_demote
        self.on_revoke = on_revoke
        self.promoted = standby is None
        self._demoted = False
        self._revoked = False
        self._observe = False   # withdraw(): health-only refreshes
        self._client = transport.RPCClient(trainer_id)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"registry-hb-{logical}")

    def _health_payload(self) -> dict:
        hb = {"role": self.role, "trainer_id": self.trainer_id}
        if self.standby is not None and not self.promoted:
            # fleet health view shows who is warm-sparing this key
            hb["standby"] = self.standby
        # SLO watchdog dimension (observability/slo.py): when this
        # process runs a watchdog, its breach state rides every
        # heartbeat — the fleet health table / ElasticController /
        # supervisor consume it with zero new RPCs.  No watchdog (the
        # default): nothing added, the payload stays byte-identical
        slo_dim = _slo.health_dimension()
        if slo_dim:
            hb.update(slo_dim)
        # correctness dimension (observability/canary.py): same
        # discipline — a process running an armed prober stamps its
        # golden-canary verdict on every heartbeat; flag off adds
        # nothing (payload byte-identical)
        canary_dim = _canary.health_dimension()
        if canary_dim:
            hb.update(canary_dim)
        # memory dimension (observability/memory.py): a process running
        # the leak sentinel stamps its last refcount-audit verdict on
        # every heartbeat; flag off adds nothing (payload byte-identical)
        mem_dim = _memory.health_dimension()
        if mem_dim:
            hb.update(mem_dim)
        if self.health_fn is not None:
            try:
                hb.update(self.health_fn() or {})
            except Exception as e:  # a broken probe must not stop the lease
                hb["last_error"] = repr(e)[:200]
        return hb

    def _register_once(self) -> None:
        if self._observe:
            # withdrawn (stale replica): keep the fleet-health presence,
            # renew no candidacy, claim nothing
            register(self._client, self.registry_ep, self.logical,
                     self.physical, self.ttl,
                     health=self._health_payload(), observe=True)
            return
        data = None
        if self.data_fn is not None:
            try:
                data = self.data_fn()
            except Exception:  # a broken publisher must not stop the lease
                data = None
        resp = register(self._client, self.registry_ep, self.logical,
                        self.physical, self.ttl,
                        health=self._health_payload(),
                        standby=None if self.promoted else self.standby,
                        elect=self.elect, data=data)
        if resp.get("promoted") and not self.promoted:
            self.promoted = True
            _flight.note("heartbeat_promoted", logical=self.logical,
                         physical=self.physical, cand=self.standby)
            if self.on_promote is not None:
                try:
                    self.on_promote()
                except Exception as e:
                    _flight.note("on_promote_failed", error=repr(e)[:200])
        elif resp.get("demoted") and not self._demoted:
            # the registry fenced this worker's claim: a backup was
            # promoted over it while it was away (partition / restart
            # with pre-promotion state).  Keep heartbeating — the fleet
            # health view should still see the process — but say it
            # ONCE, loudly: this replica must not serve primary duty
            self._demoted = True
            print(f"[registry] {self.logical}: claim REFUSED — "
                  f"{resp.get('leader')} was promoted over this worker; "
                  "re-join as a standby", flush=True)
            _flight.note("heartbeat_demoted", logical=self.logical,
                         physical=self.physical,
                         leader=resp.get("leader"))
            if self.on_demote is not None:
                try:
                    self.on_demote()
                except Exception as e:
                    _flight.note("on_demote_failed", error=repr(e)[:200])
        elif resp.get("revoked") and not self._revoked:
            # the primary struck this replica's candidacy (replication
            # was lost: we are missing acknowledged frames and must
            # never be promoted)
            self._revoked = True
            print(f"[registry] {self.logical}: standby candidacy "
                  "REVOKED (replication lost — this replica is stale)",
                  flush=True)
            _flight.note("heartbeat_revoked", logical=self.logical,
                         physical=self.physical)
            if self.on_revoke is not None:
                try:
                    self.on_revoke()
                except Exception as e:
                    _flight.note("on_revoke_failed", error=repr(e)[:200])

    def withdraw(self) -> None:
        """Drop out of candidacy (a stale replica must never be
        promoted): future refreshes become health-only, and the current
        standby entry is struck immediately (best-effort — if the
        registry is briefly unreachable the entry still ages out within
        one ttl, since observe-mode refreshes never renew it)."""
        if self._observe:
            return
        self._observe = True
        _flight.note("heartbeat_withdrawn", logical=self.logical,
                     physical=self.physical)
        try:
            revoke_standby(self._client, self.registry_ep, self.logical,
                           self.physical)
        except Exception:
            pass

    def start(self):
        self._register_once()
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.ttl / 3.0):
            try:
                self._register_once()
            except Exception:
                pass             # registry briefly down: keep trying

    def stop(self, bye: bool = False):
        """Stop refreshing.  ``bye=True`` additionally deregisters (the
        clean-shutdown path); the default leaves the lease to expire —
        which is also what an actual crash looks like to the registry,
        so it counts as a DIRTY exit: with the flight recorder armed
        (``FLAGS_flight_record_dir``) this worker writes its post-mortem
        (recent + in-flight spans, log events, step tail) on the way
        out — the registry's DEAD gauge flip gets a black box to read."""
        self._stop.set()
        if bye:
            # quiesce the refresher FIRST: an in-flight REG_SET landing
            # after the goodbye would re-file the lease we just dropped
            # (bounded join — a black-holed registry must not hang the
            # clean-shutdown path)
            if self._thread.is_alive() \
                    and self._thread is not threading.current_thread():
                self._thread.join(timeout=max(2.0, 2 * self.ttl))
            try:
                deregister(self._client, self.registry_ep, self.logical,
                           standby=None if self.promoted else self.standby)
            except Exception:
                pass         # registry already gone: nothing to clean
        else:
            _flight.dirty_exit(f"heartbeat_stop:{self.logical}")
