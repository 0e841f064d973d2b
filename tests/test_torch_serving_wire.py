"""The port's one-shot serving front door against the JAX package's, on
the CPU.

``ModelServer``/``ServingClient`` mirror ``tests/test_serving.py``'s wire
cases on the port: the server and client with a hot swap under load and
``/servingz`` over HTTP, failover across registry-announced replicas, a
dead static endpoint benched, a drained replica that drops nothing, and
the typed ``Draining`` reply.  The served models are saved once by the
reference and loaded by both packages, so both servers hold the same
weights; replies are compared with the reference predictor's within
``TOL`` (the port sums in another order), not byte for byte.  Each
package's client talks to the other's server, typed rejections
included.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.inference.predictor import AnalysisConfig as JConfig
from paddle_tpu.inference.predictor import create_predictor as j_create
from paddle_tpu import serving as JS
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.distributed import registry as TReg
from paddle_tpu_torch.distributed import transport as TT
from paddle_tpu_torch.inference import AnalysisConfig as TConfig
from paddle_tpu_torch.observability import debug_server as TDebug

TOL = dict(rtol=1e-5, atol=1e-6)
TTL = 0.3


def _save_mlp(dirname, seed):
    """The reference's MLP (x[8] -> fc16 relu -> fc4 softmax), its
    startup run with ``seed``, saved as an inference model."""
    prog, startup = JProgram(), JProgram()
    prog.random_seed = seed
    with j_guard(prog, startup), j_unique.guard():
        x = jfluid.layers.data("x", [8])
        h = jfluid.layers.fc(x, 16, act="relu")
        y = jfluid.layers.fc(h, 4, act="softmax")
    scope, exe = JScope(), JExecutor()
    with j_scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(dirname, ["x"], [y], exe,
                                       main_program=prog)
    return dirname


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mlp")
    return {v: _save_mlp(str(root / f"v{v}"), seed) for v, seed in
            (("1", 1), ("2", 2))}


def _cpu(d):
    cfg = TConfig(d)
    cfg.disable_gpu()
    return cfg


_REF_PREDICTORS = {}


def _ref_predictor(d):
    """The reference's predictor of a saved model (one a directory)."""
    if d not in _REF_PREDICTORS:
        _REF_PREDICTORS[d] = j_create(JConfig(d))
    return _REF_PREDICTORS[d]


def _port_server(model_dirs, version="1", **kw):
    srv = TS.ModelServer("127.0.0.1:0", **kw)
    srv.load("mlp", version, model_dir=model_dirs[version],
             config=_cpu(model_dirs[version]), buckets=(1, 2, 4),
             activate=True, max_delay_ms=1.0)
    srv.start()
    return srv


def _feeds(n=8, rows=1):
    rng = np.random.RandomState(0)
    return [{"x": rng.randn(rows, 8).astype("float32")} for _ in range(n)]


class _StubPredictor:
    """Batcher-surface stub with a controllable service time."""

    feed_names = ["x"]
    fetch_names = ["y"]

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.calls = []
        self.started = threading.Event()

    def run(self, feed):
        self.started.set()
        if self.delay_s:
            time.sleep(self.delay_s)
        x = np.asarray(feed["x"])
        self.calls.append(x.shape[0])
        return [x * 2.0]


def _close(out, want):
    return np.allclose(out, want, **TOL) and out.shape == want.shape


def test_serving_server_client_swap_and_servingz(model_dirs):
    """The port's ModelServer over the wire: registry discovery,
    replies equal the reference predictor's, a hot swap under three
    client threads drops nothing, the lease carries the new version,
    ``/servingz`` over HTTP, and a typed ``Overloaded``."""
    reg = TReg.RegistryServer("127.0.0.1:0")
    reg.start()
    reg_ep = f"127.0.0.1:{reg.port}"
    srv = _port_server(model_dirs, registry_ep=reg_ep, replica_id="r0",
                       lease_ttl=TTL)
    http = TDebug.start(port=0)
    try:
        feeds = _feeds()
        want1 = [np.asarray(_ref_predictor(model_dirs["1"]).run(f)[0])
                 for f in feeds]
        want2 = [np.asarray(_ref_predictor(model_dirs["2"]).run(f)[0])
                 for f in feeds]
        cli = TS.ServingClient(registry_ep=reg_ep, refresh_s=0.2)
        assert cli.replicas("mlp") == [srv.endpoint]
        np.testing.assert_allclose(cli.infer("mlp", feeds[0])[0], want1[0],
                                   **TOL)
        pairs = cli.infer_pairs("mlp", feeds[1])
        assert pairs[0][0] == srv.manager.fetch_names("mlp")[0]

        stop = threading.Event()
        errs, n_ok = [], [0]
        lock = threading.Lock()

        def client_loop():
            c = TS.ServingClient(endpoints=[srv.endpoint])
            i = 0
            while not stop.is_set():
                try:
                    out = np.asarray(c.infer("mlp", feeds[i % 8])[0])
                except Exception as e:  # noqa: BLE001 - any error drops
                    errs.append(repr(e))
                    return
                if not (_close(out, want1[i % 8])
                        or _close(out, want2[i % 8])):
                    errs.append(f"reply {i} is neither version's")
                    return
                with lock:
                    n_ok[0] += 1
                i += 1

        threads = [threading.Thread(target=client_loop) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        info = srv.swap("mlp", "2", model_dir=model_dirs["2"],
                        config=_cpu(model_dirs["2"]), buckets=(1, 2, 4),
                        max_delay_ms=1.0)
        assert info["drained"]
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
        assert n_ok[0] > 0
        np.testing.assert_allclose(cli.infer("mlp", feeds[0])[0], want2[0],
                                   **TOL)

        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            snap = TReg.fetch_snapshot(cli._client, reg_ep)
            data = snap["data"].get("serving/mlp/r0") or {}
            if data.get("version") == "2":
                break
            time.sleep(0.05)
        assert data.get("version") == "2", snap["data"]

        with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/servingz", timeout=10) as r:
            page = json.loads(r.read().decode("utf-8"))
        card = page[srv.endpoint]
        assert card["active"] == {"mlp": "2"}
        assert card["models"]["mlp@2"]["state"] == "SERVING"
        assert card["models"]["mlp@2"]["requests"] > 0

        stub = _StubPredictor(delay_s=0.3)
        srv.load("slow", "1", predictor=stub, warm=False, buckets=(1,),
                 activate=True, max_delay_ms=0.0, max_queue_rows=1)
        TS.ServingClient(endpoints=[srv.endpoint]).infer(
            "slow", {"x": np.zeros((1, 2), "float32")})
        sheds = []

        def fire():
            c = TS.ServingClient(endpoints=[srv.endpoint])
            try:
                c.infer("slow", {"x": np.zeros((1, 2), "float32")})
            except TS.Overloaded:
                sheds.append(1)
        burst = [threading.Thread(target=fire) for _ in range(6)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(timeout=30)
        assert sheds, "a burst past the queue bound never shed"
    finally:
        TDebug.stop()
        srv.stop()
        reg.stop()


def test_client_failover_across_replicas(model_dirs):
    """Two registry-announced replicas; one stops (clean bye) and every
    later request lands on the survivor without an error."""
    reg = TReg.RegistryServer("127.0.0.1:0")
    reg.start()
    reg_ep = f"127.0.0.1:{reg.port}"
    servers = [_port_server(model_dirs, registry_ep=reg_ep, replica_id=rid,
                            lease_ttl=TTL) for rid in ("a", "b")]
    try:
        cli = TS.ServingClient(registry_ep=reg_ep, refresh_s=0.1,
                               cooldown_s=0.5)
        assert sorted(cli.replicas("mlp")) == sorted(
            s.endpoint for s in servers)
        feed = {"x": np.ones((1, 8), "float32")}
        want = np.asarray(_ref_predictor(model_dirs["1"]).run(feed)[0])
        for _ in range(4):
            np.testing.assert_allclose(cli.infer("mlp", feed)[0], want, **TOL)
        servers[0].stop()
        time.sleep(0.2)
        for _ in range(4):
            np.testing.assert_allclose(cli.infer("mlp", feed)[0], want, **TOL)
        assert cli.replicas("mlp") == [servers[1].endpoint]
    finally:
        for s in servers:
            s.stop()
        reg.stop()


def test_client_static_endpoint_benching(model_dirs):
    """A dead endpoint in a static list is benched after one refused
    connection; traffic flows to the live one."""
    srv = _port_server(model_dirs)
    try:
        dead = "127.0.0.1:1"               # nothing listens on port 1
        cli = TS.ServingClient(endpoints=[dead, srv.endpoint],
                               cooldown_s=60, connect_timeout_s=0.5)
        feed = {"x": np.ones((2, 8), "float32")}
        want = np.asarray(_ref_predictor(model_dirs["1"]).run(feed)[0])
        for _ in range(3):
            np.testing.assert_allclose(cli.infer("mlp", feed)[0], want, **TOL)
        with cli._lock:
            assert dead in cli._down
    finally:
        srv.stop()


def test_drained_replica_drops_zero_requests_under_load():
    """``stop(drain=True)`` under load: the lease goes first, stragglers
    get ``Draining`` and rotate, in-flight batches finish, and no
    client request errors across the window."""
    reg = TReg.RegistryServer("127.0.0.1:0")
    reg.start()
    reg_ep = f"127.0.0.1:{reg.port}"
    stubs = [_StubPredictor(delay_s=0.02), _StubPredictor(delay_s=0.02)]
    srvs = []
    for i, stub in enumerate(stubs):
        s = TS.ModelServer("127.0.0.1:0", registry_ep=reg_ep,
                           replica_id=f"r{i}", lease_ttl=TTL)
        s.load("mlp", "1", predictor=stub, warm=False, buckets=(1, 2, 4),
               activate=True, max_delay_ms=1.0)
        s.start()
        srvs.append(s)
    stop = threading.Event()
    errs, n_ok = [], [0]
    lock = threading.Lock()

    def client_loop():
        c = TS.ServingClient(registry_ep=reg_ep, refresh_s=0.1,
                             cooldown_s=0.2)
        x = np.ones((1, 8), "float32")
        while not stop.is_set():
            try:
                out = c.infer("mlp", {"x": x})
                np.testing.assert_array_equal(out[0], x * 2.0)
            except Exception as e:  # noqa: BLE001 - any error is a drop
                errs.append(repr(e))
                return
            with lock:
                n_ok[0] += 1
    threads = [threading.Thread(target=client_loop) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while n_ok[0] < 30 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert n_ok[0] >= 30, (n_ok, errs)
        before = n_ok[0]
        srvs[0].stop(drain=True)
        snap = TReg.fetch_snapshot(TT.RPCClient(0), reg_ep)
        assert "serving/mlp/r0" not in snap["leases"], snap["leases"]
        deadline = time.monotonic() + 10
        while n_ok[0] < before + 30 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert n_ok[0] >= before + 30, (n_ok, errs)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        for s in srvs[1:]:
            s.stop()
        reg.stop()
    assert errs == [], errs
    assert stubs[0].calls, "r0 never served: the drain was not under load"


def test_draining_reply_is_typed_and_inflight_finishes():
    """A straggler racing the drain gets the typed ``Draining`` (its
    fields round-tripped); the request accepted before it finishes."""
    stub = _StubPredictor(delay_s=0.6)
    srv = TS.ModelServer("127.0.0.1:0")
    srv.load("mlp", "1", predictor=stub, warm=False, buckets=(1,),
             activate=True, max_delay_ms=1.0)
    srv.start()
    c = TS.ServingClient(endpoints=[srv.endpoint])
    x = np.ones((1, 8), "float32")
    inflight = {}

    def one_request():
        inflight["out"] = np.asarray(c.infer("mlp", {"x": x})[0])
    t = threading.Thread(target=one_request)
    t.start()
    assert stub.started.wait(timeout=10)   # accepted, now executing
    drainer = threading.Thread(target=srv.stop, kwargs={"drain": True})
    drainer.start()
    deadline = time.monotonic() + 10
    while not srv.service.draining and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(TS.Draining) as ei:
        TS.ServingClient(endpoints=[srv.endpoint]).infer("mlp", {"x": x})
    assert ei.value.model == "mlp" and ei.value.endpoint == srv.endpoint
    t.join(timeout=10)
    drainer.join(timeout=10)
    np.testing.assert_array_equal(inflight["out"], x * 2.0)


@pytest.mark.parametrize("server,client", [("port", "ref"), ("ref", "port")])
def test_clients_and_servers_across_packages(model_dirs, server, client):
    """Each package's client against the other's server: the same
    replies (within ``TOL``), the fetch names, a tenant id, and the
    typed ``RequestTooLong`` and ``Overloaded`` with the same fields."""
    S, C = (TS, JS) if server == "port" else (JS, TS)
    srv = S.ModelServer("127.0.0.1:0")
    kw = dict(config=_cpu(model_dirs["1"])) if server == "port" else {}
    srv.load("mlp", "1", model_dir=model_dirs["1"], buckets=(1, 2, 4),
             activate=True, max_delay_ms=1.0, **kw)
    srv.load("seq", "1", predictor=_StubPredictor(), warm=False,
             buckets=(1,), activate=True, max_seq_len=4)
    stub = _StubPredictor(delay_s=0.3)
    srv.load("slow", "1", predictor=stub, warm=False, buckets=(1,),
             activate=True, max_delay_ms=0.0, max_queue_rows=1)
    srv.start()
    try:
        cli = C.ServingClient(endpoints=[srv.endpoint])
        ref = _ref_predictor(model_dirs["1"])
        for f in _feeds(4, rows=3):
            pairs = cli.infer_pairs("mlp", f, tenant="acme")
            assert [n for n, _ in pairs] == list(ref.fetch_names)
            np.testing.assert_allclose(pairs[0][1], ref.run(f)[0], **TOL)
        with pytest.raises(C.RequestTooLong) as ei:
            cli.infer("seq", {"x": np.zeros((1, 6), "float32")})
        assert ei.value.to_dict()["model"].startswith("seq")
        C.ServingClient(endpoints=[srv.endpoint]).infer(
            "slow", {"x": np.zeros((1, 2), "float32")})
        sheds = []

        def fire():
            try:
                C.ServingClient(endpoints=[srv.endpoint]).infer(
                    "slow", {"x": np.zeros((1, 2), "float32")})
            except C.Overloaded as e:
                sheds.append(e.to_dict())
        burst = [threading.Thread(target=fire) for _ in range(6)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(timeout=30)
        assert sheds and all(s["model"].startswith("slow") for s in sheds)
        st = cli.admin(srv.endpoint, {"cmd": "status"})
        assert st["active"]["mlp"] == "1"
    finally:
        srv.stop()
