"""The port's streaming decode front door against the JAX package's, on
the CPU.

``DecodeServer``/``DecodeClient`` mirror ``tests/test_decode_plane.py``'s
wire cases on the port's engine (streaming, a ``save_lm``/``load_lm``
model served, the drain under SIGTERM).  The same prompts streamed from
the reference's server and the port's give equal tokens, finishes and
typed rejections (both engines carry the reference's ``init_params``
weights, copied with ``TransformerLM.load_numpy``), and each package's
client talks to the other's server.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import decode as J
from paddle_tpu.distributed import registry as JReg
from paddle_tpu_torch import decode as T
from paddle_tpu_torch.distributed import faults as TFa
from paddle_tpu_torch.distributed import registry as TReg
from paddle_tpu_torch.distributed import transport as TT

TINY = dict(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
            max_seq_len=32)
ENGINE = dict(max_slots=3, block_tokens=4, prefill_buckets=(8, 16))
SEED = 5
# prompts and their sampling: greedy and sampled, chunked and not
REQUESTS = [([1, 2, 3], dict(max_new_tokens=5)),
            ([1, 2, 3], dict(max_new_tokens=5, chunk_tokens=2)),
            ([7, 4, 9, 9, 2, 1, 8, 3, 5, 6], dict(max_new_tokens=8)),
            ([3, 1, 4, 1, 5], dict(max_new_tokens=6, temperature=0.8,
                                   top_k=5, seed=11)),
            ([2, 7], dict(max_new_tokens=9, eos_id=17))]


def _ref_params(seed=SEED):
    lm = J.TransformerLM(J.LMConfig(**TINY))
    return lm, {k: np.asarray(v) for k, v in lm.init_params(seed).items()}


def _port_engine(name, params=None, **kw):
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    lm.load_numpy(params if params is not None else _ref_params()[1])
    return T.DecodeEngine(lm, name=name, device="cpu", **{**ENGINE, **kw})


def _ref_engine(name, **kw):
    lm, params = _ref_params()
    return J.DecodeEngine(lm, params, name=name, **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def servers():
    """One decode server of each package serving the model "lm"."""
    out = {}
    for pkg, eng in (("port", _port_engine("lm")), ("ref", _ref_engine("lm"))):
        srv = (T if pkg == "port" else J).DecodeServer(engines={"lm": eng})
        srv.start()
        out[pkg] = srv
    yield out
    for srv in out.values():
        srv.stop()


def _client(pkg, endpoint):
    return (T if pkg == "port" else J).DecodeClient(endpoints=[endpoint])


def _stream_all(cli):
    """Each request's tokens as streamed, with the FIN dict."""
    out = []
    for prompt, kw in REQUESTS:
        gen = cli.generate_stream("lm", prompt, **kw)
        toks = []
        try:
            while True:
                toks.append(next(gen))
        except StopIteration as stop:
            fin = stop.value
        out.append((toks, fin))
    return out


def _rejections(cli, pkgs):
    """The typed rejections' classes and fields."""
    out = []
    with pytest.raises(pkgs.RequestTooLong) as ei:
        cli.generate("lm", list(range(30)), max_new_tokens=2)
    out.append(ei.value.to_dict())
    return out


def test_streaming_server_and_client(servers):
    """The mirror of the reference's streaming case on the port."""
    cli = T.DecodeClient(endpoints=[servers["port"].endpoint])
    gen = cli.generate_stream("lm", [1, 2, 3], max_new_tokens=5)
    toks = []
    try:
        while True:
            toks.append(next(gen))
    except StopIteration as stop:
        fin = stop.value
    assert len(toks) == 5 and fin["finish"] == "length"
    again = cli.generate("lm", [1, 2, 3], max_new_tokens=5, chunk_tokens=2)
    assert again["tokens"] == toks
    with pytest.raises(T.RequestTooLong):
        cli.generate("lm", list(range(30)), max_new_tokens=2)
    st = cli.status(servers["port"].endpoint)
    assert st["lm"]["tokens"] >= 10


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("port", "ref"),
                                           ("ref", "port")])
def test_streams_equal_the_reference_server(servers, server, client):
    """The reference's server and client are the oracle: the same
    prompts give the same tokens, FINs and typed rejections through
    any pairing of the packages' servers and clients."""
    want = _stream_all(_client("ref", servers["ref"].endpoint))
    cli = _client(client, servers[server].endpoint)
    got = _stream_all(cli)
    assert got == want
    assert [f["finish"] for _, f in got] == [
        "length", "length", "length", "length",
        "eos" if 17 in got[4][0] else "length"]
    assert all(f["n_tokens"] == len(t) for t, f in got)
    pkgs = T if client == "port" else J
    assert _rejections(cli, pkgs) == _rejections(
        _client("ref", servers["ref"].endpoint), J)
    st = cli.status(servers[server].endpoint)
    assert st["lm"]["tokens"] >= sum(len(t) for t, _ in got)


def test_save_load_lm_and_served_roundtrip(tmp_path):
    """A ``save_lm`` directory loads on the CPU and serves tokens equal
    to the re-forward's argmax and to the reference's server on the same
    directory."""
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    params = lm.init_params(seed=9)
    T.save_lm(str(tmp_path / "lm"), T.LMConfig(**TINY), params)
    lm2, params2 = T.load_lm(str(tmp_path / "lm"), device="cpu")
    assert lm2.config == T.LMConfig(**TINY)
    assert sorted(params2) == sorted(params)
    eng = T.DecodeEngine(lm2, params2, name="loaded", device="cpu",
                         max_slots=2, block_tokens=4, prefill_buckets=(8, 16))
    srv = T.DecodeServer(engines={"loaded": eng})
    jlm, jparams = J.load_lm(str(tmp_path / "lm"))
    jsrv = J.DecodeServer(engines={"loaded": J.DecodeEngine(
        jlm, jparams, name="loaded", max_slots=2, block_tokens=4,
        prefill_buckets=(8, 16))})
    srv.start()
    jsrv.start()
    try:
        out = T.DecodeClient(endpoints=[srv.endpoint]).generate(
            "loaded", [3, 1, 4], max_new_tokens=4)
        toks = [3, 1, 4]
        with torch.no_grad():
            for t in out["tokens"]:
                lg = lm2.full_logits(torch.tensor([toks]))
                assert t == int(lg[0, -1].argmax())
                toks.append(t)
        ref = J.DecodeClient(endpoints=[jsrv.endpoint]).generate(
            "loaded", [3, 1, 4], max_new_tokens=4)
        assert out == ref
    finally:
        srv.stop()
        jsrv.stop()


def test_decode_drain_finishes_streams_and_rejects_stragglers():
    """The port's graceful drain: the lease deregisters first, the
    in-flight stream generates to its FIN with every token, a straggler
    gets a typed ``Draining``, and SIGTERM (``install_sigterm_drain``)
    is the trigger, handed on to the previous handler after the
    drain."""
    reg = TReg.RegistryServer("127.0.0.1:0")
    reg.start()
    reg_ep = f"127.0.0.1:{reg.port}"
    eng = _port_engine("drainy")
    srv = T.DecodeServer(engines={"drainy": eng}, registry_ep=reg_ep,
                         replica_id="r0", lease_ttl=0.3)
    srv.start()
    done = {}
    try:
        cli = T.DecodeClient(registry_ep=reg_ep)
        assert cli.replicas("drainy") == [srv.endpoint]
        want = cli.generate("drainy", [1, 2, 3], max_new_tokens=12)

        def long_stream():
            gen = cli.generate_stream("drainy", [1, 2, 3],
                                      max_new_tokens=12)
            toks = []
            try:
                while True:
                    toks.append(next(gen))
                    first.set()
            except StopIteration as stop:
                done["fin"] = dict(stop.value, tokens=toks)
        # each decode step sleeps 40 ms, so the stream is still running
        # when the drain starts and when the straggler arrives
        TFa.inject("delay:decode_step:ms=40")
        first = threading.Event()
        t = threading.Thread(target=long_stream)
        t.start()
        assert first.wait(timeout=10)
        prev = signal.getsignal(signal.SIGTERM)
        chained = []
        signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
        srv.install_sigterm_drain(drain_timeout=30.0)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not srv.service.draining and time.monotonic() < deadline:
            time.sleep(0.005)
        try:
            assert srv.service.draining
            snap = TReg.fetch_snapshot(TT.RPCClient(0), reg_ep)
            assert "decode/drainy/r0" not in snap["leases"]
            with pytest.raises(T.Draining) as ei:
                T.DecodeClient(endpoints=[srv.endpoint]).generate(
                    "drainy", [4, 5], max_new_tokens=2)
            assert ei.value.model == "drainy"
            t.join(timeout=30)
            assert done["fin"]["tokens"] == want["tokens"]
            assert done["fin"]["finish"] == "length"
            deadline = time.monotonic() + 15
            while not chained and time.monotonic() < deadline:
                time.sleep(0.02)
            assert chained == [signal.SIGTERM]
        finally:
            signal.signal(signal.SIGTERM, prev)
        deadline = time.monotonic() + 15
        while srv._started and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not srv._started
    finally:
        TFa.clear()
        srv.stop()
        reg.stop()


def test_registry_discovery_across_packages():
    """A port replica announced to the reference's registry is found
    by the reference's client, and the reverse."""
    for Reg, Srv, Cli, eng in (
            (JReg, T, J, _port_engine("disc")),
            (TReg, J, T, _ref_engine("disc"))):
        reg = Reg.RegistryServer("127.0.0.1:0")
        reg.start()
        reg_ep = f"127.0.0.1:{reg.port}"
        srv = Srv.DecodeServer(engines={"disc": eng}, registry_ep=reg_ep,
                               replica_id="r0", lease_ttl=0.3)
        srv.start()
        try:
            cli = Cli.DecodeClient(registry_ep=reg_ep, refresh_s=0.1)
            assert cli.replicas("disc") == [srv.endpoint]
            out = cli.generate("disc", [5, 6, 7], max_new_tokens=3)
            assert len(out["tokens"]) == 3 and out["finish"] == "length"
        finally:
            srv.stop()
            reg.stop()


def test_serve_torch_cli_decode_parser():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serve_torch_cli", os.path.join(os.path.dirname(__file__), "..",
                                        "tools", "serve_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = mod.build_parser().parse_args(
        ["/m/lm", "--decode", "--decode-slots", "4",
         "--decode-block-tokens", "8",
         "--decode-prefill-buckets", "8,16", "--max-seq-len", "64"])
    assert args.decode and args.decode_slots == 4
    assert args.decode_block_tokens == 8
    assert args.max_seq_len == 64
    assert mod.build_parser().prog == "serve_torch.py"
    # the same parser as the reference's CLI: no device flag
    with pytest.raises(SystemExit):
        mod.build_parser().parse_args(["/m/lm", "--device", "cpu"])
