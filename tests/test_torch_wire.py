"""The port's wire against the JAX package's, on the CPU.

``paddle_tpu_torch.distributed.serde`` writes the reference's bytes for
the same numpy data (a ``SelectedRows`` of torch tensors included), the
framed-TCP transport round-trips on both backends (``python`` and the
native C library), and each package's ``RPCClient`` talks to the
other's ``RPCServer``.  The port's native loader builds the library
outside ``native/`` and leaves that directory as it was.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as JF
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.distributed import serde as JS
from paddle_tpu.distributed import transport as JT
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
from paddle_tpu_torch.data import native as TN
from paddle_tpu_torch.distributed import serde as TS
from paddle_tpu_torch.distributed import transport as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cases of tests/test_rpc_transport.py's serde round trip
SERDE_CASES = [
    None,
    np.arange(12, dtype="float32").reshape(3, 4),
    np.arange(24, dtype="float64").reshape(2, 3, 4),
    np.array(3.5, dtype="float32"),                  # 0-d
    np.zeros((0, 5), dtype="int64"),                 # zero-size
    np.zeros((0,), dtype="float32"),
    np.array([True, False, True]),                   # bool
    np.arange(10, dtype="int32"),
    np.arange(10, dtype="uint8"),
    np.arange(20, dtype="float32")[::2],             # non-contiguous stride
    np.arange(24, dtype="float32").reshape(4, 6).T,  # non-contiguous layout
]


def _sr_pair(rows, values, height):
    """The same sparse slice in both packages: numpy in the reference,
    torch tensors in the port."""
    return (JSR(rows, values, height),
            TSR(torch.from_numpy(rows.copy()), torch.from_numpy(values.copy()),
                height))


def _assert_value_equal(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, (JSR, TSR)):
        assert isinstance(got, (JSR, TSR))
        if isinstance(got, TSR):            # the port loads torch tensors
            assert isinstance(got.rows, torch.Tensor)
        assert got.height == want.height
        np.testing.assert_array_equal(np.asarray(got.rows),
                                      np.asarray(want.rows))
        np.testing.assert_array_equal(np.asarray(got.values),
                                      np.asarray(want.values))
        assert np.asarray(got.values).dtype == np.asarray(want.values).dtype
        return
    got = np.asarray(got)
    assert got.dtype == np.asarray(want).dtype
    assert got.shape == np.asarray(want).shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# serde: the reference's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(SERDE_CASES)))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_serde_bytes_match_the_reference(case, as_tensor):
    value = SERDE_CASES[case]
    ref = JS.dumps_value(value)
    port_value = value
    if as_tensor and value is not None:
        port_value = torch.from_numpy(np.array(value))
    got = TS.dumps_value(port_value)
    assert got == ref
    vec = TS.dumps_value_vec(port_value)
    assert b"".join(bytes(b) for b in vec) == ref
    assert TS.buffers_nbytes(vec) == len(ref)
    assert TS.value_nbytes(port_value) == JS.value_nbytes(value)
    for copy in (True, False):
        _assert_value_equal(TS.loads_value(ref, copy=copy), value)
        _assert_value_equal(JS.loads_value(got, copy=copy), value)


@pytest.mark.parametrize("copy", [True, False])
def test_serde_selected_rows_of_tensors(copy):
    for rows, vals, h in (
            (np.array([1, 3, 7], "int64"),
             np.arange(12, dtype="float32").reshape(3, 4), 10),
            (np.zeros((0,), "int64"), np.zeros((0, 4), "float32"), 10),
            (np.array([5, -1, 5], "int32"),
             np.arange(6, dtype="float64").reshape(3, 2), 6)):
        jsr, tsr = _sr_pair(rows, vals, h)
        ref = JS.dumps_value(jsr)
        assert TS.dumps_value(tsr) == ref
        assert TS.value_nbytes(tsr) == JS.value_nbytes(jsr)
        back = TS.loads_value(ref, copy=copy)
        assert isinstance(back, TSR)
        _assert_value_equal(back, jsr)
        # the tensors own their memory: writable whatever ``copy`` says
        back.values.add_(1.0)
        _assert_value_equal(JS.loads_value(TS.dumps_value(back)), TSR(
            torch.from_numpy(rows), torch.from_numpy(vals + 1.0), h))


def test_serde_batch_bytes_and_order():
    jsr, tsr = _sr_pair(np.array([0, 2]), np.ones((2, 4), "float32"), 6)
    w = np.arange(6, dtype="float32").reshape(2, 3)
    ref_pairs = [("w@BLOCK0", w), ("ids", None), ("emb", jsr),
                 ("empty", np.zeros((0, 3), "int64")),
                 ("flag", np.array([True]))]
    port_pairs = [("w@BLOCK0", torch.from_numpy(w)), ("ids", None),
                  ("emb", tsr), ("empty", np.zeros((0, 3), "int64")),
                  ("flag", np.array([True]))]
    ref = JS.dumps_batch(ref_pairs)
    assert TS.dumps_batch(port_pairs) == ref
    assert b"".join(bytes(b) for b in TS.dumps_batch_vec(port_pairs)) == ref
    for copy in (True, False):
        out = TS.loads_batch(ref, copy=copy)
        assert [n for n, _ in out] == [n for n, _ in ref_pairs]
        for (_, got), (_, want) in zip(out, ref_pairs):
            _assert_value_equal(got, want)


def test_serde_rejects_corrupt_item_and_keeps_view_rules():
    data = bytearray(TS.dumps_batch([("x", np.arange(4, dtype="f4"))]))
    data[4 + 2] ^= 0xFF  # a byte of the declared value_len
    with pytest.raises(ValueError, match="corrupt batch"):
        TS.loads_batch(bytes(data))
    arr = np.arange(8, dtype="float32")
    view = TS.loads_value(TS.dumps_value(arr), copy=False)
    assert not view.flags.writeable and view.base is not None
    owned = TS.loads_value(TS.dumps_value(arr), copy=True)
    owned[0] = 99.0
    np.testing.assert_array_equal(view, arr)


# ---------------------------------------------------------------------------
# transport: loopback on both backends, and across the packages
# ---------------------------------------------------------------------------

class _VarStore:
    """A pserver-shaped loopback service over either package's serde."""

    def __init__(self, serde, ok):
        self.serde, self.ok = serde, ok
        self.vars = {}
        self.frames = []
        self.lock = threading.Lock()

    def handle(self, msg_type, tid, name, payload):
        if msg_type == TT.SEND_VAR:
            with self.lock:
                self.vars[name] = self.serde.loads_value(payload)
                self.frames.append((msg_type, 1))
            return self.ok, b""
        if msg_type == TT.SEND_VARS:
            pairs = self.serde.loads_batch(payload, copy=True)
            with self.lock:
                self.vars.update(pairs)
                self.frames.append((msg_type, len(pairs)))
            return self.ok, b""
        if msg_type == TT.GET_VAR:
            return self.ok, self.serde.dumps_value(self.vars[name])
        if msg_type == TT.GET_VARS:
            names = [n for n, _ in self.serde.loads_batch(payload)]
            with self.lock:
                pairs = [(n, self.vars[n]) for n in names]
            return self.ok, self.serde.dumps_batch_vec(pairs)
        return self.ok, b""


PKGS = {"port": (TT, TS, TF), "ref": (JT, JS, JF)}


def _native_ok():
    return TT._native_lib() is not None and JT._native_lib() is not None


@pytest.fixture
def backend_flags():
    saved = (TF.get_flags("rpc_transport"), JF.get_flags("rpc_transport"))

    def use(backend):
        if backend == "native" and not _native_ok():
            pytest.skip("native transport unavailable")
        TF.set_flags({"rpc_transport": backend})
        JF.set_flags({"rpc_transport": backend})
    yield use
    TF.set_flags({"rpc_transport": saved[0]})
    JF.set_flags({"rpc_transport": saved[1]})


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("port", "ref"),
                                           ("ref", "port")])
@pytest.mark.parametrize("backend", ["python", "native"])
def test_transport_loopback_and_interop(backend_flags, backend, server,
                                        client):
    backend_flags(backend)
    s_tr, s_serde, _ = PKGS[server]
    c_tr = PKGS[client][0]
    assert c_tr._backend() == backend and s_tr._backend() == backend
    store = _VarStore(s_serde, s_tr.OK)
    srv = s_tr.RPCServer("127.0.0.1:0", store)
    srv.start()
    try:
        ep = f"127.0.0.1:{srv.port}"
        cli = c_tr.RPCClient(0)
        big = np.arange(1 << 16, dtype="float32")
        rows, vals = np.array([1, 4]), np.ones((2, 3), "float32")
        sr = (_sr_pair(rows, vals, 8)[1] if client == "port"
              else JSR(rows, vals, 8))
        a = torch.arange(5.0, dtype=torch.float64) if client == "port" \
            else np.arange(5.0)
        cli.send_vars(ep, [("a", a), ("big", big), ("sr", sr)])
        assert store.frames == [(TT.SEND_VARS, 3)]
        got_sr = store.vars["sr"]
        assert got_sr.height == 8
        np.testing.assert_array_equal(np.asarray(got_sr.rows), rows)
        np.testing.assert_array_equal(np.asarray(got_sr.values), vals)
        out = cli.get_vars(ep, ["big", "a"])
        np.testing.assert_array_equal(out[0], big)
        np.testing.assert_array_equal(out[1], np.arange(5.0))
        assert np.asarray(out[1]).dtype == np.float64
        # the per-variable messages share the connection
        cli.send_var(ep, "z", np.ones(3))
        np.testing.assert_array_equal(cli.get_var(ep, "z"), np.ones(3))
        assert cli.get_vars(ep, []) == []
    finally:
        srv.stop()


def test_transport_stripes_a_big_batch(backend_flags):
    """A batch split across stripes arrives once, var by var."""
    backend_flags("python")
    store = _VarStore(TS, TT.OK)
    srv = TT.RPCServer("127.0.0.1:0", store)
    srv.start()
    TF.set_flags({"rpc_stripe_chunk_bytes": 1 << 16,
                  "rpc_conns_per_endpoint": 3})
    try:
        cli = TT.RPCClient(0)
        pairs = [(f"p{i}", torch.full((64, 64), float(i)))
                 for i in range(7)]
        cli.send_vars(f"127.0.0.1:{srv.port}", pairs)
    finally:
        TF.set_flags({"rpc_stripe_chunk_bytes": 8 << 20,
                      "rpc_conns_per_endpoint": 2})
        srv.stop()
    assert sorted(store.vars) == sorted(n for n, _ in pairs)
    for n, want in pairs:
        np.testing.assert_array_equal(store.vars[n], want.numpy())
    sent = [c for t, c in store.frames if t == TT.SEND_VARS]
    assert len(sent) > 1 and sum(sent) == 7


def test_transport_err_frame_crosses_packages(backend_flags):
    backend_flags("python")

    class Broken:
        def handle(self, msg_type, tid, name, payload):
            return JT.ERR, b"no such var"
    srv = JT.RPCServer("127.0.0.1:0", Broken())
    srv.start()
    try:
        with pytest.raises(RuntimeError, match="no such var"):
            TT.RPCClient(0).get_var(f"127.0.0.1:{srv.port}", "w")
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the native loader writes nothing under native/
# ---------------------------------------------------------------------------

def _tracked_native():
    """The tracked files of ``native/`` with their modification times
    (the reference's own loader may rebuild the untracked library there
    at any time, from another test)."""
    d = os.path.join(ROOT, "native")
    names = [f for f in sorted(os.listdir(d))
             if f.endswith((".cc", ".h", ".c", ".md")) or f == "Makefile"]
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in names}


def test_native_loader_builds_outside_native(tmp_path, monkeypatch):
    # as in a checkout without a built library: the loader must compile
    # the source into its own directory, and run nothing else
    monkeypatch.setattr(TN, "_SO", str(tmp_path / "absent.so"))
    monkeypatch.setattr(TN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "_BUILT_SO",
                        str(tmp_path / "build" / "libpaddle_tpu_native.so"))
    ran, run = [], TN.subprocess.run

    def record(cmd, *a, **kw):
        ran.append(list(cmd))
        return run(cmd, *a, **kw)
    monkeypatch.setattr(TN.subprocess, "run", record)
    path = TN.library_path()
    assert path == TN._BUILT_SO and os.path.exists(path)
    assert os.listdir(tmp_path / "build") == ["libpaddle_tpu_native.so"]
    (cmd,) = ran
    out = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(out) == TN.BUILD_DIR and TN._SRC in cmd
    assert "make" not in cmd[0]
    lib = __import__("ctypes").CDLL(path)
    assert hasattr(lib, "ptq_conn_connect")
    assert TN.library_path() == path and len(ran) == 1   # fresh: no rebuild


def test_loading_the_native_transport_leaves_native_clean():
    before = _tracked_native()
    code = ("from paddle_tpu_torch.distributed import transport as t\n"
            "print(t._backend())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() in ("native", "python")
    assert _tracked_native() == before
    st = subprocess.run(["git", "status", "--porcelain", "--", "native/"],
                        cwd=ROOT, capture_output=True, text=True, timeout=60)
    if st.returncode == 0:                  # a git checkout
        assert st.stdout == ""
    assert TN.BUILD_DIR.startswith(os.path.join(ROOT, "paddle_tpu_torch"))
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "paddle_tpu_torch/data/build/" in f.read().split()
