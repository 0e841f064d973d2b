"""bfloat16 programs in the port: feed, run, fetch, save and load.

A bfloat16 ``data -> fc -> mean`` program runs on the port's CPU
executor from the reference's startup values and fetches the reference's
loss within one bfloat16 ulp (both round the fc's float32 sums and the
mean once to bfloat16).  A float32 feed for a bfloat16 variable rounds
to nearest even, the cast ``ml_dtypes`` makes.  The parameters
round-trip through ``save_params``/``load_params`` bit for bit, in the
reference's on-disk form (the raw 2-byte records ``np.save`` writes for
an ``ml_dtypes.bfloat16`` array), in both directions between the
packages.  In a process where ``ml_dtypes`` cannot be imported,
``bfloat16`` stays its own IR dtype: the tensors are ``torch.bfloat16``,
the reference's parameter file loads bit for bit, a fetch comes back
as float32 holding the same values, and the loss equals the one
computed with ``ml_dtypes`` present.
"""
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.core.types import normalize_dtype

BF16 = ml_dtypes.bfloat16
BF16_ULP = 2.0 ** -8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(Program, guard, unique, fluid):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 4
    with guard(main, startup), unique.guard():
        x = fluid.layers.data("x", [16], dtype="bfloat16")
        h = fluid.layers.fc(x, 8, act="relu")
        loss = fluid.layers.mean(fluid.layers.fc(h, 4))
    params = sorted(p.name for p in main.all_parameters())
    return main, startup, loss, params


def _feed():
    return np.random.RandomState(0).randn(6, 16).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint16)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's startup values, loss and saved parameters."""
    d = str(tmp_path_factory.mktemp("bf16_ref"))
    main, startup, loss, params = _build(JProgram, j_guard, j_unique, jfluid)
    scope, exe = JScope(), JExecutor()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n)) for n in params}
        (out,) = exe.run(main, feed={"x": _feed().astype(BF16)},
                         fetch_list=[loss])
        jfluid.io.save_params(exe, d, main_program=main)
    return dict(dir=d, init=init, loss=np.asarray(out), params=params)


def _port_run(init, feed):
    main, startup, loss, params = _build(TProgram, t_guard, t_unique, tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor("cpu")
    scope.load_numpy(init, device="cpu")
    with tfluid.scope_guard(scope):
        (out,) = exe.run(main, feed={"x": feed}, fetch_list=[loss])
    return main, scope, exe, out


def test_bf16_program_runs_like_the_reference(ref):
    assert all(v.dtype == BF16 for v in ref["init"].values())
    main, scope, _, got = _port_run(ref["init"], _feed().astype(BF16))
    assert got.dtype == BF16 and ref["loss"].dtype == BF16
    assert all(scope.find_var(n).dtype == torch.bfloat16
               for n in ref["params"])
    g, w = float(got), float(ref["loss"])
    assert abs(g - w) <= BF16_ULP * abs(w), (g, w)
    # a float32 feed rounds to nearest even, as ml_dtypes' cast
    _, _, _, got32 = _port_run(ref["init"], _feed())
    assert _bits(got32) == _bits(got)


def test_bf16_params_round_trip_both_packages(ref, tmp_path):
    """The reference's file loads into the port with the same bits; the
    port's file, in the same format, loads into the reference."""
    main, startup, _, params = _build(TProgram, t_guard, t_unique, tfluid)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.io.load_params(exe, ref["dir"], main_program=main)
        for n in params:
            t = scope.find_var(n)
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _bits(tfluid.Scope.to_numpy(scope, [n])[n]),
                _bits(ref["init"][n]))
        d = str(tmp_path / "port")
        tfluid.io.save_params(exe, d, main_program=main)
    with np.load(os.path.join(d, "__params__.npz")) as got, \
            np.load(os.path.join(ref["dir"], "__params__.npz")) as want:
        assert sorted(got.files) == sorted(want.files) == params
        for n in params:
            assert got[n].dtype.itemsize == 2 and got[n].dtype.kind == "V"
            assert got[n].tobytes() == want[n].tobytes()
    jmain, *_ = _build(JProgram, j_guard, j_unique, jfluid)
    jscope = JScope()
    with j_scope_guard(jscope):
        jfluid.io.load_params(JExecutor(), d, main_program=jmain)
        for n in params:
            assert np.asarray(jscope.find_var(n)).tobytes() == \
                ref["init"][n].tobytes()


_HIDDEN = r"""
import json, sys
sys.modules["ml_dtypes"] = None          # the import now fails
import numpy as np, torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import types
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.core.program import Program, program_guard

ref_dir, out_dir = sys.argv[1], sys.argv[2]
main, startup = Program(), Program()
main.random_seed = startup.random_seed = 4
with program_guard(main, startup), unique_name.guard():
    x = fluid.layers.data("x", [16], dtype="bfloat16")
    h = fluid.layers.fc(x, 8, act="relu")
    loss = fluid.layers.mean(fluid.layers.fc(h, 4))
params = sorted(p.name for p in main.all_parameters())
exe, scope = fluid.Executor("cpu"), fluid.Scope()
with fluid.scope_guard(scope):
    exe.run(startup)
    fluid.io.load_params(exe, ref_dir, main_program=main)
    feed = np.random.RandomState(0).randn(6, 16).astype(np.float32)
    (out,) = exe.run(main, feed={"x": feed}, fetch_list=[loss])
    fluid.io.save_params(exe, out_dir, main_program=main)
try:
    types.np_dtype("bfloat16")
    np_dtype_raises = False
except TypeError:
    np_dtype_raises = True
print(json.dumps({
    "bf16_np": types.BFLOAT16_NP is None,
    "normalize": types.normalize_dtype("bfloat16"),
    "is_float": types.is_float("bfloat16"),
    "np_dtype_raises": np_dtype_raises,
    "param_dtypes": sorted({str(scope.find_var(n).dtype) for n in params}),
    "bits": {n: scope.find_var(n).view(torch.int16).flatten().tolist()
             for n in params},
    "fetch_dtype": str(out.dtype), "loss": float(out)}))
"""


def test_bf16_program_without_ml_dtypes(ref, tmp_path):
    """``ml_dtypes`` hidden in a fresh process: bfloat16 stays bfloat16
    (no path maps it to float32)."""
    out_dir = str(tmp_path / "saved")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _HIDDEN, ref["dir"],
                          out_dir], capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bf16_np"] and got["normalize"] == "bfloat16"
    assert got["is_float"] and got["np_dtype_raises"]
    assert got["param_dtypes"] == ["torch.bfloat16"]
    for n in ref["params"]:
        want = _bits(ref["init"][n]).astype(np.int64)
        want = np.where(want >= 1 << 15, want - (1 << 16), want)
        assert got["bits"][n] == want.flatten().tolist(), n
    # the fetch: float32 holding the bfloat16 loss, the very value the
    # port computes with ml_dtypes present
    assert got["fetch_dtype"] == "float32"
    _, _, _, mine = _port_run(ref["init"], _feed())
    assert got["loss"] == float(mine)
    with np.load(os.path.join(out_dir, "__params__.npz")) as saved, \
            np.load(os.path.join(ref["dir"], "__params__.npz")) as want:
        for n in ref["params"]:
            assert saved[n].tobytes() == want[n].tobytes()


def test_bf16_is_a_distinct_dtype():
    assert normalize_dtype("bfloat16") == "bfloat16"
    assert normalize_dtype(BF16) == "bfloat16"
    assert normalize_dtype("float32") == "float32"
