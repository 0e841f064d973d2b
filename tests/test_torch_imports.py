"""The PyTorch port stands alone: no module of ``paddle_tpu_torch``, and
not ``chip_smoke.py``, ``tools/serve_torch.py``, ``tools/fleet_torch.py``
or ``tests/torch_decode_replica_runner.py``, imports JAX or the JAX
package, and importing the port's decode plane, its Program stack (the
copied pure-Python IR modules included), its inference and serving
planes, its wire (serde, transport, registry, the servers and clients),
its run telemetry (perf, runlog, platform peaks), its fleet supervisor
and elastic controller, or its observability, profiler and
fault-injection modules loads neither.  ``chip_smoke.py`` refuses to report
a result without a CUDA device."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "paddle_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


# the root scripts the port added: its smoke check and the card's
# measurement scripts
SCRIPTS = [SMOKE] + [os.path.join(ROOT, f) for f in (
    "int8_dispatch_ab.py", "kernel_ab.py", "mma_rate.py",
    "profiler_loss.py", os.path.join("tools", "serve_torch.py"),
    os.path.join("tools", "fleet_torch.py"),
    os.path.join("tests", "torch_decode_replica_runner.py"))]


def _port_files():
    out = list(SCRIPTS)
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


# the Program stack: copied pure-Python modules and ported ones
PROGRAM_MODULES = [
    "core/types.py", "core/unique_name.py", "core/program.py",
    "core/backward.py", "core/registry.py", "core/lowering.py",
    "core/executor.py", "param_attr.py", "initializer.py",
    "layer_helper.py", "clip.py", "regularizer.py", "framework.py",
    "executor.py", "optimizer.py", "layers/io.py", "layers/nn.py",
    "layers/tensor.py", "layers/learning_rate_scheduler.py",
    "ops/math_ops.py", "ops/tensor_ops.py", "ops/nn_ops.py",
    "ops/optimizer_ops.py", "ops/attention_ops.py", "ops/sequence_ops.py",
    "models/transformer.py", "models/stacked_lstm.py", "kernels/_hash.py",
    "kernels/rnn.py", "core/selected_rows.py", "kernels/sparse.py",
    "models/deepfm.py", "ops/control_flow_ops.py", "layers/control_flow.py",
    "models/machine_translation.py", "kernels/quant.py", "ops/quant_ops.py",
    "io.py", "inference/passes.py", "inference/predictor.py",
    "serving/batcher.py", "serving/model_registry.py",
    "parallel/strategy.py", "parallel/parallel_executor.py",
    "lod_tensor.py", "data_feeder.py", "ops/array_ops.py",
    "contrib/decoder.py", "ops/ctc_crf_ops.py", "ops/misc_ops.py",
    "layers/nn_extras.py", "nets.py", "models/book.py",
]


# the decode plane's and the serving batcher's hooks: the copied
# observability modules, the ported memory ledger and profiler, and the
# fault injector
HOOK_MODULES = [
    "observability/phase.py", "observability/tenant.py",
    "observability/capacity.py", "observability/flight.py",
    "observability/audit.py", "observability/step_stats.py",
    "observability/trace.py", "observability/memory.py", "profiler.py",
    "distributed/__init__.py", "distributed/faults.py",
]


# the serving planes' wire and the observability modules behind it
WIRE_MODULES = [
    "distributed/serde.py", "distributed/transport.py",
    "distributed/registry.py", "data/__init__.py", "data/native.py",
    "observability/__init__.py", "observability/health.py",
    "observability/history.py", "observability/slo.py",
    "observability/canary.py", "observability/aggregate.py",
    "observability/debug_server.py", "decode/server.py",
    "decode/client.py", "serving/server.py", "serving/client.py",
]


# the executor's run telemetry and the fleet supervisor
TELEMETRY_MODULES = [
    "platform.py", "observability/perf.py", "observability/runlog.py",
    "checkpoint/__init__.py", "checkpoint/elastic.py",
    "distributed/supervisor.py",
]


def test_port_files_exist():
    files = _port_files()
    assert len(files) >= 51
    for src in ("paged_decode_attn.cu", "flash_attn_fwd.cu",
                "flash_attn_bwd.cu", "flash_attn_common.cuh",
                "lstm_fwd.cu", "lstm_bwd.cu", "lstm_common.cuh",
                "sparse_gather.cu", "sparse_update.cu", "gru_fwd.cu",
                "gru_bwd.cu", "tf32x3.cuh", "int8_fc.cu"):
        assert os.path.exists(os.path.join(PORT, "kernels", "csrc", src))
    for mod in (PROGRAM_MODULES + HOOK_MODULES + WIRE_MODULES
                + TELEMETRY_MODULES):
        assert os.path.join(PORT, mod) in files, mod


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_paddle_tpu_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ", ".join(
        "paddle_tpu_torch." + m[:-3].replace("/__init__", "")
        .replace("/", ".")
        for m in (PROGRAM_MODULES + HOOK_MODULES + WIRE_MODULES
                  + TELEMETRY_MODULES))
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.decode, "
            "paddle_tpu_torch.kernels.attention, "
            f"paddle_tpu_torch.kernels._build, {mods}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    r = _run_smoke(ROOT, SMOKE)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone_outside_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, lone)
    r = _run_smoke(str(tmp_path), str(lone))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
