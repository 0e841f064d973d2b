"""The convolutional models through ``layers.*`` -> ``minimize`` ->
``Executor.run``: the port against the JAX reference.

- Programs: MNIST, ResNet-18/50/101 (NCHW and NHWC, float32 and
  bfloat16), SE-ResNeXt-50 and VGG-16 build the reference's main and
  startup programs byte for byte.
- One training step from the reference's startup values, on one seeded
  batch: MNIST at B=8 (Adam), ResNet-18 at (3, 16, 16), B=4, NCHW and
  NHWC (the reference's ``test_resnet_nhwc_first_step_parity``),
  ResNet-50 at (3, 32, 32), B=8, NHWC, SE-ResNeXt-50 at (3, 64, 64),
  cardinality 8, B=2, and VGG-16 at (3, 32, 32), B=8 (Adam).  The
  reference's dropout draws threefry bits, so SE-ResNeXt's and VGG's
  ``dropout_prob`` attrs are set to 0 in both packages' programs; no
  gradient re-runs its forward.

  A step's float32 result is noisy where a batch norm normalises few
  values a channel: ResNet-50 at B=2, (3, 32, 32), has two a channel in
  its last stage, where float32 noise decides the step (the reference's
  own NCHW and NHWC programs disagree in the loss), so ResNet-50 runs
  at B=8.  And the update of a deep batch-norm bias or of a dead
  channel's filter, whose gradients cancel, is noise in float32 on
  either side.  Each step is therefore measured against its float64 answer,
  the same program run by the port in float64 from the same start, and
  two float32 runs that are each that far from it are at most twice as
  far apart:
  - the reference is near the answer, which holds the port's rules to
    the reference's (a rule computing another function moves the
    answer): its loss within 1e-4 relative (REF_LOSS_REL) and its update
    of the persistables (the parameters, Momentum's velocities or Adam's
    moments, the batch norms' running mean and variance; all of them
    as one vector), ``after - before``, within 5e-2 relative L2
    (REF_UPDATE_REL);
  - the port's loss within twice the reference's loss error of the
    reference's, plus 1e-6 relative, and its update within twice the
    reference's relative L2 error of the reference's, plus 1e-5.
- The weight carry: the reference's startup values of ResNet-18 (conv
  filters, batch-norm scale, bias and running stats), float32 and
  bfloat16, reach the port's scope bit for bit, through
  ``Scope.load_numpy`` and through the reference's ``io.save_persistables``
  and the port's ``io.load_persistables``.
- ResNet-18 in bfloat16 (NHWC, (3, 64, 64), B=4): the tensors stay
  bfloat16 and the loss, a bfloat16 number, is within 2e-2 relative of
  the reference's (four bfloat16 ulps at the loss's magnitude; at 16x16
  the last stage normalises 4 values a channel, which magnifies a
  one-ulp difference past that).
"""
import numpy as np
import pytest
import torch

import ml_dtypes
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import mnist as j_mnist
from paddle_tpu.models import resnet as j_resnet
from paddle_tpu.models import se_resnext as j_se
from paddle_tpu.models import vgg as j_vgg
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.models import mnist as t_mnist
from paddle_tpu_torch.models import resnet as t_resnet
from paddle_tpu_torch.models import se_resnext as t_se
from paddle_tpu_torch.models import vgg as t_vgg

REF_LOSS_REL = 1e-4
REF_UPDATE_REL = 5e-2
LOSS_FLOOR = 1e-6
UPDATE_FLOOR = 1e-5
BF16_LOSS_REL = 2e-2

MODELS = {"mnist": (j_mnist, t_mnist), "resnet": (j_resnet, t_resnet),
          "se_resnext": (j_se, t_se), "vgg": (j_vgg, t_vgg)}

# case -> (model, build kwargs, batch, image shape)
CASES = {
    "mnist": ("mnist", {}, 8, (1, 28, 28)),
    "resnet18_nchw": ("resnet", dict(class_dim=10, image_shape=(3, 16, 16),
                                     depth=18, lr=0.01), 4, (3, 16, 16)),
    "resnet18_nhwc": ("resnet", dict(class_dim=10, image_shape=(3, 16, 16),
                                     depth=18, lr=0.01, layout="NHWC"),
                      4, (3, 16, 16)),
    "resnet50_nhwc": ("resnet", dict(class_dim=10, image_shape=(3, 32, 32),
                                     depth=50, layout="NHWC"), 8,
                      (3, 32, 32)),
    "se_resnext50": ("se_resnext", dict(class_dim=10,
                                        image_shape=(3, 64, 64), depth=50,
                                        cardinality=8), 2, (3, 64, 64)),
    "vgg16": ("vgg", dict(class_dim=10, image_shape=(3, 32, 32)), 8,
              (3, 32, 32)),
}
BF16_CASE = ("resnet", dict(class_dim=10, image_shape=(3, 64, 64), depth=18,
                            layout="NHWC", dtype="bfloat16"), 4, (3, 64, 64))

# programs compared byte for byte (no step run)
PROGRAMS = {
    "mnist": ("mnist", {}),
    "resnet18_nchw": ("resnet", dict(depth=18)),
    "resnet18_nhwc": ("resnet", dict(depth=18, layout="NHWC")),
    "resnet50_nchw": ("resnet", dict(depth=50)),
    "resnet50_nhwc_bf16": ("resnet", dict(depth=50, layout="NHWC",
                                          dtype="bfloat16")),
    "resnet101_nhwc": ("resnet", dict(depth=101, layout="NHWC")),
    "se_resnext50": ("se_resnext", {}),
    "vgg16": ("vgg", {}),
}


def _build(pkg, model, kw):
    Program, guard, unique = ((JProgram, j_guard, j_unique) if pkg == "j"
                              else (TProgram, t_guard, t_unique))
    module = MODELS[model][0 if pkg == "j" else 1]
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 7
    with guard(main, startup), unique.guard():
        _, loss, _ = module.build(**kw)
    for op in main.global_block.ops:
        if op.type == "dropout":
            op.set_attr("dropout_prob", 0.0)
    return main, startup, loss


def _feed(batch, shape, dtype="float32"):
    rs = np.random.RandomState(0)
    x = rs.randn(batch, *shape).astype(np.float32)
    label = rs.randint(0, 10, (batch, 1)).astype(np.int64)
    key = "pixel" if shape[0] == 1 else "data"
    return {key: x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x,
            "label": label}


def _port_step(model, kw, init, feed, fetch, dtype=None):
    """One port step from ``init`` on the CPU; ``dtype=np.float64`` runs
    it in float64 (the startup values and the image feed cast)."""
    main, _, loss = _build("t", model, kw)
    if dtype is not None:
        init = {n: v.astype(dtype) if v.dtype == np.float32 else v
                for n, v in init.items()}
        feed = {n: torch.from_numpy(v.astype(dtype) if v.dtype == np.float32
                                    else v) for n, v in feed.items()}
    scope, exe = tfluid.Scope(), tfluid.Executor("cpu")
    scope.load_numpy(init, device="cpu")
    recomputes = t_lowering.grad_recomputes
    with tfluid.scope_guard(scope):
        got = exe.run(main, feed=feed, fetch_list=fetch)
    assert t_lowering.grad_recomputes == recomputes
    return got, scope


def _run_step(model, kw, batch, shape, exact=True):
    """One step in each package from the reference's startup values
    (and, with ``exact``, the port's float64 answer)."""
    feed = _feed(batch, shape, kw.get("dtype", "float32"))
    main, startup, loss = _build("j", model, kw)
    persist = sorted(v.name for v in startup.global_block.vars.values()
                     if v.persistable)
    params = sorted(p.name for p in main.all_parameters())
    scope, exe = JScope(), JExecutor()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n)) for n in persist}
        ref = [np.array(v) for v in exe.run(main, feed=feed,
                                            fetch_list=[loss.name],
                                            sync=True)]
        ref_final = {n: np.array(scope.find_var(n)) for n in persist}
    got, tscope = _port_step(model, kw, init, feed, [loss.name])
    out = dict(init=init, ref=ref, got=got, ref_final=ref_final,
               final=tscope.to_numpy(persist), scope=tscope, params=params,
               persist=persist)
    if exact:
        out["exact"], s64 = _port_step(model, kw, init, feed, [loss.name],
                                       np.float64)
        out["exact_final"] = s64.to_numpy(persist)
    return out


@pytest.fixture(scope="module")
def steps():
    memo = {}

    def get(case):
        if case not in memo:
            model, kw, batch, shape = CASES[case]
            memo[case] = _run_step(model, kw, batch, shape)
        return memo[case]
    return get


@pytest.mark.parametrize("case", list(PROGRAMS))
def test_same_program(case):
    model, kw = PROGRAMS[case]
    jm, js, _ = _build("j", model, kw)
    tm, ts, _ = _build("t", model, kw)
    assert tm.serialize() == jm.serialize()
    assert ts.serialize() == js.serialize()


def _update(r, key):
    """The step's change of every persistable, as one float64 vector."""
    return np.concatenate([
        (np.asarray(r[key][n], np.float64)
         - np.asarray(r["init"][n], np.float64)).ravel()
        for n in r["persist"]])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _errors(r) -> dict:
    loss, ref, exact = (float(r["got"][0]), float(r["ref"][0]),
                        float(r["exact"][0]))
    port_u, ref_u, exact_u = (_update(r, "final"), _update(r, "ref_final"),
                              _update(r, "exact_final"))
    return {"loss": abs(loss - ref), "loss_ref": ref,
            "ref_loss": abs(ref - exact) / abs(exact),
            "ref_loss_abs": abs(ref - exact),
            "update": _rel_l2(port_u, ref_u),
            "ref_update": _rel_l2(ref_u, exact_u),
            "finite": bool(np.isfinite(loss) and np.isfinite(port_u).all())}


@pytest.mark.parametrize("case", list(CASES))
def test_one_training_step_matches(steps, case):
    e = _errors(steps(case))
    assert e["finite"]
    assert e["ref_loss"] <= REF_LOSS_REL and e["ref_update"] <= REF_UPDATE_REL
    assert e["loss"] <= 2 * e["ref_loss_abs"] + LOSS_FLOOR * abs(
        e["loss_ref"])
    assert e["update"] <= 2 * e["ref_update"] + UPDATE_FLOOR
    if case == "resnet18_nhwc":      # the reference's NHWC-vs-NCHW check
        a = float(steps(case)["got"][0])
        b = float(steps("resnet18_nchw")["got"][0])
        assert abs(a - b) < 1e-4 * max(1.0, abs(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_carry_is_exact(dtype, tmp_path):
    import paddle_tpu as jfluid
    kw = dict(class_dim=10, image_shape=(3, 16, 16), depth=18,
              layout="NHWC", dtype=dtype)
    main, startup, _ = _build("j", "resnet", kw)
    persist = [v for v in startup.global_block.vars.values()
               if v.persistable]
    scope, exe = JScope(), JExecutor()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {v.name: np.array(scope.find_var(v.name)) for v in persist}
        jfluid.io.save_persistables(exe, str(tmp_path), main_program=main)
    kinds = {str(a.dtype) for a in init.values()}
    assert ("bfloat16" in kinds) == (dtype == "bfloat16")
    tmain, _, _ = _build("t", "resnet", kw)
    direct, loaded = tfluid.Scope(), tfluid.Scope()
    direct.load_numpy(init, device="cpu")
    with tfluid.scope_guard(loaded):
        tfluid.io.load_persistables(tfluid.Executor("cpu"), str(tmp_path),
                                    main_program=tmain)
    for scope_ in (direct, loaded):
        for n, want in init.items():
            got = scope_.to_numpy([n])[n]
            assert got.dtype == want.dtype, n
            assert got.tobytes() == want.tobytes(), n


def test_resnet18_bf16_step():
    model, kw, batch, shape = BF16_CASE
    r = _run_step(model, kw, batch, shape, exact=False)
    got, want = r["got"][0], r["ref"][0]
    assert got.dtype == ml_dtypes.bfloat16 == want.dtype
    loss, ref = float(got), float(want)
    assert np.isfinite(loss) and abs(loss - ref) <= BF16_LOSS_REL * abs(ref)
    conv_w = [n for n in r["params"] if n.startswith("conv2d")]
    assert conv_w and all(r["scope"].find_var(n).dtype == torch.bfloat16
                          for n in conv_w)
    bn_mean = [n for n in r["persist"] if n.endswith(".mean")]
    assert bn_mean and all(r["scope"].find_var(n).dtype == torch.float32
                           for n in bn_mean)
