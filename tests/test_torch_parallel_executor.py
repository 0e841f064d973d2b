"""ParallelExecutor: the port's over a mesh of repeated CPU devices
against the reference's over the virtual 8-device CPU mesh.

The reference cases that hold on a mesh over one device, ported from
``tests/test_parallel_executor.py``: data parallelism under both reduce
strategies (``:64-79``), a partial last training batch (``:128``),
``GradientScaleStrategy.kOne`` (``:142``), a partial inference batch
padded to the dp multiple and cut from the fetch (``:182``), and the
kOne rewrite's idempotence (``:213``).  Each case runs the same program
on both packages from the reference's startup values, copied, and
compares losses (the reference tests' rtol 2e-4, atol 1e-5) and
parameters (1e-5 absolute after 20 Momentum steps: float32 in two
frameworks).

Then the slice as a whole: a 2-layer Transformer with
``attention_impl="ring"`` (small widths, T=32, dropout 0) under the
reference's ``ParallelExecutor`` with ``mesh_shape={"sp": 4}`` on four
virtual devices and the port's over ``["cpu"] * 4``: two Adam steps
agree in loss, gradients and parameters at the tolerances of
``tests/test_torch_transformer_train.py``, every attention op runs the
ring (its pair counts pinned), and no gradient re-runs its forward.
"""
import jax
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.parallel import BuildStrategy as JBuildStrategy
from paddle_tpu.parallel import GradientScaleStrategy as JGS
from paddle_tpu.parallel import ParallelExecutor as JParallelExecutor
from paddle_tpu.parallel import ReduceStrategy as JReduce
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.backward import grad_var_name
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import attention as TA
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.parallel import (BuildStrategy, GradientScaleStrategy,
                                       ParallelExecutor, ReduceStrategy,
                                       make_mesh)

LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)
DP = 8          # the reference's virtual devices
PLACES = ["cpu"] * DP
PKG = {"ref": (jfluid, JProgram, j_guard, j_unique),
       "port": (tfluid, TProgram, t_guard, t_unique)}


def build_model(side, seed=0):
    fluid, Program, guard, unique = PKG[side]
    prog, startup = Program(), Program()
    prog.random_seed = startup.random_seed = seed
    with guard(prog, startup), unique.guard():
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, act="relu")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Momentum(0.01, 0.9).minimize(loss)
    return prog, startup, loss


def make_batches(n=20, bs=64):
    rng = np.random.RandomState(0)
    w = rng.randn(16, 1).astype("float32")
    out = []
    for _ in range(n):
        xb = rng.randn(bs, 16).astype("float32")
        out.append((xb, (xb @ w).astype("float32")))
    return out


PARAMS = ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0"]


def run_both(batches, strategy_kw, places=PLACES):
    """Losses and final parameters of the reference's ParallelExecutor
    and the port's, the port started from the reference's startup
    values."""
    prog, startup, loss = build_model("ref")
    scope = JScope()
    with j_scope_guard(scope):
        JExecutor().run(startup)
        init = {v.name: np.array(scope.find_var(v.name))
                for v in startup.global_block.vars.values() if v.persistable}
        pe = JParallelExecutor(loss_name=loss.name, main_program=prog,
                               build_strategy=JBuildStrategy(**strategy_kw),
                               scope=scope)
        assert pe.device_count == DP
        ref = [float(np.asarray(pe.run(feed={"x": xb, "y": yb},
                                       fetch_list=[loss])[0]))
               for xb, yb in batches]
        ref_params = {n: np.array(scope.find_var(n)) for n in PARAMS}
    prog, _, loss = build_model("port")
    tscope = tfluid.Scope()
    tscope.load_numpy(init, device="cpu")
    # the strategies' values are the reference's ints
    tpe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                           build_strategy=BuildStrategy(**strategy_kw),
                           scope=tscope, places=places)
    assert tpe.device_count == len(places)
    got = [float(tpe.run(feed={"x": xb, "y": yb}, fetch_list=[loss])[0])
           for xb, yb in batches]
    return dict(ref=ref, got=got, init=init, ref_params=ref_params,
                params=tscope.to_numpy(PARAMS))


def _check(r):
    np.testing.assert_allclose(r["got"], r["ref"], **LOSS_TOL)
    for n in PARAMS:
        np.testing.assert_allclose(r["params"][n], r["ref_params"][n],
                                   err_msg=n, **PARAM_TOL)


def test_dp_matches_single_device_allreduce():
    _check(run_both(make_batches(), {}))


def test_dp_matches_single_device_reduce_sharded():
    """kReduce: optimizer state sharded over dp in the reference; on one
    device a placement only, the same math."""
    assert ReduceStrategy.kReduce == JReduce.kReduce
    _check(run_both(make_batches(), {"reduce_strategy": JReduce.kReduce}))


def test_partial_last_batch_replicates():
    """A training batch that does not divide dp runs as it is (no
    padding rows through a training step)."""
    r = run_both([(np.ones((13, 16), "float32"),
                   np.ones((13, 1), "float32"))], {})
    assert np.isfinite(r["got"][0])
    _check(r)


def test_gradient_scale_kone():
    """kOne seeds the loss grad with dp instead of 1: a dp-times update,
    on both packages."""
    batch = [(np.ones((16, 16), "float32"), np.zeros((16, 1), "float32"))]
    w = "fc_1.w_0"
    assert (GradientScaleStrategy.kOne, GradientScaleStrategy.kCoeffNumDevice
            ) == (JGS.kOne, JGS.kCoeffNumDevice)
    mean = run_both(batch, {"gradient_scale_strategy": JGS.kCoeffNumDevice})
    one = run_both(batch, {"gradient_scale_strategy": JGS.kOne})
    d_mean = mean["init"][w] - mean["params"][w]
    d_one = one["init"][w] - one["params"][w]
    np.testing.assert_allclose(d_one, d_mean * DP, rtol=1e-4, atol=1e-7)
    for r in (mean, one):
        np.testing.assert_allclose(r["init"][w] - r["params"][w],
                                   r["init"][w] - r["ref_params"][w],
                                   rtol=1e-4, atol=1e-7)


def _inference_program(side):
    fluid, Program, guard, unique = PKG[side]
    prog, startup = Program(), Program()
    prog.random_seed = startup.random_seed = 5
    with guard(prog, startup), unique.guard():
        x = fluid.layers.data("x", [6])
        h = fluid.layers.fc(x, 8, act="relu",
                            param_attr=fluid.ParamAttr(name="w1"))
        out = fluid.layers.fc(h, 3, act="softmax",
                              param_attr=fluid.ParamAttr(name="w2"))
    return prog, startup, out


def test_partial_batch_inference_pads_to_dp():
    """A last partial batch of a fetch-only program is padded to the dp
    multiple and the padded rows are cut from the fetch: the result
    equals a plain Executor's and the reference's."""
    xb = np.random.RandomState(0).randn(13, 6).astype("float32")
    prog, startup, out = _inference_program("ref")
    scope = JScope()
    with j_scope_guard(scope):
        JExecutor().run(startup)
        init = {v.name: np.array(scope.find_var(v.name))
                for v in startup.global_block.vars.values() if v.persistable}
        ref, = jfluid.ParallelExecutor(main_program=prog, scope=scope).run(
            fetch_list=[out.name], feed={"x": xb})
    prog, _, out = _inference_program("port")
    tscope = tfluid.Scope()
    tscope.load_numpy(init, device="cpu")
    pe = tfluid.ParallelExecutor(main_program=prog, scope=tscope,
                                 places=PLACES)
    res, = pe.run(fetch_list=[out.name], feed={"x": xb})
    assert pe._padded_batch == 16
    plain, = tfluid.Executor("cpu").run(prog, feed={"x": xb},
                                        fetch_list=[out.name], scope=tscope)
    assert res.shape == (13, 3)
    np.testing.assert_allclose(res, plain, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(res, np.asarray(ref), rtol=2e-5, atol=1e-6)


def test_kone_seed_scaling_is_idempotent():
    """Re-preparing a clone of a prepared program must not scale the
    kOne loss-grad seed again (dp, not dp^2)."""
    prog, startup = TProgram(), TProgram()
    with t_guard(prog, startup), t_unique.guard():
        x = tfluid.layers.data("x", [4])
        y = tfluid.layers.data("y", [1])
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
            tfluid.layers.fc(x, 1), y))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    pe = ParallelExecutor(
        loss_name=loss.name, main_program=prog, scope=tfluid.Scope(),
        places=PLACES, build_strategy=BuildStrategy(
            gradient_scale_strategy=GradientScaleStrategy.kOne))
    dp = pe.mesh.shape["dp"]

    def seed_value(p):
        lg = grad_var_name(loss.name)
        for op in p.global_block.ops:
            if op.type == "fill_constant" and lg in op.output_arg_names():
                return float(op.attr("value", 1.0))
        raise AssertionError("no loss-grad seed op")

    once = pe._prepare_program(prog, {})
    assert seed_value(once) == dp * seed_value(prog)
    again = pe._prepare_program(once.clone(), {})
    assert seed_value(again) == dp * seed_value(prog)
    assert pe._prepare_program(prog, {}) is once


def test_mesh_shapes_and_distinct_devices_raise():
    m = make_mesh(None, ["cpu"] * 4)
    assert m.shape == {"dp": 4} and m.size == 4
    m = make_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8)
    assert m.axis_names == ("dp", "sp") and len(m.axis_devices("sp")) == 4
    assert not m.spans_distinct("dp")
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh({"sp": 4}, ["cpu"] * 2)
    # data parallelism over distinct cards is not ported: no silent replica
    with pytest.raises(NotImplementedError, match="distinct"):
        ParallelExecutor(build_strategy=BuildStrategy(mesh_shape={"dp": 2}),
                         places=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="distinct"):
        ParallelExecutor(build_strategy=BuildStrategy(
            mesh_shape={"dp": 2, "sp": 2}),
            places=["cuda:0", "cuda:0", "cuda:1", "cuda:1"])
    # model parallelism is not ported: its rules are refused, not ignored
    with pytest.raises(NotImplementedError, match="sharding_rules"):
        ParallelExecutor(build_strategy=BuildStrategy(
            sharding_rules=[(r".*fc.*\.w.*", (None, "mp"))]),
            places=["cpu"])


# -- the slice: a 2-layer ring Transformer ----------------------------------

SMALL = dict(src_vocab=50, tgt_vocab=50, max_len=32, d_model=32, n_head=4,
             d_ffn=64, n_layer=2, dropout=0.0)
B, T, SP, STEPS = 4, 32, 4, 2
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


def _feed():
    rs = np.random.RandomState(0)
    m = np.zeros((B, T), "float32")
    for b in range(B):
        m[b, : rs.randint(3, T + 1)] = 1
    return {"src_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "tgt_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "lbl_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "src_mask": m, "tgt_mask": m}


def _build_transformer(Program, guard, unique, module, impl="ring"):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 3
    with guard(main, startup), unique.guard():
        _, loss, _ = module.build(**SMALL, attention_impl=impl)
    params = sorted(p.name for p in main.all_parameters())
    return main, startup, loss, params


@pytest.fixture(scope="module")
def ring_runs():
    main, startup, loss, params = _build_transformer(
        JProgram, j_guard, j_unique, j_transformer)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    scope = JScope()
    with j_scope_guard(scope):
        JExecutor().run(startup)
        init = {v.name: np.array(scope.find_var(v.name))
                for v in startup.global_block.vars.values() if v.persistable}
        pe = JParallelExecutor(
            loss_name=loss.name, main_program=main, scope=scope,
            build_strategy=JBuildStrategy(mesh_shape={"sp": SP}),
            places=jax.devices()[:SP])
        ref = [[np.array(x) for x in pe.run(feed=_feed(), fetch_list=fetch)]
               for _ in range(STEPS)]
        ref_final = {n: np.array(scope.find_var(n)) for n in params}

    main, _, loss, tparams = _build_transformer(
        TProgram, t_guard, t_unique, t_transformer)
    assert tparams == params
    n_ring = sum(op.type == "fused_attention" and op.attr("impl") == "ring"
                 for op in main.global_block.ops)
    tscope = tfluid.Scope()
    tscope.load_numpy(init, device="cpu")
    tpe = ParallelExecutor(
        loss_name=loss.name, main_program=main, scope=tscope,
        build_strategy=BuildStrategy(mesh_shape={"sp": SP}),
        places=["cpu"] * SP)
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    pairs = {"fwd": 0, "dq": 0, "dkv": 0}
    wrapped = {}
    for key, name in (("fwd", "flash_attention_fwd_ring"),
                      ("dq", "flash_attention_bwd_dq_ring"),
                      ("dkv", "flash_attention_bwd_dkv_ring")):
        fn = getattr(TA, name)

        def wrap(*a, _key=key, _fn=fn, **kw):
            calls[_key] += 1
            pairs[_key] += len(a[5])
            return _fn(*a, **kw)
        wrapped[name] = fn
        setattr(TA, name, wrap)
    recomputes = t_lowering.grad_recomputes
    try:
        got = [tpe.run(feed=_feed(), fetch_list=fetch)
               for _ in range(STEPS)]
    finally:
        for name, fn in wrapped.items():
            setattr(TA, name, fn)
    return dict(params=params, ref=ref, ref_final=ref_final, got=got,
                final=tscope.to_numpy(params), init=init, calls=calls,
                pairs=pairs, n_ring=n_ring,
                recomputes=t_lowering.grad_recomputes - recomputes)


def test_ring_transformer_two_adam_steps_match(ring_runs):
    r = ring_runs
    np.testing.assert_allclose([s[0] for s in r["got"]],
                               [s[0] for s in r["ref"]], rtol=1e-5)
    for step in range(STEPS):
        for name, a, b in zip(r["params"], r["got"][step][1:],
                              r["ref"][step][1:]):
            np.testing.assert_allclose(a, b, err_msg=f"{name} step {step}",
                                       **GRAD_TOL)
    for name in r["params"]:
        np.testing.assert_allclose(r["final"][name], r["ref_final"][name],
                                   atol=1e-6, rtol=0, err_msg=name)
        assert not np.array_equal(r["final"][name], r["init"][name]), name


def test_ring_transformer_runs_every_attention_op_on_the_ring(ring_runs):
    """6 attention ops at 2 layers (encoder self, decoder self, cross),
    each a ring over 4 shards on one device: one call of each ring entry
    a hop, 4 a ring op, carrying 16 pairs, 10 for the causal decoder
    self-attention, in the forward and again for K2 and K3 in the
    backward; no gradient re-runs its forward."""
    r = ring_runs
    assert r["n_ring"] == 3 * SMALL["n_layer"]
    per_step = SMALL["n_layer"] * 3 * SP
    assert r["calls"] == {k: per_step * STEPS for k in ("fwd", "dq", "dkv")}
    per_step = SMALL["n_layer"] * (SP * SP + SP * (SP + 1) // 2 + SP * SP)
    assert r["pairs"] == {k: per_step * STEPS for k in ("fwd", "dq", "dkv")}
    assert r["recomputes"] == 0


def test_ring_without_a_mesh_is_the_plain_attention():
    """``impl="ring"`` under a plain Executor (no mesh), or a mesh with
    no ``sp`` axis, computes ``mha_ref``, as the reference falls back to
    ``mha_xla``: the same loss and gradients as ``impl="xla"``."""
    outs = []
    for impl, exe in (("ring", tfluid.Executor("cpu")),
                      ("ring", "dp_mesh"), ("xla", tfluid.Executor("cpu"))):
        main, startup, loss, params = _build_transformer(
            TProgram, t_guard, t_unique, t_transformer, impl)
        scope = tfluid.Scope()
        tfluid.Executor("cpu").run(startup, scope=scope)
        fetch = [loss.name] + [p + "@GRAD" for p in params]
        if exe == "dp_mesh":
            outs.append(ParallelExecutor(
                main_program=main, scope=scope, places=["cpu"] * 2,
                build_strategy=BuildStrategy(mesh_shape={"dp": 2})).run(
                    feed=_feed(), fetch_list=fetch))
        else:
            outs.append(exe.run(main, feed=_feed(), fetch_list=fetch,
                                scope=scope))
    for other in outs[:2]:
        for a, b in zip(other, outs[2]):
            np.testing.assert_array_equal(a, b)
