"""The training rewrites against the reference: every optimizer, the LR
schedules, ``ModelAverage``, the gradient clips and the dense weight
decays.  Each program is built by both packages with the same calls
(the port's serializes to the reference's bytes), the port's scope is
loaded from the reference's startup values, and both run the same
feeds.

Tolerance: the losses and every persistable (parameters, moments,
accumulators, the LR and step counters) within 1e-5 relative, of the
element or of the array's largest magnitude (a fetch over all steps is
one array): a few steps of float32 update arithmetic in two
frameworks.  The op rules of
``optimizer_ops`` are also held one by one at 1e-6 relative (one update
of float32 arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.core import registry as j_registry
from paddle_tpu.core import unique_name as ju
from paddle_tpu.core.selected_rows import SelectedRows as JRows
from paddle_tpu_torch.core import registry as t_registry
from paddle_tpu_torch.core import unique_name as tu
from paddle_tpu_torch.core.registry import LowerContext
from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows

REL = 1e-5


def _close(got, want, rel=REL, err_msg=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale, err_msg=err_msg)


def _persistables(prog):
    return sorted(v.name for v in prog.global_block.vars.values()
                  if v.persistable)


def run_both(build, feeds, fetch=("loss",), after=None):
    """Build with both packages, copy the reference's startup values
    into the port's scope, run ``feeds`` in both; returns per package
    (fetches per step, persistables after the last step, the built
    handles).  ``after(fluid, exe, handles)`` runs inside the scope after
    the steps (ModelAverage's apply/restore)."""
    out, init = {}, None
    for name, fluid, unique in (("ref", jf, ju), ("port", tf, tu)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.program_guard(main, startup), unique.guard():
            handles = build(fluid)
        exe = fluid.Executor() if name == "ref" else fluid.Executor("cpu")
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            if name == "ref":
                exe.run(startup)
                init = {n: np.asarray(scope.find_var(n))
                        for n in _persistables(startup)}
            else:
                scope.load_numpy(init, device="cpu")
            fetched = [[np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=[handles[k] for k in fetch],
                sync=True)] for f in feeds]
            extra = after(fluid, exe, handles, scope) if after else None
            state = {n: np.asarray(scope.find_var(n)).copy()
                     for n in _persistables(main)
                     if scope.find_var(n) is not None}
        out[name] = dict(fetched=fetched, state=state, main=main,
                         extra=extra)
    assert out["port"]["main"].serialize() == out["ref"]["main"].serialize()
    return out


def assert_same_run(out, rel=REL):
    ref, port = out["ref"], out["port"]
    # each fetch over the steps as one array: a loss that training
    # drives toward 0 is held relative to its trajectory's largest
    for i, w in enumerate(zip(*ref["fetched"])):
        g = [step[i] for step in port["fetched"]]
        _close(np.stack(g), np.stack(w), rel, err_msg=f"fetch {i}")
    assert sorted(port["state"]) == sorted(ref["state"])
    for n, w in ref["state"].items():
        _close(port["state"][n], w, rel, err_msg=n)


def _quadratic(make_opt):
    def build(fluid):
        x = fluid.layers.data("x", [4])
        pred = fluid.layers.fc(x, 1, bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square(pred))
        make_opt(fluid).minimize(loss)
        return {"loss": loss}
    return build


# the reference's test_optimizer_reduces_quadratic list
OPTIMIZERS = {
    "sgd": lambda f: f.optimizer.SGD(0.1),
    "momentum": lambda f: f.optimizer.Momentum(0.1, momentum=0.9),
    "adam": lambda f: f.optimizer.Adam(0.1),
    "adagrad": lambda f: f.optimizer.Adagrad(0.5),
    "adamax": lambda f: f.optimizer.Adamax(0.1),
    "decayed_adagrad": lambda f: f.optimizer.DecayedAdagrad(0.5),
    "adadelta": lambda f: f.optimizer.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda f: f.optimizer.RMSProp(0.05),
    "ftrl": lambda f: f.optimizer.Ftrl(0.5),
    "lars_momentum": lambda f: f.optimizer.LarsMomentum(
        1.0, momentum=0.9, lars_coeff=0.2),
    # beyond the list: the centered RMSProp with momentum, Ftrl's l1/l2
    "rmsprop_centered": lambda f: f.optimizer.RMSProp(
        0.05, momentum=0.5, centered=True),
    "ftrl_l1_l2": lambda f: f.optimizer.Ftrl(0.5, l1=0.01, l2=0.02),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference_after_five_steps(name):
    rs = np.random.RandomState(1)
    feeds = [{"x": rs.randn(8, 4).astype("float32")} for _ in range(5)]
    out = run_both(_quadratic(OPTIMIZERS[name]), feeds)
    assert_same_run(out)
    losses = [float(f[0]) for f in out["port"]["fetched"]]
    assert losses[-1] != losses[0]


def test_every_optimizer_op_type_is_registered():
    from paddle_tpu.ops import optimizer_ops as j_opt
    types = {t for t in j_registry.all_ops()
             if j_registry.get(t).lower.__module__ == j_opt.__name__}
    assert len(types) == 13 and types <= set(t_registry.all_ops())


SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.5, 4, 0.8),
    "exponential_staircase": lambda L: L.exponential_decay(0.5, 4, 0.8,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.5, 5, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.5, 5, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.5, 3, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.5, 3, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.5, 12, 0.01, power=2.0),
    "piecewise": lambda L: L.piecewise_decay([3, 8, 15], [0.1, 0.05, 0.01,
                                                          0.001]),
    "cosine": lambda L: L.cosine_decay(0.5, 3, 8),
    "noam": lambda L: L.noam_decay(64, 6),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_reference_over_twenty_steps(name):
    def build(fluid):
        lr = SCHEDULES[name](fluid.layers.learning_rate_scheduler)
        x = fluid.layers.data("x", [2])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1, bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(lr).minimize(loss)
        return {"loss": loss, "lr": lr}

    rs = np.random.RandomState(3)
    feeds = []
    for _ in range(20):
        xb = rs.randn(4, 2).astype("float32")
        feeds.append({"x": xb, "y": xb @ np.array([[1.5], [-2.0]],
                                                  "float32")})
    out = run_both(build, feeds, fetch=("lr", "loss"))
    assert_same_run(out)
    lrs = [float(f[0]) for f in out["port"]["fetched"]]
    # the rate itself: a few float32 ops a step, within 1e-6
    _close(lrs, [float(f[0]) for f in out["ref"]["fetched"]], 1e-6)
    assert len(set(lrs)) > 2, lrs


def test_model_average_applies_and_restores_as_the_reference():
    """ModelAverage's apply program puts the window's mean in place of
    each parameter and restore puts the live value back, bit for bit;
    the averaged values equal the reference's."""
    def build(fluid):
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1, param_attr=fluid.ParamAttr(name="w"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
        ma = fluid.optimizer.ModelAverage(
            1.0, min_average_window=3, max_average_window=4)
        return {"loss": loss, "ma": ma}

    def after(fluid, exe, handles, scope):
        live = {n: np.asarray(scope.find_var(n)).copy()
                for n in ("w", "fc_0.b_0")}
        with handles["ma"].apply(exe):
            applied = {n: np.asarray(scope.find_var(n)).copy() for n in live}
        restored = {n: np.asarray(scope.find_var(n)).copy() for n in live}
        return live, applied, restored

    rs = np.random.RandomState(0)
    feeds = []
    for _ in range(6):
        xb = rs.randn(8, 4).astype("float32")
        feeds.append({"x": xb, "y": xb.sum(1, keepdims=True)})
    out = run_both(build, feeds, after=after)
    assert_same_run(out)
    live, applied, restored = out["port"]["extra"]
    _, ref_applied, _ = out["ref"]["extra"]
    for n in live:
        assert restored[n].tobytes() == live[n].tobytes(), n
        assert not np.array_equal(applied[n], live[n]), n
        _close(applied[n], ref_applied[n], err_msg=n)


def _clipped(clip=None, reg=None, opt=lambda f: f.optimizer.Adam(0.05)):
    def build(fluid):
        x = fluid.layers.data("x", [6])
        h = fluid.layers.fc(x, 5, act="tanh")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square(pred))
        if clip is not None:
            fluid.clip.set_gradient_clip(clip(fluid))
        try:
            kw = {} if reg is None else {"regularization": reg(fluid)}
            o = opt(fluid)
            o.regularization = kw.get("regularization")
            o.minimize(loss)
        finally:
            fluid.clip.set_gradient_clip(None)
        return {"loss": loss}
    return build


REWRITES = {
    "clip_by_value": dict(clip=lambda f: f.clip.GradientClipByValue(0.05)),
    "clip_by_value_min": dict(
        clip=lambda f: f.clip.GradientClipByValue(0.05, min=-0.02)),
    "clip_by_norm": dict(clip=lambda f: f.clip.GradientClipByNorm(0.1)),
    "clip_by_global_norm": dict(
        clip=lambda f: f.clip.GradientClipByGlobalNorm(0.2)),
    "l2_decay": dict(reg=lambda f: f.regularizer.L2Decay(0.1)),
    "l1_decay": dict(reg=lambda f: f.regularizer.L1Decay(0.1)),
    "l1_decay_momentum_global_norm": dict(
        clip=lambda f: f.clip.GradientClipByGlobalNorm(0.2),
        reg=lambda f: f.regularizer.L1Decay(0.05),
        opt=lambda f: f.optimizer.Momentum(0.1, 0.9)),
}


@pytest.mark.parametrize("name", list(REWRITES))
def test_clip_and_decay_match_reference(name):
    rs = np.random.RandomState(2)
    feeds = [{"x": rs.randn(16, 6).astype("float32") * 3}
             for _ in range(4)]
    assert_same_run(run_both(_clipped(**REWRITES[name]), feeds))


def test_append_lars_and_l2_normalize_match_reference():
    """``append_LARS``'s per-parameter rates (``squared_l2_norm``) and
    ``l2_normalize`` (``norm``) in one program, fetched from both."""
    def build(fluid):
        x = fluid.layers.data("x", [6])
        h = fluid.layers.l2_normalize(fluid.layers.fc(x, 5), axis=1)
        loss = fluid.layers.mean(fluid.layers.square(fluid.layers.fc(h, 1)))
        pg = fluid.append_backward(loss)
        lr = fluid.layers.fill_constant([1], "float32", 0.1)
        lrs = fluid.layers.append_LARS(pg, lr, 5e-4)
        return {"loss": loss, **{f"lr{i}": v for i, v in enumerate(lrs)}}

    rs = np.random.RandomState(4)
    out = run_both(build, [{"x": rs.randn(8, 6).astype("float32")}],
                   fetch=("loss", "lr0", "lr1", "lr2", "lr3"))
    assert_same_run(out, rel=1e-6)


# -- the nine op rules one by one, at 1e-6 (one update) ----------------

def _opt_case(rs):
    f = lambda *s: rs.randn(*s).astype("float32")  # noqa: E731
    p, g = f(5, 3), f(5, 3)
    pos = lambda *s: np.abs(f(*s)) + 0.1  # noqa: E731
    lr = np.array(0.05, "float32")
    return {
        "decayed_adagrad": ({"Param": [p], "Grad": [g], "Moment": [pos(5, 3)],
                             "LearningRate": [lr]},
                            {"decay": 0.9, "epsilon": 1e-6}),
        "adamax": ({"Param": [p], "Grad": [g], "Moment": [f(5, 3)],
                    "InfNorm": [pos(5, 3)], "Beta1Pow": [
                        np.array(0.81, "float32")], "LearningRate": [lr]},
                   {"beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8}),
        "adadelta": ({"Param": [p], "Grad": [g], "AvgSquaredGrad": [
            pos(5, 3)], "AvgSquaredUpdate": [pos(5, 3)],
            "LearningRate": [lr]}, {"rho": 0.9, "epsilon": 1e-6}),
        "rmsprop": ({"Param": [p], "Grad": [g], "MeanSquare": [pos(5, 3)],
                     "Moment": [f(5, 3)], "LearningRate": [lr]},
                    {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.3}),
        "rmsprop_centered": ({"Param": [p], "Grad": [g], "MeanSquare": [
            pos(5, 3) + 1.0], "Moment": [f(5, 3)], "MeanGrad": [f(5, 3) * .1],
            "LearningRate": [lr]}, {"decay": 0.9, "epsilon": 1e-6,
                                    "momentum": 0.3, "centered": True}),
        "ftrl": ({"Param": [p], "Grad": [g], "SquaredAccumulator": [
            pos(5, 3)], "LinearAccumulator": [f(5, 3)],
            "LearningRate": [lr]}, {"l1": 0.2, "l2": 0.1, "lr_power": -0.5}),
        "lars_momentum": ({"Param": [p], "Grad": [g], "Velocity": [f(5, 3)],
                           "LearningRate": [lr]},
                          {"mu": 0.9, "lars_coeff": 0.01,
                           "lars_weight_decay": 5e-4}),
        "proximal_gd": ({"Param": [p], "Grad": [g], "LearningRate": [lr]},
                        {"l1": 0.5, "l2": 0.1}),
        "proximal_adagrad": ({"Param": [p], "Grad": [g], "Moment": [
            pos(5, 3)], "LearningRate": [lr]}, {"l1": 0.5, "l2": 0.1}),
        "average_accumulates": ({
            "param": [p], "in_sum_1": [f(5, 3)], "in_sum_2": [f(5, 3)],
            "in_sum_3": [f(5, 3)],
            "in_num_accumulates": [np.array([3], "int64")],
            "in_old_num_accumulates": [np.array([2], "int64")],
            "in_num_updates": [np.array([6], "int64")]},
            {"average_window": 0.5, "min_average_window": 4,
             "max_average_window": 10}),
        "average_accumulates_open": ({
            "param": [p], "in_sum_1": [f(5, 3)], "in_sum_2": [f(5, 3)],
            "in_sum_3": [f(5, 3)],
            "in_num_accumulates": [np.array([1], "int64")],
            "in_old_num_accumulates": [np.array([0], "int64")],
            "in_num_updates": [np.array([16383], "int64")]},
            {"average_window": 0.5, "min_average_window": 4,
             "max_average_window": 10}),
    }


OP_CASES = _opt_case(np.random.RandomState(9))


@pytest.mark.parametrize("case", list(OP_CASES))
def test_optimizer_op_rule_matches_reference(case):
    op = case.split("_centered")[0].split("_open")[0]
    ins, attrs = OP_CASES[case]
    want = j_registry.get(op).lower(
        None, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        attrs)
    got = t_registry.get(op).lower(
        LowerContext(), {k: [torch.from_numpy(a.copy()) for a in v]
                         for k, v in ins.items()}, attrs)
    assert sorted(got) == sorted(want)
    for slot, (w,) in want.items():
        g = got[slot][0].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, slot
        if np.issubdtype(w.dtype, np.floating):
            _close(g, w, 1e-6, err_msg=slot)
        else:
            np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("op", ["decayed_adagrad", "adamax", "adadelta",
                                "rmsprop", "ftrl", "lars_momentum",
                                "proximal_gd", "proximal_adagrad"])
def test_dense_only_rules_refuse_selected_rows(op):
    """The eight dense-only rules raise on a SelectedRows gradient with
    the reference's message."""
    case = op if op in OP_CASES else "rmsprop"
    ins, attrs = OP_CASES[case]
    rows = np.array([0, 2], "int64")
    vals = np.ones((2, 3), "float32")
    for registry, wrap, sr in (
            (j_registry, jnp.asarray, JRows(jnp.asarray(rows),
                                             jnp.asarray(vals), 5)),
            (t_registry, torch.from_numpy,
             TRows(torch.from_numpy(rows), torch.from_numpy(vals), 5))):
        cur = {k: [wrap(a.copy()) for a in v] for k, v in ins.items()}
        cur["Grad"] = [sr]
        ctx = LowerContext() if registry is t_registry else None
        with pytest.raises(NotImplementedError,
                           match=f"optimizer op '{op}' has no sparse"):
            registry.get(op).lower(ctx, cur, attrs)
