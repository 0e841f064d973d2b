"""The layers of the training-rewrites slice: each name it adds to
``layers`` exists in the port with the reference's parameters
(``inspect.signature``), and programs built from them with the same
calls serialize to the reference's bytes and compute the reference's
values, forward and gradient, from the same starting values.

Tolerance: float outputs and gradients within 1e-5 relative, of the
element or of the array's largest magnitude (a small fc and the layers'
float32 math in two frameworks); integer and boolean outputs exactly.
"""
import inspect

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu.core import unique_name as ju
from paddle_tpu_torch.core import unique_name as tu

REL = 1e-5

# the public names of ``layers`` this slice adds to the port (the
# generated activations of ``layers/ops.py`` among them)
ADDED = [
    "Print", "abs", "append_LARS", "argmax", "argmin",
    "autoincreased_step_counter", "brelu", "ceil", "clip", "clip_by_norm",
    "cos", "create_global_var", "create_tensor", "cumsum",
    "elementwise_max", "elementwise_pow", "elu", "exp", "floor", "gelu",
    "hard_shrink", "hard_sigmoid", "has_inf", "has_nan", "isfinite",
    "l2_normalize", "leaky_relu", "logsigmoid", "maxout", "one_hot", "pad",
    "pow", "reciprocal", "reduce_max", "reduce_mean", "reduce_min",
    "reduce_prod", "relu6", "round", "rsqrt", "scatter", "shape", "sign",
    "sin", "soft_relu", "softplus", "softshrink", "softsign", "split",
    "sqrt", "stack", "stanh", "sum", "swish", "tanh_shrink",
    "thresholded_relu", "zeros_like",
]


@pytest.mark.parametrize("name", ADDED)
def test_layer_has_the_references_signature(name):
    want = inspect.signature(getattr(jf.layers, name))
    got = inspect.signature(getattr(tf.layers, name))
    assert [(p.name, p.kind, p.default) for p in got.parameters.values()] \
        == [(p.name, p.kind, p.default) for p in want.parameters.values()]


@pytest.mark.parametrize("module,name", [
    ("learning_rate_scheduler", n) for n in (
        "exponential_decay", "natural_exp_decay", "inverse_time_decay",
        "polynomial_decay", "piecewise_decay", "cosine_decay")] + [
    ("nets", "glu"), ("optimizer", "ModelAverage"),
    ("optimizer", "RMSPropOptimizer"), ("optimizer", "FtrlOptimizer"),
    ("optimizer", "LarsMomentumOptimizer"), ("optimizer", "AdamaxOptimizer"),
    ("optimizer", "AdadeltaOptimizer"),
    ("optimizer", "DecayedAdagradOptimizer")])
def test_module_function_has_the_references_signature(module, name):
    def find(pkg):
        obj = pkg
        for part in ("layers." + module if module.startswith("learning")
                     else module).split("."):
            obj = getattr(obj, part)
        return inspect.signature(getattr(obj, name))
    assert str(find(tf)) == str(find(jf))


def test_added_names_are_every_reference_name_of_the_slice():
    """The port's ``layers`` now has each name above, and ``ops``'
    whole generated list."""
    assert set(ADDED) <= set(dir(tf.layers))
    assert tf.layers.ops.__all__ == jf.layers.ops.__all__
    assert len(jf.layers.ops.__all__) == 33


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                      want.astype(np.int64), err_msg=err_msg)
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=REL,
                               atol=REL * scale, err_msg=err_msg)


def _layers_program(fluid):
    """One program over the slice's layers; returns (fetch names, the
    parameters whose gradients to fetch)."""
    L = fluid.layers
    add, sub, mul = L.elementwise_add, L.elementwise_sub, L.elementwise_mul
    x = L.data("x", [12])
    ids = L.data("ids", [1], dtype="int64")
    h = L.fc(x, 12, act="softsign")
    a, b, c = L.split(h, [4, 4, 4], dim=1)
    g = fluid.nets.glu(L.concat([a, b], axis=1), dim=1)          # [B, 4]
    st = L.stack([g, L.relu6(c), L.elementwise_max(a, b)], axis=1)
    r = sub(add(L.reduce_mean(st, dim=1), L.reduce_max(st, dim=[1])),
            L.reduce_min(st, dim=1))                            # [B, 4]
    p = L.reduce_prod(L.sigmoid(st), dim=2, keep_dim=True)
    oh = L.one_hot(ids, depth=4)
    mixed = L.sums([mul(r, oh), L.clip(r, -0.3, 0.3), L.clip_by_norm(r, 0.5),
                    L.l2_normalize(r, axis=1)])
    acts = [getattr(L, n)(mixed) for n in (
        "abs", "exp", "logsigmoid", "tanh_shrink", "softplus", "softsign",
        "sin", "cos", "brelu", "elu", "leaky_relu", "soft_relu", "stanh",
        "swish", "hard_sigmoid", "hard_shrink", "thresholded_relu",
        "gelu")]
    acts.append(L.softshrink(mixed, **{"lambda": 0.25}))
    half = L.fill_constant([1], "float32", 0.5)
    pos = add(L.abs(mixed), half)
    acts.append(L.pow(pos, factor=1.5))
    acts.append(L.sqrt(pos))
    acts.append(L.elementwise_pow(pos, add(L.abs(r), half)))
    total = L.sum(acts)
    cs = L.cumsum(total, axis=1, reverse=True)
    padded = L.pad(cs, [0, 1, 2, 0], pad_value=0.5)             # [B+1, 6]
    mo = L.maxout(L.reshape(padded, [-1, 6, 1, 1]), groups=2)
    loss = add(L.mean(mo), L.reduce_sum(p))
    ints = [L.argmax(total, axis=1), L.argmin(total, axis=1),
            L.shape(padded), L.isfinite(total), L.has_inf(total),
            L.has_nan(total), L.sign(total), L.floor(total),
            L.ceil(total), L.round(total)]
    z = L.zeros_like(total)
    sc = L.scatter(total, L.fill_constant([2], "int64", 1.0),
                   L.slice(r, [0], [0], [2]), overwrite=False)
    fluid.optimizer.SGD(0.1).minimize(loss)
    fetch = [loss, total, cs, padded, mo, z, sc] + ints
    params = sorted(pp.name for pp in fluid.default_main_program()
                    .all_parameters())
    return [v.name for v in fetch], params


def test_layers_program_matches_reference_forward_and_gradient():
    rs = np.random.RandomState(7)
    feed = {"x": rs.randn(6, 12).astype("float32"),
            "ids": np.array([[0], [3], [1], [2], [3], [0]], "int64")}
    out, init = {}, None
    for name, fluid, unique in (("ref", jf, ju), ("port", tf, tu)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.program_guard(main, startup), unique.guard():
            fetch, params = _layers_program(fluid)
        exe = fluid.Executor() if name == "ref" else fluid.Executor("cpu")
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            if name == "ref":
                exe.run(startup)
                init = {v.name: np.asarray(scope.find_var(v.name)).copy()
                        for v in startup.global_block.vars.values()
                        if v.persistable}
            else:
                scope.load_numpy(init, device="cpu")
            names = fetch + [p + "@GRAD" for p in params]
            out[name] = (main, [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=names, sync=True)], names)
    assert out["port"][0].serialize() == out["ref"][0].serialize()
    for n, g, w in zip(out["ref"][2], out["port"][1], out["ref"][1]):
        assert g.shape == w.shape, n
        _close(g, w, err_msg=n)


def test_print_and_step_counter_layers_run(capsys):
    """``Print`` passes its input through and prints it each run;
    ``autoincreased_step_counter`` counts runs from ``begin``;
    ``create_global_var``'s value is its initializer's."""
    main, startup = tf.Program(), tf.Program()
    with tf.program_guard(main, startup), tu.guard():
        x = tf.layers.data("x", [3])
        shown = tf.layers.Print(x, message="batch x")
        step = tf.layers.autoincreased_step_counter(begin=5, step=2)
        gv = tf.layers.create_global_var([2], 1.25, "float32",
                                         persistable=True, name="gv")
        out = tf.layers.elementwise_mul(shown, tf.layers.reduce_sum(gv))
    exe, scope = tf.Executor("cpu"), tf.Scope()
    xb = np.arange(6, dtype="float32").reshape(2, 3)
    with tf.scope_guard(scope):
        exe.run(startup)
        got = [exe.run(main, feed={"x": xb}, fetch_list=[out, step],
                       sync=True) for _ in range(3)]
    np.testing.assert_array_equal(got[0][0], xb * 2.5)
    assert [float(s) for _, s in got] == [5.0, 7.0, 9.0]
    printed = capsys.readouterr().out
    assert printed.count("batch x") == 3
