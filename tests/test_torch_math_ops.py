"""The math op rules of the training-rewrites slice against the
reference's: the 43 op types of ``paddle_tpu/ops/math_ops.py`` that the
earlier slices lacked, ``maxout`` (the registered rule is
``misc_ops``'s), ``squared_l2_norm`` (``misc_ops``) and ``norm``
(``nn_ops``), each on the same numpy inputs.

Forward: every output slot; integer and boolean outputs exactly, float
outputs within 1e-6 relative, of the element or of the array's largest
magnitude (float32 elementwise math and short reductions in two
frameworks: a last-place difference of tanh near 1 leaves 1 - tanh^2 a
few 1e-7 apart).
Gradient, where the op has one: the gradient of sum(out * cot) over the
float outputs, with the same random cotangents, with respect to every
float input (jax.grad of the reference rule against torch autograd of
the port's), at the same tolerance.  The inputs hold the points where
torch's own gradient differs from jax's: 0 for ``abs`` and
``leaky_relu``, each bound of ``clip``, ``relu6``, ``brelu``,
``hard_sigmoid`` and ``soft_relu``, ties of ``elementwise_max`` and
``reduce_max``/``min``, a zero in ``reduce_prod``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as j_registry
from paddle_tpu.core.selected_rows import SelectedRows as JRows
from paddle_tpu_torch.core import registry as t_registry
from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows

REL = 1e-6


def _close(got, want, err_msg=""):
    """Within REL of the element or of max|want| (module doc)."""
    want = np.asarray(want)
    scale = float(np.nanmax(np.abs(want[np.isfinite(want)]), initial=0.0))
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale,
                               err_msg=err_msg)

_RS = np.random.RandomState(25)

# the points where torch's and jax's gradients part: 0, each bound
EDGE = np.array([-1.0, 0.0, 0.5, 6.0, 1.0, -2.5, 2.5, 24.0, -0.5, 2.0,
                 -2.0], "float32")


def _f(*shape, lo=None):
    x = _RS.randn(*shape).astype("float32")
    return np.abs(x) + lo if lo is not None else x


def _edge(n=5):
    """[n, 11 + 6]: the edge points in every row, then random values."""
    return np.concatenate([np.tile(EDGE, (n, 1)), _f(n, 6) * 3], 1)


def _ties(n=4, w=6):
    """Rows whose max and min each appear twice."""
    x = _f(n, w)
    x[:, 1] = x.max(1)
    x[:, 2] = x[:, 1]
    x[:, 3] = x.min(1)
    x[:, 4] = x[:, 3]
    return x


_X = _edge()
_Y = _f(*_X.shape)
_Y[:, :4] = _X[:, :4]                     # elementwise_max ties
_POS = _f(4, 7, lo=0.25)
_PROD = _f(3, 4, 5)
_PROD[1, 2, 3] = 0.0                      # a zero in the product
_INF = _f(3, 4)
_INF[1, 2] = np.inf
_NAN = _f(3, 4)
_NAN[2, 0] = np.nan
_MAXOUT = _f(2, 6, 4, 5)
_MAXOUT[:, 1, :2] = _MAXOUT[:, 0, :2]     # tied maxima within a group
_MOD_X = np.array([[-7.5, -2.0, 0.0, 3.25, 7.0, -0.75],
                   [5.5, -5.5, 1.0, -1.0, 9.0, 2.5]], "float32")
_MOD_Y = np.array([[2.0, 3.0, 1.5, -2.0, -3.0, 0.5],
                   [-2.5, 2.5, 4.0, 4.0, 2.0, -1.0]], "float32")


def _unary(op, x=None, attrs=None, grad=True):
    x = _X if x is None else x
    return (op, {"X": [x]}, attrs or {}, [("X", 0)] if grad else [])


# name: (op type, {slot: [arrays]}, attrs, [(slot, j) float inputs to
# differentiate])
CASES = {
    "elementwise_max": ("elementwise_max", {"X": [_X], "Y": [_Y]}, {},
                        [("X", 0), ("Y", 0)]),
    "elementwise_max_axis": ("elementwise_max", {
        "X": [_f(2, 3, 4)], "Y": [_f(3)]}, {"axis": 1},
        [("X", 0), ("Y", 0)]),
    "elementwise_pow": ("elementwise_pow", {"X": [_POS], "Y": [_f(4, 7)]},
                        {}, [("X", 0), ("Y", 0)]),
    "elementwise_mod": ("elementwise_mod", {"X": [_MOD_X], "Y": [_MOD_Y]},
                        {}, [("X", 0), ("Y", 0)]),
    "elementwise_mod_int": ("elementwise_mod", {
        "X": [_MOD_X.astype("int64") * 3], "Y": [_MOD_Y.astype("int64") + 5]},
        {}, []),
    "elementwise_floordiv": ("elementwise_floordiv", {
        "X": [_MOD_X], "Y": [_MOD_Y]}, {}, [("X", 0), ("Y", 0)]),
    "elementwise_floordiv_int": ("elementwise_floordiv", {
        "X": [_MOD_X.astype("int64") * 3], "Y": [_MOD_Y.astype("int64") + 5]},
        {}, []),
    "logsigmoid": _unary("logsigmoid"),
    "tanh_shrink": _unary("tanh_shrink"),
    "exp": _unary("exp"),
    "sqrt": _unary("sqrt", _POS),
    "rsqrt": _unary("rsqrt", _POS),
    "abs": _unary("abs"),
    "ceil": _unary("ceil"),
    "floor": _unary("floor"),
    "round": _unary("round", np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5,
                                        0.49, -0.51]], "float32")),
    "reciprocal": _unary("reciprocal", _POS),
    "sin": _unary("sin"),
    "cos": _unary("cos"),
    "softplus": _unary("softplus", np.concatenate(
        [_X, np.array([[-30.0, 30.0, -100.0, 100.0, 15.0]] * 5, "float32")],
        1)),
    "softsign": _unary("softsign"),
    "softshrink": _unary("softshrink", attrs={"lambda": 0.5}),
    "relu6": _unary("relu6"),
    "leaky_relu": _unary("leaky_relu", attrs={"alpha": 0.1}),
    "elu": _unary("elu", attrs={"alpha": 0.7}),
    "swish": _unary("swish", attrs={"beta": 1.5}),
    # slope 0.25: x = +-2 meet the bounds exactly (0.2 * -2.5 + 0.5
    # misses 0 by 7e-9 where XLA contracts it into one fused multiply-add)
    "hard_sigmoid": _unary("hard_sigmoid", attrs={"slope": 0.25,
                                                  "offset": 0.5}),
    "brelu": _unary("brelu", attrs={"t_min": 1.0, "t_max": 6.0}),
    "stanh": _unary("stanh", attrs={"scale_a": 0.67, "scale_b": 1.7159}),
    "hard_shrink": _unary("hard_shrink", attrs={"threshold": 0.5}),
    "thresholded_relu": _unary("thresholded_relu", attrs={"threshold": 1.0}),
    "maxout": ("maxout", {"X": [_MAXOUT]}, {"groups": 2}, [("X", 0)]),
    "log_softmax": _unary("log_softmax", _f(3, 4, 6), {"axis": -1}),
    "log_softmax_axis1": _unary("log_softmax", _f(3, 4, 6), {"axis": 1}),
    "reduce_mean": ("reduce_mean", {"X": [_f(3, 4, 5)]},
                    {"dim": [0, 2], "keep_dim": False}, [("X", 0)]),
    "reduce_mean_all": ("reduce_mean", {"X": [_f(3, 4)]},
                        {"reduce_all": True, "keep_dim": True}, [("X", 0)]),
    "reduce_max": ("reduce_max", {"X": [_ties()]}, {"dim": [1]}, [("X", 0)]),
    "reduce_max_all": ("reduce_max", {"X": [_ties()]},
                       {"reduce_all": True}, [("X", 0)]),
    "reduce_min": ("reduce_min", {"X": [_ties()]},
                   {"dim": [-1], "keep_dim": True}, [("X", 0)]),
    "reduce_prod": ("reduce_prod", {"X": [_PROD]}, {"dim": [2]},
                    [("X", 0)]),
    "reduce_prod_two_axes": ("reduce_prod", {"X": [_PROD]},
                             {"dim": [0, 2], "keep_dim": True}, [("X", 0)]),
    "clip": _unary("clip", attrs={"min": -1.0, "max": 2.0}),
    "clip_by_norm": _unary("clip_by_norm", attrs={"max_norm": 1.0}),
    "clip_by_norm_inside": _unary("clip_by_norm", attrs={"max_norm": 1e3}),
    "isfinite": ("isfinite", {"X": [_f(3, 4), _INF]}, {}, []),
    "isfinite_all": ("isfinite", {"X": [_f(3, 4), _f(2)]}, {}, []),
    "has_inf": ("has_inf", {"X": [_INF]}, {}, []),
    "has_inf_none": ("has_inf", {"X": [_NAN]}, {}, []),
    "has_nan": ("has_nan", {"X": [_NAN]}, {}, []),
    "has_nan_none": ("has_nan", {"X": [_INF]}, {}, []),
    "soft_relu": _unary("soft_relu", attrs={"threshold": 2.0}),
    "sign": _unary("sign"),
    "cumsum": _unary("cumsum", _f(3, 5), {"axis": 1}),
    "cumsum_exclusive": _unary("cumsum", _f(3, 5), {"axis": 0,
                                                    "exclusive": True}),
    "cumsum_reverse": _unary("cumsum", _f(3, 5), {"axis": -1,
                                                  "reverse": True}),
    "cumsum_reverse_exclusive": _unary("cumsum", _f(3, 5),
                                       {"axis": 1, "reverse": True,
                                        "exclusive": True}),
    "global_norm_sq": ("__global_norm_sq__", {"X": [_f(4, 6)]}, {}, []),
    "global_norm_factor": ("__global_norm_factor__", {
        "X": [np.array(9.0, "float32")]}, {"clip_norm": 1.0}, []),
    "global_norm_factor_inside": ("__global_norm_factor__", {
        "X": [np.array(0.25, "float32")]}, {"clip_norm": 1.0}, []),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_f(3, 5)]}, {},
                        [("X", 0)]),
    "norm": ("norm", {"X": [_f(3, 4, 5)]}, {"axis": 1, "epsilon": 1e-10},
             [("X", 0)]),
}


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _cotangents(outs):
    rs = np.random.RandomState(5)
    return {k: np.asarray(rs.randn(*np.shape(v)), "float32")
            for k, v in sorted(outs.items()) if _is_float(v)}


def _reference(op, ins, attrs, wrt):
    rule = j_registry.get(op).lower
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}

    def call(*xs):
        cur = {k: list(v) for k, v in jins.items()}
        for (slot, j), x in zip(wrt, xs):
            cur[slot][j] = x
        return {k: v[0] for k, v in rule(None, cur, attrs).items()}

    xs = [jins[s][j] for s, j in wrt]
    # jitted, as the reference's executor runs its rules
    outs = {k: np.asarray(v) for k, v in jax.jit(call)(*xs).items()}
    if not wrt:
        return outs, None, None
    cots = _cotangents(outs)

    def loss(*xs):
        o = call(*xs)
        return sum(jnp.sum(o[k].astype(jnp.float32) * c)
                   for k, c in cots.items())

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(wrt)))))(*xs)
    return outs, cots, [np.asarray(g) for g in grads]


def _port(op, ins, attrs, wrt, cots):
    rule = t_registry.get(op).lower
    tins = {k: [torch.from_numpy(np.array(a)) for a in v]
            for k, v in ins.items()}
    leaves = []
    for slot, j in wrt:
        tins[slot][j] = tins[slot][j].requires_grad_(True)
        leaves.append(tins[slot][j])
    outs = rule(None, tins, attrs)
    got = {k: v[0].detach().numpy() for k, v in outs.items()}
    if not wrt:
        return got, None
    loss = sum((outs[k][0].float() * torch.from_numpy(c)).sum()
               for k, c in cots.items())
    if not loss.requires_grad:    # a rounding (floor_divide): no gradient
        return got, [np.zeros(tuple(leaf.shape), "float32")
                     for leaf in leaves]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return got, [np.zeros(tuple(leaf.shape), "float32") if g is None
                 else g.numpy() for g, leaf in zip(grads, leaves)]


def _compare(got, want):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for slot, w in want.items():
        g = got[slot]
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        if _is_float(w):
            assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
            _close(g, w, err_msg=slot)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=slot)


@pytest.mark.parametrize("case", list(CASES))
def test_rule_matches_reference(case):
    op, ins, attrs, wrt = CASES[case]
    want, cots, gwant = _reference(op, ins, attrs, wrt)
    got, ggot = _port(op, ins, attrs, wrt, cots)
    _compare(got, want)
    for (slot, j), g, w in zip(wrt, ggot or [], gwant or []):
        _close(g, w, err_msg=f"{slot}[{j}] grad")


def test_every_math_op_type_is_registered():
    """The port registers every op type of the reference's math_ops
    (``maxout`` by the rule the reference registers last, misc_ops'),
    and the cases here cover each type this slice added."""
    from paddle_tpu.ops import math_ops as j_math
    ref = set(j_registry.all_ops())
    math_types = {t for t in ref
                  if j_registry.get(t).lower.__module__ == j_math.__name__}
    assert math_types <= set(t_registry.all_ops())
    assert "maxout" in set(t_registry.all_ops())
    assert len(math_types) == 73          # maxout registered last by misc
    covered = {c[0] for c in CASES.values()}
    assert covered >= {"elementwise_max", "elementwise_pow",
                       "elementwise_mod", "elementwise_floordiv", "maxout",
                       "log_softmax", "reduce_mean", "reduce_max",
                       "reduce_min", "reduce_prod", "clip", "clip_by_norm",
                       "isfinite", "has_inf", "has_nan", "soft_relu",
                       "sign", "cumsum", "__global_norm_sq__",
                       "__global_norm_factor__", "squared_l2_norm", "norm"}


@pytest.mark.parametrize("op,x,attrs,want", [
    ("abs", [0.0, -1.0, 2.0], {}, [1.0, -1.0, 1.0]),
    ("leaky_relu", [0.0, -1.0, 2.0], {"alpha": 0.1}, [1.0, 0.1, 1.0]),
    ("relu6", [0.0, 6.0, 3.0, -1.0, 7.0], {}, [0.5, 0.5, 1.0, 0.0, 0.0]),
    ("clip", [-1.0, 2.0, 0.0], {"min": -1.0, "max": 2.0}, [0.5, 0.5, 1.0]),
    ("brelu", [1.0, 6.0], {"t_min": 1.0, "t_max": 6.0}, [0.5, 0.5]),
    ("hard_sigmoid", [-2.0, 2.0, 0.0], {"slope": 0.25, "offset": 0.5},
     [0.125, 0.125, 0.25]),
])
def test_gradient_at_the_edge_points_is_the_references(op, x, attrs, want):
    """d out / d x at the points where torch's own gradient differs
    from jax's (torch: abs 0 at 0, leaky_relu alpha at 0, clamp 1 at a
    bound): the port's equals the reference's, both equal ``want``."""
    xj = jnp.asarray(np.array(x, "float32"))
    rule = j_registry.get(op).lower
    gj = jax.grad(lambda v: jnp.sum(rule(None, {"X": [v]}, attrs)["Out"][0]))(xj)
    xt = torch.tensor(x, requires_grad=True)
    out = t_registry.get(op).lower(None, {"X": [xt]}, attrs)["Out"][0]
    (gt,) = torch.autograd.grad(out.sum(), [xt])
    np.testing.assert_allclose(np.asarray(gj), want, rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), want, rtol=1e-6)


def _rows_pair(rows, vals, height):
    return (JRows(jnp.asarray(rows), jnp.asarray(vals), height),
            TRows(torch.from_numpy(rows), torch.from_numpy(vals), height))


@pytest.mark.parametrize("op,attrs", [
    ("clip", {"min": -0.5, "max": 0.75}),
    ("clip_by_norm", {"max_norm": 1.0}),
    ("__global_norm_sq__", {}),
])
def test_selected_rows_branches_merge_first(op, attrs):
    """``clip``, ``clip_by_norm`` and ``__global_norm_sq__`` merge a
    SelectedRows' duplicate rows before their math, as the reference's
    (duplicates clip and square as the dense gradient's sum would)."""
    rows = np.array([3, 1, 3, 7, 1, 3], "int64")
    vals = _f(6, 4)
    j, t = _rows_pair(rows, vals, 10)
    want = j_registry.get(op).lower(None, {"X": [j]}, attrs)["Out"][0]
    got = t_registry.get(op).lower(None, {"X": [t]}, attrs)["Out"][0]
    if op == "__global_norm_sq__":
        _close(got.numpy(), np.asarray(want))
        return
    assert isinstance(got, TRows) and got.merged and want.merged
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    _close(got.values.numpy(), np.asarray(want.values))
