"""The convolutional models' op rules, ``conv2d``, ``depthwise_conv2d``,
``pool2d`` and ``batch_norm``, each against the reference's rule on the
same numpy inputs: forward, and the gradient of every differentiable
input (``jax.vjp`` of the reference rule against torch autograd of the
port's, with the same cotangents), in both layouts.  The reference runs
NHWC's 7x7/s2 stem through its space-to-depth rewrite; the port runs
the plain convolution, the same function.  The reference's
``depthwise_conv2d`` takes its groups from dim 1, the channels only in
NCHW, so the port's NHWC depthwise conv is held to the reference's
NCHW one on the transposed input.

Tolerances (max|d| <= tol * max|ref| per output):
- float32 convolutions and pools: the forward and the gradients within
  1e-5 (XLA and torch sum the same products in other orders);
- float32 batch norms: the inputs have mean 3 and spread 0.5, where the
  one-pass variance cancels E[x^2] ~ 9.25 against E[x]^2 ~ 9 and so
  magnifies the reduction-order noise 37-fold: Y and the gradients
  within 1e-4 of max|ref|, the running and saved stats within 1e-4
  relative per entry;
- max pooling is a selection: its forward is exact and its gradient,
  ties included (a relu's zeros, where both route the gradient to the
  window's first maximum), exact;
- batch_norm in bfloat16: ``y = x * inv_s + shift`` rounds twice in
  bfloat16 on both sides from the same float32 factors, so ``Y`` is
  within one bfloat16 ulp of |y| (2**-8 relative); the float32 stats as
  in float32.  The gradients are sums of bfloat16 products, which the
  reference's XLA reduces in bfloat16 and torch in float32; on these
  ill-conditioned inputs the two differ by up to a quarter of max|ref|,
  so each is held to the float64 answer (the same rule run in float64
  on the same bfloat16 inputs): the port's error no larger than the
  reference's own plus one bfloat16 ulp (2**-8) of max|exact|.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as j_registry
from paddle_tpu_torch.core import registry as t_registry
from paddle_tpu_torch.core.executor import tensor_from_numpy

F32_FWD = 1e-5
F32_GRAD = 1e-5
BN_F32 = 1e-4
BF16_ULP = 2.0 ** -8
BN_OUTS = ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")


class _Ctx:
    def __init__(self, training=True):
        self.training = training


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _ref(op, ins, attrs, outs, wrt, cots, training=True):
    """The reference rule's ``outs`` and the vjp of the ``wrt`` slots
    against ``cots`` (one per differentiated output)."""
    rule = j_registry.get(op).lower
    jins = {k: [jnp.asarray(v)] for k, v in ins.items()}

    def f(*xs):
        got = rule(_Ctx(training), {**jins, **{s: [x] for s, x in
                                               zip(wrt, xs)}}, attrs)
        return [got[s][0] for s in outs]

    vals, vjp = jax.vjp(f, *[jins[s][0] for s in wrt])
    full = [jnp.asarray(c) if c is not None else jnp.zeros_like(v)
            for c, v in zip(cots, vals)]
    grads = vjp(full)
    return [np.asarray(v) for v in vals], [np.asarray(g) for g in grads]


def _port(op, ins, attrs, outs, wrt, cots, training=True):
    rule = t_registry.get(op).lower
    tins = {k: [tensor_from_numpy(np.array(v))] for k, v in ins.items()}
    leaves = [tins[s][0].requires_grad_(True) for s in wrt]
    got = rule(_Ctx(training), tins, attrs)
    vals = [got[s][0] for s in outs]
    ys = [v for v, c in zip(vals, cots) if c is not None]
    gs = [tensor_from_numpy(c).to(v.dtype) for v, c in zip(vals, cots)
          if c is not None]
    grads = (torch.autograd.grad(ys, leaves, gs, allow_unused=True)
             if leaves else ())
    out = [np.asarray(_f32(v.detach().float().numpy())) for v in vals]
    return out, [g.float().numpy() for g in grads]


def _both(op, ins, attrs, outs, wrt, n_cot=1, seed=0, training=True):
    """(port, reference) outputs and gradients, with seeded cotangents
    for the first ``n_cot`` outputs."""
    want, _ = _ref(op, ins, attrs, outs, [], [None] * len(outs), training)
    rs = np.random.RandomState(seed)
    cots = [rs.randn(*w.shape).astype(np.float32).astype(w.dtype)
            if i < n_cot else None for i, w in enumerate(want)]
    want, gwant = _ref(op, ins, attrs, outs, wrt, cots, training)
    got, ggot = _port(op, ins, attrs, outs, wrt, cots, training)
    return (got, [_f32(w) for w in want]), (ggot, [_f32(g) for g in gwant])


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# conv2d / depthwise_conv2d
# ---------------------------------------------------------------------------

# (name, C_in, C_out, HW, k, stride, pad, dilation, groups)
CONV_CASES = [
    ("3x3", 8, 16, 12, 3, 1, 1, 1, 1),
    ("1x1_s2", 16, 32, 9, 1, 2, 0, 1, 1),
    ("5x5_nopad", 3, 6, 14, 5, 1, 0, 1, 1),
    ("dilated", 4, 6, 13, 3, 1, 2, 2, 1),
    ("grouped", 16, 16, 8, 3, 2, 1, 1, 4),
    ("stem_7x7_s2", 3, 16, 32, 7, 2, 3, 1, 1),
]


def _conv_inputs(cin, cout, hw, k, groups, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, cin, hw, hw).astype(np.float32)
    w = (rs.randn(cout, cin // groups, k, k) / np.sqrt(k * k * cin)
         ).astype(np.float32)
    return x, w


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv2d_matches_reference(case, layout):
    _, cin, cout, hw, k, s, p, d, g = case
    x, w = _conv_inputs(cin, cout, hw, k, g, seed=CONV_CASES.index(case))
    if layout == "NHWC":
        x = _nhwc(x)
    attrs = {"strides": [s, s], "paddings": [p, p], "dilations": [d, d],
             "groups": g, "data_layout": layout}
    (got, want), (ggot, gwant) = _both(
        "conv2d", {"Input": x, "Filter": w}, attrs, ["Output"],
        ["Input", "Filter"])
    assert got[0].shape == want[0].shape
    assert _rel(got[0], want[0]) <= F32_FWD
    for a, b in zip(ggot, gwant):
        assert a.shape == b.shape and _rel(a, b) <= F32_GRAD


def test_conv2d_nhwc_keeps_channels_last_strides():
    """The NHWC rule convolves a permuted view (channels-last strides,
    no copy) and hands back an NHWC tensor, contiguous."""
    x, w = _conv_inputs(8, 16, 10, 3, 1, seed=4)
    xt = torch.from_numpy(_nhwc(x))
    y = t_registry.get("conv2d").lower(
        None, {"Input": [xt], "Filter": [torch.from_numpy(w)]},
        {"strides": [1, 1], "paddings": [1, 1], "data_layout": "NHWC"}
    )["Output"][0]
    assert tuple(y.shape) == (2, 10, 10, 16) and y.is_contiguous()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_depthwise_conv2d_matches_reference(layout):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 9, 9).astype(np.float32)
    w = rs.randn(6, 1, 3, 3).astype(np.float32) / 3.0
    attrs = {"strides": [2, 2], "paddings": [1, 1]}
    (_, want), (_, gwant) = _both(
        "depthwise_conv2d", {"Input": x, "Filter": w},
        {**attrs, "data_layout": "NCHW"}, ["Output"], ["Input", "Filter"])
    xin = _nhwc(x) if layout == "NHWC" else x
    got, ggot = _port("depthwise_conv2d", {"Input": xin, "Filter": w},
                      {**attrs, "data_layout": layout}, ["Output"],
                      ["Input", "Filter"],
                      [np.random.RandomState(0).randn(*want[0].shape)
                       .astype(np.float32).transpose(
                           (0, 2, 3, 1) if layout == "NHWC"
                           else (0, 1, 2, 3)).copy()])
    y, gx = got[0], ggot[0]
    if layout == "NHWC":
        y, gx = y.transpose(0, 3, 1, 2), gx.transpose(0, 3, 1, 2)
    assert _rel(y, want[0]) <= F32_FWD
    assert _rel(gx, gwant[0]) <= F32_GRAD
    assert _rel(ggot[1], gwant[1]) <= F32_GRAD


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------

# (name, attrs)
POOL_CASES = [
    ("max_3x3_s2_p1", {"pooling_type": "max", "ksize": [3, 3],
                       "strides": [2, 2], "paddings": [1, 1]}),
    ("max_2x2_s2", {"pooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2], "paddings": [0, 0]}),
    ("avg_2x2_s2", {"pooling_type": "avg", "ksize": [2, 2],
                    "strides": [2, 2], "paddings": [0, 0]}),
    ("avg_3x3_p1_exclusive", {"pooling_type": "avg", "ksize": [3, 3],
                              "strides": [1, 1], "paddings": [1, 1],
                              "exclusive": True}),
    ("avg_3x3_p1_inclusive", {"pooling_type": "avg", "ksize": [3, 3],
                              "strides": [2, 2], "paddings": [1, 1],
                              "exclusive": False}),
    ("global_avg", {"pooling_type": "avg", "ksize": [7, 7],
                    "global_pooling": True}),
    ("global_max", {"pooling_type": "max", "ksize": [1, 1],
                    "global_pooling": True}),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pool2d_matches_reference(case, layout):
    name, attrs = case
    x = np.random.RandomState(6).randn(2, 5, 9, 9).astype(np.float32)
    if layout == "NHWC":
        x = _nhwc(x)
    (got, want), (ggot, gwant) = _both(
        "pool2d", {"X": x}, {**attrs, "data_layout": layout}, ["Out"], ["X"])
    assert got[0].shape == want[0].shape
    exact = attrs["pooling_type"] == "max"
    assert _rel(got[0], want[0]) <= (0.0 if exact else F32_FWD)
    assert _rel(ggot[0], gwant[0]) <= (0.0 if exact else F32_GRAD)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_max_pool_ties_route_like_the_reference(layout):
    """After a relu most 3x3 windows of a sparse map tie at 0: both
    route the gradient to the window's first maximum."""
    rs = np.random.RandomState(7)
    x = np.maximum(rs.randn(2, 4, 10, 10) - 1.0, 0.0).astype(np.float32)
    x[0, 0] = 0.0                                  # a map of ties only
    if layout == "NHWC":
        x = _nhwc(x)
    attrs = dict(POOL_CASES[0][1], data_layout=layout)
    (got, want), (ggot, gwant) = _both("pool2d", {"X": x}, attrs, ["Out"],
                                       ["X"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(ggot[0], gwant[0])


def test_pool2d_avg_bf16_accumulates_in_float32():
    x = (np.random.RandomState(8).randn(2, 3, 8, 8) * 4).astype(
        ml_dtypes.bfloat16)
    attrs = {"pooling_type": "avg", "ksize": [3, 3], "strides": [1, 1],
             "paddings": [1, 1], "exclusive": True, "data_layout": "NCHW"}
    (got, want), _ = _both("pool2d", {"X": x}, attrs, ["Out"], [])
    assert np.array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------

def _bn_inputs(shape, ch, dtype, seed):
    rs = np.random.RandomState(seed)
    # a large mean beside a small spread: one-pass statistics differ
    # from two-pass ones here
    x = (rs.randn(*shape) * 0.5 + 3.0).astype(np.float32).astype(dtype)
    c = shape[ch]
    return {"X": x,
            "Scale": (rs.rand(c) + 0.5).astype(np.float32),
            "Bias": rs.randn(c).astype(np.float32),
            "Mean": (rs.randn(c) * 0.1).astype(np.float32),
            "Variance": (rs.rand(c) + 0.5).astype(np.float32)}


# (name, shape, layout)
BN_SHAPES = [("nchw", (4, 6, 5, 5), "NCHW"), ("nhwc", (4, 5, 5, 6), "NHWC"),
             ("nchw_1x1", (4, 8, 1, 1), "NCHW"), ("2d", (8, 12), "NCHW")]


def _bn_exact_grads(ins, attrs, cot):
    """The gradients of X, Scale and Bias from the port's rule run in
    float64 on the same values (the function both sides round)."""
    t = {k: torch.from_numpy(np.asarray(v, np.float64))
         for k, v in ins.items()}
    leaves = [t[s].requires_grad_(True) for s in ("X", "Scale", "Bias")]
    y = t_registry.get("batch_norm").lower(
        _Ctx(True), {k: [v] for k, v in t.items()}, attrs)["Y"][0]
    grads = torch.autograd.grad(
        [y], leaves, [torch.from_numpy(np.asarray(cot, np.float64))])
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("shape", BN_SHAPES, ids=[s[0] for s in BN_SHAPES])
def test_batch_norm_matches_reference(shape, is_test, dtype):
    _, shp, layout = shape
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    ins = _bn_inputs(shp, 1 if layout == "NCHW" else len(shp) - 1, np_dt,
                     seed=len(shp) * 10 + shp[1])
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout}
    (got, want), (ggot, gwant) = _both(
        "batch_norm", ins, attrs, list(BN_OUTS), ["X", "Scale", "Bias"])
    y, ywant = got[0], want[0]
    if dtype == "float32":
        assert _rel(y, ywant) <= BN_F32
        for a, b in zip(ggot, gwant):
            assert _rel(a, b) <= BN_F32
    else:
        assert np.all(np.abs(y - ywant) <= BF16_ULP * np.abs(ywant))
        cot = np.random.RandomState(0).randn(*shp).astype(
            np.float32).astype(np_dt)
        for a, b, exact in zip(ggot, gwant, _bn_exact_grads(ins, attrs,
                                                            cot)):
            assert _rel(a, exact) <= _rel(b, exact) + BF16_ULP
    for a, b in zip(got[1:], want[1:]):        # float32 stats
        np.testing.assert_allclose(a, b, rtol=BN_F32, atol=0)


def test_batch_norm_running_variance_is_biased():
    """At B=4 on 1x1 maps the unbiased variance is 4/3 of the biased
    one; the running update takes the biased one, weighted 0.1."""
    ins = _bn_inputs((4, 3, 1, 1), 1, np.float32, seed=9)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NCHW"}
    got, _ = _port("batch_norm", ins, attrs, list(BN_OUTS), [], [])
    x = ins["X"][:, :, 0, 0].astype(np.float64)
    want = ins["Variance"] * 0.9 + x.var(axis=0) * 0.1
    np.testing.assert_allclose(got[2], want, rtol=1e-5)
    np.testing.assert_allclose(got[4], 1.0 / np.sqrt(x.var(axis=0) + 1e-5),
                               rtol=1e-4)


def test_batch_norm_inference_executor_uses_running_stats():
    """``is_test`` unset: an inference context takes the test branch."""
    ins = _bn_inputs((4, 6, 5, 5), 1, np.float32, seed=11)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": "NCHW"}
    got, _ = _port("batch_norm", ins, attrs, list(BN_OUTS), [], [],
                   training=False)
    want, _ = _ref("batch_norm", ins, attrs, list(BN_OUTS), [], [None] * 5,
                   training=False)
    assert _rel(got[0], _f32(want[0])) <= F32_FWD
    np.testing.assert_array_equal(got[1], ins["Mean"])
