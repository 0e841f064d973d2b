"""The port's int8 FC (K5's plain version, its quantizers and the int8
peephole plan) against the JAX reference, on the same numpy inputs.

- ``quantize_weight`` against the reference's: equal codes and scales,
  an all-zero column included.
- ``_quantize_act`` against the reference's: equal codes and scale,
  calibrated and dynamic, an all-zero batch (scale ``SCALE_EPS``).
- ``int8_fc_plain`` against the reference's ``int8_fc`` (its Pallas
  kernel in interpret mode) and its XLA twin ``int8_fc_xla``, for every
  act of the epilogue, calibrated and dynamic scales, and K not a
  multiple of 4.  The port's epilogue is ``acc * dq + b`` without
  contraction, as ``int8_fc_xla`` computes it, so for "" and relu it
  equals the XLA twin bit for bit (while the sum stays below 2^24); the
  interpret-mode kernel fuses the multiply-add into one rounding, so it
  is held at 1e-6 of max|ref| (one rounding of the product).  The
  transcendental acts are held at 1e-6 of max|ref| (XLA's and torch's
  sigmoid, tanh and tanh-approximated gelu differ by a few ulps).
- exact accumulation past 2^24: the port's plain version and the
  reference's kernel agree bit for bit with the exact int64 sum.
- ``plan_int8``: an op stamped by half keeps its float32 rule (the
  reference's ``test_plan_int8_skips_half_stamped_ops``), and a stamped
  op the epilogue cannot compute is routed to float32 and counted.
- the wrapper keeps each weight's K-major copy (the operand K5 reads):
  made once, equal to ``w_q.T``, made again only after ``w_q`` changes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.kernels import quant as JQ
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import quant as TQ

ACTS = ["", "relu", "sigmoid", "tanh", "gelu"]
REL = 1e-6     # one float32 rounding, or a few ulps of a transcendental


def _case(M, K, N, seed, zero_x=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype("float32")
    if zero_x:
        x[:] = 0.0
    w = (rng.randn(K, N) * np.linspace(0.1, 3.0, N)).astype("float32")
    b = rng.randn(N).astype("float32")
    return x, w, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quantize_weight_matches_reference():
    _, w, _ = _case(24, 24, 10, seed=1)
    w[:, 3] = 0.0
    qj, sj = JQ.quantize_weight(w)
    qt, st = TQ.quantize_weight(w)
    assert qt.dtype == np.int8 and st.dtype == np.float32
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    assert st[3] == TQ.SCALE_EPS and not qt[:, 3].any()
    assert TQ.clip_fraction(qt) == JQ.clip_fraction(qj)


@pytest.mark.parametrize("in_scale", [0.0, 2.5], ids=["dynamic", "calib"])
@pytest.mark.parametrize("zero", [False, True], ids=["randn", "zeros"])
def test_quantize_act_matches_reference(in_scale, zero):
    x, _, _ = _case(7, 37, 1, seed=2, zero_x=zero)
    x[0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]   # ties at a unit scale
    if zero:
        x[:] = 0.0
    qj, sj = JQ._quantize_act(jnp.asarray(x), in_scale)
    qt, st = TQ._quantize_act(_t(x), in_scale)
    assert qt.dtype == torch.int8 and tuple(st.shape) == (1,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.item() == np.float32(sj)
    if zero and not in_scale:
        assert st.item() == np.float32(TQ.SCALE_EPS)


SHAPES = {"6x16x12": (6, 16, 12), "odd_k37": (5, 37, 11),
          "m1": (1, 64, 8), "zeros": (4, 16, 5)}


@pytest.mark.parametrize("in_scale", [0.0, 2.5], ids=["dynamic", "calib"])
@pytest.mark.parametrize("act", ACTS, ids=lambda a: a or "none")
@pytest.mark.parametrize("shape", list(SHAPES))
def test_int8_fc_plain_matches_reference(shape, act, in_scale):
    M, K, N = SHAPES[shape]
    x, w, b = _case(M, K, N, seed=3, zero_x=shape == "zeros")
    qw, sw = JQ.quantize_weight(w)
    j_args = (jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sw), in_scale,
              jnp.asarray(b), act)
    kernel = np.asarray(JQ.int8_fc(*j_args))
    xla = np.asarray(JQ.int8_fc_xla(*j_args))
    got = TQ.int8_fc_plain(_t(x), _t(qw), _t(sw), in_scale, _t(b), act)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    got = got.numpy()
    scale = max(float(np.abs(kernel).max()), 1e-30)
    assert np.abs(got - kernel).max() <= REL * scale
    if act in ("", "relu"):
        np.testing.assert_array_equal(got, xla)
    else:
        assert np.abs(got - xla).max() <= REL * scale


def test_int8_fc_accumulates_exactly_past_2_24():
    """Integer codes with the scales set so dq == 1: the output is the
    int32 sum itself.  127^2-sized products over K=2048 pass 2^24, where
    a float32 sum would round; the port (float64 products) and the
    reference's kernel (int32) are both exact."""
    rng = np.random.RandomState(4)
    M, K, N = 4, 2048, 8
    x = rng.randint(90, 128, (M, K)).astype("float32")
    w = rng.randint(90, 128, (K, N)).astype("float32")
    w[0, :] = 127.0                       # column abs-max 127: q == w
    qw, sw = JQ.quantize_weight(w)
    np.testing.assert_array_equal(qw, w.astype(np.int8))
    exact = (x.astype(np.int64) @ w.astype(np.int64))
    assert exact.min() > 2 ** 24
    want = exact.astype(np.float32)
    kernel = np.asarray(JQ.int8_fc(jnp.asarray(x), jnp.asarray(qw),
                                   jnp.asarray(sw), 127.0))
    got = TQ.int8_fc_plain(_t(x), _t(qw), _t(sw), 127.0).numpy()
    np.testing.assert_array_equal(kernel, want)
    np.testing.assert_array_equal(got, want)


def test_int8_fc_refuses_an_act_outside_the_epilogue():
    x, w, _ = _case(2, 8, 3, seed=5)
    qw, sw = TQ.quantize_weight(w)
    with pytest.raises(ValueError, match="epilogue"):
        TQ.int8_fc(_t(x), _t(qw), _t(sw), act="leaky_relu")


def _fc_block():
    prog, startup = TProgram(), TProgram()
    with t_guard(prog, startup), t_unique.guard():
        x = tfluid.layers.data("x", [8])
        tfluid.layers.fc(x, 4)
    return prog.global_block


def _fallbacks():
    return TQ.quantz()["counters"].get("lower_fallbacks", 0)


def test_plan_int8_skips_half_stamped_ops():
    """An op with the attr but a sidecar missing (or the other way
    round) keeps its float32 rule: the stamp is all or nothing."""
    block = _fc_block()
    mul = next(op for op in block.ops if op.type == "mul")
    before = _fallbacks()
    mul.attrs["quant_int8"] = True          # the attr without sidecars
    assert TQ.plan_int8(block) is None
    mul.inputs["WInt8"] = ["w@INT8"]        # still missing WScale
    assert TQ.plan_int8(block) is None
    assert _fallbacks() == before + 2
    mul.inputs["WScale"] = ["w@INT8_SCALE"]
    plan = TQ.plan_int8(block)
    assert plan is not None and plan.covers(block.ops.index(mul))
    assert _fallbacks() == before + 2


@pytest.mark.parametrize("change", [
    {"type": "fused_fc", "act": "leaky_relu"},
    {"type": "fused_fc", "act": "relu", "act_attrs": {"alpha": 0.1}},
    {"type": "mul", "y_num_col_dims": 2},
], ids=["act", "act_attrs", "y_num_col_dims"])
def test_plan_int8_routes_what_the_epilogue_cannot_compute(change):
    """A fully stamped op the epilogue cannot compute takes its float32
    rule, decided before any launch and counted as lower_fallbacks; an
    act_attrs holding only op_role still qualifies."""
    block = _fc_block()
    op = next(op for op in block.ops if op.type == "mul")
    op.inputs.update(WInt8=["w@INT8"], WScale=["w@INT8_SCALE"])
    op.attrs["quant_int8"] = True
    change = dict(change)
    op.type = change.pop("type")
    if op.type == "fused_fc":
        op.inputs["Bias"] = ["b"]
    op.attrs.update(change)
    before = _fallbacks()
    assert TQ.plan_int8(block) is None
    assert _fallbacks() == before + 1
    if op.type == "fused_fc":
        op.attrs.update(act="relu", act_attrs={"op_role": 0})
        assert TQ.plan_int8(block) is not None


def test_kmajor_copy_is_made_once_a_weight():
    """The K-major copy K5 reads (``_kmajor``) is made once a weight and
    counted as ``quant.kmajor_copies``: equal to ``w_q.T``, contiguous,
    the same tensor at the next dispatch, made anew only after ``w_q``
    is written in place.  On the CPU the plan's lowering takes the plain
    version and makes no copy."""
    block = _fc_block()
    mul = next(op for op in block.ops if op.type == "mul")
    mul.attrs["quant_int8"] = True
    mul.inputs.update(WInt8=["w@INT8"], WScale=["w@INT8_SCALE"])
    _, w, _ = _case(8, 8, 4, seed=7)
    qw, sw = TQ.quantize_weight(w)
    env = {mul.inputs["X"][0]: _t(_case(3, 8, 4, seed=8)[0]),
           "w@INT8": _t(qw), "w@INT8_SCALE": _t(sw)}
    pos = block.ops.index(mul)

    def made():
        return TQ.quantz()["counters"].get("kmajor_copies", 0)

    n = made()
    for _ in range(2):   # two dispatches: two plans of the same block
        assert TQ.plan_int8(block).lower(pos, env)
    assert made() == n
    out = env[mul.outputs["Out"][0]]
    assert torch.equal(out, TQ.int8_fc_plain(
        env[mul.inputs["X"][0]], env["w@INT8"], env["w@INT8_SCALE"]))
    copies = [TQ._kmajor(env["w@INT8"]) for _ in range(2)]
    assert copies[0] is copies[1] and made() == n + 1
    assert copies[0].is_contiguous()
    assert torch.equal(copies[0], env["w@INT8"].t())
    env["w@INT8"][0, 0] = -env["w@INT8"][0, 0] - 1
    again = TQ._kmajor(env["w@INT8"])
    assert again is not copies[0] and made() == n + 2
    assert torch.equal(again, env["w@INT8"].t())
