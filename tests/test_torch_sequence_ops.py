"""The stacked LSTM's op rules other than the lstm: ``sequence_pool``,
``softmax``, ``cross_entropy``, ``top_k`` and ``accuracy``, and machine
translation's: ``matmul``, ``slice``, ``sigmoid``, ``tanh``,
``fill_constant_batch_size_like`` and ``sequence_last_step``; each
against the reference's rule on the same numpy inputs, forward and
(where the op has one) gradient: jax.vjp of the reference rule against
torch autograd of the port's, with the same cotangent.

Tolerances: float32 elementwise math and short reductions in two
frameworks, 1e-6 relative + 1e-6 absolute; index outputs exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as j_registry
from paddle_tpu_torch.core import registry as t_registry

TOL = dict(rtol=1e-6, atol=1e-6)


def _ref(op, ins, attrs, slot, wrt=None, cot=None):
    """Reference rule's output ``slot`` and, given ``wrt``, the vjp of that
    input slot against ``cot``."""
    rule = j_registry.get(op).lower
    jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
    if wrt is None:
        return np.asarray(rule(None, jins, attrs)[slot][0]), None

    def f(x):
        return rule(None, {**jins, wrt: [x]}, attrs)[slot][0]

    out, vjp = jax.vjp(f, jins[wrt][0])
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _port(op, ins, attrs, slot, wrt=None, cot=None):
    rule = t_registry.get(op).lower
    tins = {k: [torch.from_numpy(np.array(v))] for k, v in ins.items()}
    if wrt is None:
        return rule(None, tins, attrs)[slot][0].numpy(), None
    leaf = tins[wrt][0].requires_grad_(True)
    out = rule(None, tins, attrs)[slot][0]
    (g,) = torch.autograd.grad(out, leaf, torch.from_numpy(np.array(cot)))
    return out.detach().numpy(), g.numpy()


def _both(op, ins, attrs, slot, wrt=None, seed=0):
    want, _ = _ref(op, ins, attrs, slot)
    cot = None
    if wrt is not None:
        cot = np.random.RandomState(seed).randn(*want.shape).astype("float32")
    want, gwant = _ref(op, ins, attrs, slot, wrt, cot)
    got, ggot = _port(op, ins, attrs, slot, wrt, cot)
    return (got, want), (ggot, gwant)


def _pool_input(with_len):
    """[5, 6, 3] values with ties: row 1 repeats its maximum at steps 0
    and 2, row 3 is constant; lengths include 0 and the full 6."""
    rs = np.random.RandomState(1)
    x = rs.randn(5, 6, 3).astype("float32")
    x[1, 2] = x[1, 0] = np.abs(x[1]).max() + 1.0
    x[3] = 0.25
    ins = {"X": x}
    if with_len:
        ins["SeqLen"] = np.array([6, 3, 0, 4, 1], "int32")
    return ins


@pytest.mark.parametrize("with_len", [True, False], ids=["ragged", "dense"])
@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST",
                                   "FIRST"])
def test_sequence_pool_matches_reference(ptype, with_len):
    (got, want), (ggot, gwant) = _both(
        "sequence_pool", _pool_input(with_len), {"pooltype": ptype}, "Out",
        wrt="X")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ggot, gwant, **TOL)
    if with_len:   # the length-0 row pools to 0 and takes no gradient
        assert not got[2].any() and not ggot[2].any()


def test_sequence_pool_max_splits_the_gradient_between_ties():
    (_, _), (ggot, gwant) = _both(
        "sequence_pool", _pool_input(True), {"pooltype": "MAX"}, "Out",
        wrt="X")
    np.testing.assert_allclose(ggot, gwant, **TOL)
    tied = ggot[3, :4, 0]          # a constant row: four live ties
    np.testing.assert_allclose(tied, tied[0])
    assert tied[0] != 0 and not ggot[3, 4:].any()


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_matches_reference(axis):
    x = np.random.RandomState(2).randn(4, 5, 7).astype("float32") * 3
    (got, want), (ggot, gwant) = _both("softmax", {"X": x}, {"axis": axis},
                                       "Out", wrt="X")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ggot, gwant, **TOL)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cross_entropy_matches_reference(soft):
    rs = np.random.RandomState(3)
    p = rs.rand(6, 5).astype("float32")
    p[0, 2] = 0.0                  # -log(0 + 1e-8) on a picked zero
    p /= p.sum(-1, keepdims=True)
    if soft:
        label = rs.rand(6, 5).astype("float32")
        label /= label.sum(-1, keepdims=True)
    else:
        label = rs.randint(0, 5, (6, 1)).astype("int64")
        label[0, 0] = 2
    (got, want), (ggot, gwant) = _both(
        "cross_entropy", {"X": p, "Label": label}, {"soft_label": soft}, "Y",
        wrt="X")
    assert got.shape == want.shape == (6, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(ggot, gwant, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_breaks_ties_by_the_lower_index(k):
    x = np.array([[0.5, 0.9, 0.9, 0.1, 0.9],
                  [0.2, 0.2, 0.2, 0.2, 0.2],
                  [0.3, 0.7, 0.1, 0.7, 0.6]], "float32")
    ins = {"X": x}
    for slot in ("Out", "Indices"):
        (got, want), _ = _both("top_k", ins, {"k": k}, slot)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    (idx, _), _ = _both("top_k", ins, {"k": k}, "Indices")
    np.testing.assert_array_equal(idx[:, 0], [1, 0, 1])


def test_accuracy_matches_reference():
    """Values as the reference's; dtypes as the program declares them
    (the reference's int32 sum widens under the tests' x64 mode)."""
    rs = np.random.RandomState(4)
    idx = rs.randint(0, 4, (9, 2)).astype("int64")
    label = rs.randint(0, 4, (9, 1)).astype("int64")
    ins = {"Out": idx.astype("float32"), "Indices": idx, "Label": label}
    for slot, dtype in (("Accuracy", np.float32), ("Correct", np.int32),
                        ("Total", np.int32)):
        (got, want), _ = _both("accuracy", ins, {}, slot)
        assert got.dtype == dtype, slot
        np.testing.assert_array_equal(got, want)


def _rand(*shape, seed=2):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


MT_OPS = {  # name: (op, ins, attrs, output slot, input slot differentiated)
    "matmul_broadcast_alpha": (
        "matmul", {"X": _rand(2, 3, 4), "Y": _rand(4, 5, seed=3)},
        {"alpha": 0.5}, "Out", "X"),
    "matmul_transposed": (
        "matmul", {"X": _rand(2, 4, 3), "Y": _rand(2, 5, 4, seed=3)},
        {"transpose_X": True, "transpose_Y": True}, "Out", "Y"),
    "matmul_2d_by_batched": (
        "matmul", {"X": _rand(3, 4), "Y": _rand(2, 4, 5, seed=3)}, {},
        "Out", "Y"),
    "slice_negative_and_clamped": (
        "slice", {"Input": _rand(3, 8, 5)},
        {"axes": [1, 2], "starts": [2, -3], "ends": [100, -1]}, "Out",
        "Input"),
    "sigmoid": ("sigmoid", {"X": _rand(4, 6) * 4}, {}, "Out", "X"),
    "tanh": ("tanh", {"X": _rand(4, 6) * 4}, {}, "Out", "X"),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", {"Input": _rand(3, 7)},
        {"shape": [-1, 5], "dtype": "float32", "value": 1.5}, "Out", None),
    "fill_constant_batch_size_like_dims": (
        "fill_constant_batch_size_like", {"Input": _rand(3, 7)},
        {"shape": [2, -1], "dtype": "float32", "value": -2.0,
         "input_dim_idx": 1, "output_dim_idx": 1}, "Out", None),
    "sequence_last_step_ragged": (
        "sequence_last_step", _pool_input(True), {}, "Out", "X"),
    "sequence_last_step_dense": (
        "sequence_last_step", _pool_input(False), {}, "Out", "X"),
}


@pytest.mark.parametrize("case", list(MT_OPS), ids=list(MT_OPS))
def test_machine_translation_op_matches_reference(case):
    """matmul transposes the last two axes, broadcasts a batch and
    scales by alpha; slice clamps and counts negative bounds from the
    end; sequence_last_step gives a length-0 row zeros."""
    op, ins, attrs, slot, wrt = MT_OPS[case]
    (got, want), (ggot, gwant) = _both(op, ins, attrs, slot, wrt)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **TOL)
    if wrt is not None:
        np.testing.assert_allclose(ggot, gwant, **TOL)
