"""The tensor op rules of the training-rewrites slice against the
reference's: the 18 op types of ``paddle_tpu/ops/tensor_ops.py`` that
the earlier slices lacked, each on the same numpy inputs.

Forward: every output (``split`` has several); integer and boolean
outputs exactly, float outputs within 1e-6 relative, of the element or
of the array's largest magnitude.  Gradient, where the op has one: the
gradient of sum(out * cot) over the float outputs, with the same random
cotangents (a missing one for a ``split`` output counts as zero), with
respect to every float input: jax.grad of the reference rule against
torch autograd of the port's, at the same tolerance.

``truncated_gaussian_random`` draws from torch generators, which give
other bits than the reference's threefry keys, so its draw is held to
the reference's law instead: shape, dtype, the +-2 sigma truncation and
the moments of a normal truncated there (as the port's
``uniform_random`` tests hold its draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as j_registry
from paddle_tpu.core.selected_rows import SelectedRows as JRows
from paddle_tpu_torch.core import registry as t_registry
from paddle_tpu_torch.core.registry import LowerContext
from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows

REL = 1e-6

_RS = np.random.RandomState(26)


def _f(*shape):
    return _RS.randn(*shape).astype("float32")


def _i(lo, hi, *shape):
    return _RS.randint(lo, hi, shape).astype("int64")


def _close(got, want, err_msg=""):
    """Within REL of the element or of max|want| (module doc)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale,
                               err_msg=err_msg)


_ARGMIN = _f(4, 6)
_ARGMIN[:, 4] = _ARGMIN.min(1)            # ties: the first index wins
_ARGMIN[1, 0] = _ARGMIN[1, 4]

# name: (op type, {slot: [arrays]}, attrs, [(slot, j) float inputs to
# differentiate])
CASES = {
    "split_sections": ("split", {"X": [_f(3, 7, 2)]},
                       {"axis": 1, "sections": [2, 4, 1]}, [("X", 0)]),
    "split_num": ("split", {"X": [_f(6, 4)]}, {"axis": 0, "num": 3},
                  [("X", 0)]),
    "split_byref": ("split_byref", {"X": [_f(4, 6)]}, {"axis": 1, "num": 2},
                    [("X", 0)]),
    "stack": ("stack", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {"axis": 1},
              [("X", 0), ("X", 2)]),
    "stack_last": ("stack", {"X": [_f(2, 3), _f(2, 3)]}, {"axis": -1},
                   [("X", 1)]),
    "reshape2": ("reshape2", {"X": [_f(2, 3, 4)]}, {"shape": [0, -1, 2]},
                 [("X", 0)]),
    "transpose2": ("transpose2", {"X": [_f(2, 3, 4)]}, {"axis": [2, 0, 1]},
                   [("X", 0)]),
    "one_hot": ("one_hot", {"X": [np.array([[0], [3], [5], [-1], [2]],
                                           "int64")]}, {"depth": 5}, []),
    "one_hot_int32_out": ("one_hot", {"X": [_i(0, 4, 3, 2)]},
                          {"depth": 4, "dtype": "int32"}, []),
    "shape": ("shape", {"Input": [_f(2, 3, 5)]}, {}, []),
    "range": ("range", {}, {"start": 2, "end": 17, "step": 3,
                            "dtype": "int64"}, []),
    "range_float": ("range", {}, {"start": -1.0, "end": 2.0, "step": 0.25,
                                  "dtype": "float32"}, []),
    "where": ("where", {"Condition": [_f(3, 4) > 0], "X": [_f(3, 4)],
                        "Y": [_f(3, 4)]}, {}, [("X", 0), ("Y", 0)]),
    "fill": ("fill", {}, {"value": [1.5, -2.0, 3.25, 0.0, 7.0, 1e-3],
                          "shape": [2, 3], "dtype": "float32"}, []),
    "fill_int": ("fill", {}, {"value": [1, 2, 3, 4], "shape": [4, 1],
                              "dtype": "int64"}, []),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_f(3, 2)]}, {},
                        [("X", 0)]),
    "pad": ("pad", {"X": [_f(2, 3, 4)]},
            {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": -1.5}, [("X", 0)]),
    "scatter_overwrite": ("scatter", {
        "X": [_f(6, 3)], "Ids": [np.array([4, 0, 2], "int64")],
        "Updates": [_f(3, 3)]}, {"overwrite": True},
        [("X", 0), ("Updates", 0)]),
    "scatter_add": ("scatter", {
        "X": [_f(6, 3)], "Ids": [np.array([4, 0, 4, 1, 0], "int64")],
        "Updates": [_f(5, 3)]}, {"overwrite": False},
        [("X", 0), ("Updates", 0)]),
    "arg_min": ("arg_min", {"X": [_ARGMIN]}, {"axis": 1}, []),
    "arg_min_axis0": ("arg_min", {"X": [_ARGMIN]}, {"axis": 0}, []),
}


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _flat(outs):
    return {f"{k}[{j}]": v for k, vs in outs.items() for j, v in enumerate(vs)}


def _cotangents(outs):
    rs = np.random.RandomState(5)
    # the last split output gets no cotangent: a zero one, as the
    # executor's missing cotangent
    keys = [k for k, v in sorted(outs.items()) if _is_float(v)]
    if len(keys) > 1:
        keys = keys[:-1]
    return {k: np.asarray(rs.randn(*np.shape(outs[k])), "float32")
            for k in keys}


def _reference(op, ins, attrs, wrt):
    rule = j_registry.get(op).lower
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}

    def call(*xs):
        cur = {k: list(v) for k, v in jins.items()}
        for (slot, j), x in zip(wrt, xs):
            cur[slot][j] = x
        return _flat(rule(None, cur, attrs))

    xs = [jins[s][j] for s, j in wrt]
    run = jax.jit(call) if op not in ("fill", "range") else call
    outs = {k: np.asarray(v) for k, v in run(*xs).items()}
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
    outs = _flat(rule(LowerContext(), tins, attrs))
    got = {k: v.detach().numpy() for k, v in outs.items()}
    if not wrt:
        return got, None
    loss = sum((outs[k].float() * torch.from_numpy(c)).sum()
               for k, c in cots.items())
    if not loss.requires_grad:
        return got, [np.zeros(tuple(leaf.shape), "float32")
                     for leaf in leaves]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return got, [np.zeros(tuple(leaf.shape), "float32") if g is None
                 else g.numpy() for g, leaf in zip(grads, leaves)]


@pytest.mark.parametrize("case", list(CASES))
def test_rule_matches_reference(case):
    op, ins, attrs, wrt = CASES[case]
    want, cots, gwant = _reference(op, ins, attrs, wrt)
    got, ggot = _port(op, ins, attrs, wrt, cots)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for slot, w in want.items():
        g = got[slot]
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        assert g.dtype == w.dtype or not _is_float(w), (slot, g.dtype,
                                                        w.dtype)
        if _is_float(w):
            _close(g, w, err_msg=slot)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=slot)
    for (slot, j), g, w in zip(wrt, ggot or [], gwant or []):
        _close(g, w, err_msg=f"{slot}[{j}] grad")


def test_every_tensor_op_type_is_registered():
    """The port registers every op type of the reference's tensor_ops."""
    from paddle_tpu.ops import tensor_ops as j_tensor
    types = {t for t in j_registry.all_ops()
             if j_registry.get(t).lower.__module__ == j_tensor.__name__}
    assert types <= set(t_registry.all_ops())
    added = {"split", "stack", "reshape2", "transpose2", "one_hot", "shape",
             "range", "where", "fill", "fill_zeros_like", "pad", "scatter",
             "arg_min", "extract_rows", "split_byref", "print",
             "sparse_decay", "truncated_gaussian_random"}
    assert added <= types
    assert added - {"extract_rows", "print", "sparse_decay",
                    "truncated_gaussian_random"} <= {
        c[0] for c in CASES.values()}


def test_range_with_tensor_bounds_raises_as_the_reference():
    ins = {"Start": [torch.tensor(0)], "End": [torch.tensor(3)],
           "Step": [torch.tensor(1)]}
    with pytest.raises(NotImplementedError, match="dynamic range"):
        t_registry.get("range").lower(LowerContext(), ins, {})


def _rows_pair(rows, vals, height):
    return (JRows(jnp.asarray(rows), jnp.asarray(vals), height),
            TRows(torch.from_numpy(rows), torch.from_numpy(vals), height))


@pytest.mark.parametrize("mode", ["l2", "l1"])
def test_sparse_decay_matches_reference(mode):
    """sparse_decay: duplicates merged, the touched rows of the param
    gathered and scaled (L2) or signed and scaled (L1); sentinel slots
    carry zeros.  Rows, values and the merged flag equal the
    reference's."""
    p = _f(9, 4)
    p[3, 1] = 0.0                         # sign(0) = 0 under L1
    rows = np.array([3, 1, 3, 7, 1, 3, 0], "int64")
    jg, tg = _rows_pair(rows, _f(7, 4), 9)
    attrs = {"coeff": 0.05, "mode": mode}
    want = j_registry.get("sparse_decay").lower(
        None, {"Param": [jnp.asarray(p)], "Grad": [jg]}, attrs)["Out"][0]
    ctx = LowerContext()
    got = t_registry.get("sparse_decay").lower(
        ctx, {"Param": [torch.from_numpy(p)], "Grad": [tg]}, attrs)["Out"][0]
    assert isinstance(got, TRows) and got.merged and want.merged
    assert got.height == want.height == 9
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    _close(got.values.numpy(), np.asarray(want.values))
    # a second table decayed behind the same id batch shares the merge
    again = t_registry.get("sparse_decay").lower(
        ctx, {"Param": [torch.from_numpy(p)], "Grad": [
            TRows(tg.rows, torch.from_numpy(_f(7, 4)), 9)]}, attrs)["Out"][0]
    assert again.rows is got.rows


def test_extract_rows_matches_reference():
    rows = np.array([5, 2, 5, 0], "int64")
    jx, tx = _rows_pair(rows, _f(4, 3), 8)
    want = j_registry.get("extract_rows").lower(None, {"X": [jx]}, {})
    got = t_registry.get("extract_rows").lower(None, {"X": [tx]}, {})
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  np.asarray(want["Out"][0]))
    with pytest.raises(TypeError, match="SelectedRows"):
        t_registry.get("extract_rows").lower(None, {"X": [torch.ones(2)]},
                                             {})


def test_print_prints_on_the_host_and_passes_through(capsys):
    """print_op: the message and the values go to stdout each run; Out
    equals In, as the reference's; its gradient passes through."""
    x = _f(2, 3)
    want = j_registry.get("print").lower(None, {"In": [jnp.asarray(x)]},
                                         {"message": "ref"})
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    got = t_registry.get("print").lower(None, {"In": [xt]},
                                        {"message": "step loss"})["Out"][0]
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(want["Out"][0]))
    (g,) = torch.autograd.grad(got.sum(), [xt])
    np.testing.assert_array_equal(g.numpy(), np.ones_like(x))
    printed = capsys.readouterr().out
    assert "step loss [[" in printed
    assert f"{x[0, 0]:.4f}"[:5] in printed


def test_truncated_gaussian_random_follows_the_references_law():
    """Shape, dtype, every value within (mean - 2 std, mean + 2 std), and
    the mean and standard deviation of the reference's draw and of a
    normal truncated at +-2 sigma (0.8796 sigma), within sampling error
    of 2e5 draws; the reference's own draw passes the same checks."""
    attrs = {"shape": [400, 500], "mean": 0.5, "std": 2.0,
             "dtype": "float32", "seed": 7}
    got = t_registry.get("truncated_gaussian_random").lower(
        LowerContext(), {}, attrs)["Out"][0].numpy()
    want = np.asarray(j_registry.get("truncated_gaussian_random").lower(
        None, {}, attrs)["Out"][0])
    sigma = 0.8796256610342398 * 2.0
    for a in (got, want):
        assert a.shape == (400, 500) and a.dtype == np.float32
        assert a.min() > 0.5 - 4.0 and a.max() < 0.5 + 4.0
        assert a.min() < 0.5 - 3.9 and a.max() > 0.5 + 3.9
        assert abs(a.mean() - 0.5) < 5 * sigma / np.sqrt(a.size)
        assert abs(a.std() - sigma) < 0.01 * sigma
    # a second draw from the same seed repeats; another seed does not
    again = t_registry.get("truncated_gaussian_random").lower(
        LowerContext(), {}, attrs)["Out"][0].numpy()
    np.testing.assert_array_equal(again, got)
    other = t_registry.get("truncated_gaussian_random").lower(
        LowerContext(), {}, dict(attrs, seed=8))["Out"][0].numpy()
    assert not np.array_equal(other, got)
