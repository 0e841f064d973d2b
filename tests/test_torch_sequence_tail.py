"""The sequence op rules ported with the book models: the 18 op types of
``paddle_tpu/ops/sequence_ops.py`` that the earlier slices lacked and
the seven nested (``SeqLen2``) forms, each against the reference's rule
on the same numpy inputs.

Forward: every output slot, integer outputs (erase, enumerate,
sequence_mask, every length) exactly, float outputs within 1e-5
relative + 1e-6 absolute (float32 elementwise math and short
reductions in two frameworks).  Gradient, where the op has one: the
gradient of sum(out * cot) over the float outputs, with the same random
cotangents, with respect to every float input (jax.grad of the
reference rule against torch autograd of the port's), at the same
tolerance.  Inputs after the reference's own cases
(``tests/test_op_tail.py``, ``test_op_tail2.py``,
``test_lod_machinery.py``, ``test_sequence.py``): ragged lengths with a
0 and a full row, duplicate scatter ids, asymmetric im2sequence
padding, empty nested sentences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as j_registry
from paddle_tpu_torch.core import registry as t_registry

TOL = dict(rtol=1e-5, atol=1e-6)

_RS = np.random.RandomState(21)


def _f(*shape):
    return _RS.randn(*shape).astype("float32")


def _i(lo, hi, *shape):
    return _RS.randint(lo, hi, shape).astype("int64")


LENS4 = np.array([6, 3, 0, 1], "int64")        # a full row and an empty one
LENS2 = np.array([[3, 0, 1], [2, 4, 0]], "int64")   # nested [B=2, S=3]

# name: (op type, {slot: [arrays]}, attrs, [(slot, j) float inputs to
# differentiate])
CASES = {
    "softmax": ("sequence_softmax", {"X": [_f(4, 6)], "SeqLen": [LENS4]},
                {}, [("X", 0)]),
    "softmax_3d": ("sequence_softmax", {"X": [_f(4, 6, 2)],
                                        "SeqLen": [LENS4]}, {}, [("X", 0)]),
    "softmax_dense": ("sequence_softmax", {"X": [_f(3, 5)]}, {},
                      [("X", 0)]),
    "expand": ("sequence_expand", {"X": [_f(4, 3)], "Y": [_f(4, 6, 3)]},
               {}, [("X", 0)]),
    "expand_same_rank": ("sequence_expand", {"X": [_f(4, 1, 3)],
                                             "Y": [_f(4, 6, 3)]}, {},
                         [("X", 0)]),
    "reverse": ("sequence_reverse", {"X": [_f(4, 6, 3)], "SeqLen": [LENS4]},
                {}, [("X", 0)]),
    "reverse_dense": ("sequence_reverse", {"X": [_f(3, 5, 2)]}, {},
                      [("X", 0)]),
    "concat": ("sequence_concat", {"X": [_f(4, 3, 2), _f(4, 5, 2)]}, {},
               [("X", 0), ("X", 1)]),
    "first_step": ("sequence_first_step", {"X": [_f(4, 6, 3)]}, {},
                   [("X", 0)]),
    "conv": ("sequence_conv", {"X": [_f(4, 6, 3)], "Filter": [_f(9, 5)],
                               "SeqLen": [LENS4]},
             {"contextLength": 3, "contextStart": -1, "contextStride": 1},
             [("X", 0), ("Filter", 0)]),
    "conv_ahead": ("sequence_conv", {"X": [_f(4, 6, 3)],
                                     "Filter": [_f(12, 2)],
                                     "SeqLen": [LENS4]},
                   {"contextLength": 4, "contextStart": 0},
                   [("X", 0), ("Filter", 0)]),
    "slice": ("sequence_slice", {"X": [_f(4, 6, 3)],
                                 "Offset": [np.array([[1], [0], [4], [2]])],
                                 "Length": [np.array([[3], [6], [2], [0]])]},
              {}, [("X", 0)]),
    "erase": ("sequence_erase", {"X": [np.array(
        [[3, 0, 5, 0, 7, 9], [0, 0, 1, 2, 0, 4], [5, 5, 5, 5, 5, 5],
         [9, 0, 2, 0, 0, 1]], "int64")[..., None]],
        "SeqLen": [np.array([5, 6, 0, 4], "int64")]},
        {"tokens": [0, 5]}, []),
    "erase_2d": ("sequence_erase", {"X": [_i(0, 4, 3, 7)]}, {"tokens": [2]},
                 []),
    "enumerate": ("sequence_enumerate", {"X": [_i(0, 9, 4, 6)],
                                         "SeqLen": [LENS4]},
                  {"win_size": 3, "pad_value": -1}, []),
    "enumerate_dense": ("sequence_enumerate", {"X": [_i(0, 9, 2, 5, 1)]},
                        {"win_size": 2, "pad_value": 0}, []),
    "expand_as": ("sequence_expand_as", {"X": [_f(4, 3)], "Y": [_f(4, 6, 2)],
                                         "SeqLen": [LENS4]}, {},
                  [("X", 0)]),
    "pad": ("sequence_pad", {"X": [_f(4, 6, 3)], "PadValue": [
        np.array([-2.5], "float32")], "SeqLen": [LENS4]},
        {"padded_length": 8}, [("X", 0)]),
    "pad_truncate": ("sequence_pad", {"X": [_f(4, 6, 3)], "PadValue": [
        np.array([0.5], "float32")], "SeqLen": [LENS4]},
        {"padded_length": 4}, [("X", 0)]),
    "unpad": ("sequence_unpad", {"X": [_f(4, 6, 3)], "Length": [LENS4]}, {},
              [("X", 0)]),
    "reshape_merge": ("sequence_reshape", {"X": [_f(4, 6, 2)],
                                           "SeqLen": [LENS4]},
                      {"new_dim": 4}, [("X", 0)]),
    "reshape_split": ("sequence_reshape", {"X": [_f(4, 6, 4)],
                                           "SeqLen": [LENS4]},
                      {"new_dim": 2}, [("X", 0)]),
    "row_conv": ("row_conv", {"X": [_f(4, 6, 3)], "Filter": [_f(3, 3)],
                              "SeqLen": [LENS4]}, {},
                 [("X", 0), ("Filter", 0)]),
    "mask": ("sequence_mask", {"X": [LENS4]}, {"maxlen": 7,
                                               "out_dtype": "int64"}, []),
    "mask_float_2d": ("sequence_mask", {"X": [LENS2]},
                      {"maxlen": 5, "out_dtype": "float32"}, []),
    "im2sequence": ("im2sequence", {"X": [_f(2, 3, 7, 6)]},
                    {"kernels": [3, 2], "strides": [2, 1],
                     "paddings": [1, 0, 2, 1]}, [("X", 0)]),
    "scatter": ("sequence_scatter", {
        "X": [_f(4, 5, 3)],
        "Ids": [np.array([[0, 2, 2, 4], [1, 1, 1, 0], [3, 0, 4, 4],
                          [2, 3, 2, 1]], "int64")],
        "Updates": [_f(4, 4, 3)],
        "SeqLen": [np.array([4, 3, 0, 2], "int64")]}, {},
        [("X", 0), ("Updates", 0)]),
    "lod_reset_len": ("lod_reset", {"X": [_f(4, 6)], "TargetLenTensor": [
        np.array([2, 6, 1, 0], "int64")]}, {}, [("X", 0)]),
    "lod_reset_y": ("lod_reset", {"X": [_f(4, 6)], "Y": [
        np.array([5, 5, 3, 4], "int64")]}, {}, [("X", 0)]),
    "lod_reset_target_lod": ("lod_reset", {"X": [_f(3, 6)]},
                             {"target_lod": [0, 4, 5, 11]}, [("X", 0)]),
}

# the nested forms: [B=2, S=3, W=4, ...] with inner lengths [2, 3]
# (empty sentences included)
NESTED = {
    "pool_sum": ("sequence_pool", {"pooltype": "SUM"}),
    "pool_max": ("sequence_pool", {"pooltype": "MAX"}),
    "pool_average": ("sequence_pool", {"pooltype": "AVERAGE"}),
    "softmax": ("sequence_softmax", {}),
    "reverse": ("sequence_reverse", {}),
    "first_step": ("sequence_first_step", {}),
    "last_step": ("sequence_last_step", {}),
    "pad": ("sequence_pad", {"padded_length": 6}),
    "unpad": ("sequence_unpad", {}),
}
for _name, (_op, _attrs) in NESTED.items():
    _ins = {"X": [_f(2, 3, 4) if _op == "sequence_softmax"
                  else _f(2, 3, 4, 2)], "SeqLen2": [LENS2]}
    if _op == "sequence_pad":
        _ins["PadValue"] = [np.array([1.5], "float32")]
    if _op == "sequence_unpad":
        _ins = {"X": _ins["X"], "Length": [LENS2], "SeqLen2": [LENS2]}
    CASES["nested_" + _name] = (_op, _ins, _attrs, [("X", 0)])


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _cotangents(outs):
    rs = np.random.RandomState(5)
    return {k: rs.randn(*np.shape(v)).astype("float32")
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
        if _is_float(w):
            assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=slot, **TOL)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=slot)
    for (slot, j), g, w in zip(wrt, ggot or [], gwant or []):
        np.testing.assert_allclose(g, w, err_msg=f"{slot}[{j}] grad", **TOL)


def test_every_sequence_op_type_is_registered_and_nestable():
    """The port registers every op type of the reference's
    sequence_ops, and nests the same seven."""
    from paddle_tpu.ops import sequence_ops as j_seq
    from paddle_tpu_torch.ops import sequence_ops as t_seq
    types = {c[0] for c in CASES.values()} | {"sequence_pool",
                                              "sequence_last_step"}
    ref_types = {t for t in j_registry.all_ops()
                 if j_registry.get(t).lower.__module__ == j_seq.__name__}
    assert types == ref_types and len(types) == 20
    assert types <= set(t_registry.all_ops())
    assert t_seq._NESTED_INNER_OPS == j_seq._NESTED_INNER_OPS
    for t in t_seq._NESTED_INNER_OPS:
        assert "SeqLen2" in t_registry.get(t).no_grad_slots


def test_sequence_mask_needs_a_static_maxlen():
    x = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="static maxlen"):
        t_registry.get("sequence_mask").lower(None, {"X": [x]}, {})


def test_left_compact_is_stable_and_matches_reference():
    from paddle_tpu.ops.sequence_ops import left_compact as j_lc
    from paddle_tpu_torch.ops.sequence_ops import left_compact as t_lc
    ids = _i(0, 5, 6, 9)
    keep = ids % 2 == 0
    want = j_lc(jnp.asarray(ids), jnp.asarray(keep))
    got = t_lc(torch.from_numpy(ids), torch.from_numpy(keep))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nested_double_pool_program_matches_reference():
    """words -> reversed sentences -> sentence vectors (inner max pool,
    the nested rules) -> document vector (outer sum pool), after the
    reference's ``test_lod_machinery`` program: built by both packages
    from one nested LoDTensor and run by both executors."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu.core import unique_name as ju
    from paddle_tpu_torch.core import unique_name as tu

    words = _f(6, 2)
    outer, inner = [2, 1], [3, 1, 2]
    results = []
    for fluid, unique, exe in ((jf, ju, jf.Executor()),
                               (tf, tu, tf.Executor("cpu"))):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), unique.guard():
            d = fluid.layers.data("doc", [2], lod_level=2)
            rev = fluid.layers.sequence_reverse(d)
            sent = fluid.layers.sequence_pool(rev, "max")
            last = fluid.layers.sequence_last_step(d)
            doc = fluid.layers.sequence_pool(sent, "sum")
        lt = fluid.create_lod_tensor(words, [outer, inner], None)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            results.append([np.asarray(v) for v in exe.run(
                prog, feed={"doc": lt},
                fetch_list=[rev.name, sent.name, last.name, doc.name],
                sync=True)])
        results[-1].append(prog.serialize())
    (*want, jp), (*got, tp) = results
    assert tp == jp
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def _nets_img(fluid):
    img = fluid.layers.data("img", [3, 8, 8])
    a = fluid.nets.simple_img_conv_pool(img, 4, 3, 2, 2, act="relu")
    b = fluid.nets.img_conv_group(img, [4, 4], 2, conv_act="relu",
                                  conv_with_batchnorm=[True, False],
                                  pool_stride=2)
    return [a, b]


def _nets_attention(fluid):
    q = fluid.layers.data("q", [5, 8])
    k = fluid.layers.data("k", [7, 8])
    v = fluid.layers.data("v", [7, 6])
    return [fluid.nets.scaled_dot_product_attention(q, k, v, num_heads=2)]


def _extras_seq(fluid):
    L = fluid.layers
    x = L.data("x", [6, 3], lod_level=1)
    ids = L.data("ids", [4], dtype="int64", lod_level=1)
    upd = L.data("upd", [4, 3], lod_level=1)
    lens = L.data("lens", [], dtype="int64")
    img = L.data("img", [2, 5, 4])
    return [L.sequence_scatter(x, ids, upd),
            L.sequence_mask(lens, maxlen=6, dtype="float32"),
            L.lod_reset(x, target_lod=[0, 2, 8, 9]),
            L.im2sequence(img, filter_size=[2, 3], stride=[1, 2],
                          padding=[1, 0, 2, 1])]


def _extras_compare(fluid):
    L = fluid.layers
    a, b = L.data("a", [4]), L.data("b", [4])
    p, q = L.less_than(a, b), L.greater_than(a, b)
    return [L.equal(a, b), L.not_equal(a, b), L.less_equal(a, b), q,
            L.logical_and(p, q), L.logical_or(p, q), L.logical_xor(p, q),
            L.logical_not(p)]


def _layer_feeds(rs):
    a = rs.randint(0, 3, (3, 4)).astype("float32")
    return {"img": rs.randn(3, 3, 8, 8).astype("float32"),
            "q": rs.randn(3, 5, 8).astype("float32"),
            "k": rs.randn(3, 7, 8).astype("float32"),
            "v": rs.randn(3, 7, 6).astype("float32"),
            "x": rs.randn(3, 6, 3).astype("float32"),
            "x@LEN": np.array([6, 2, 4], "int64"),
            "ids": rs.randint(0, 6, (3, 4)).astype("int64"),
            "ids@LEN": np.array([4, 1, 3], "int64"),
            "upd": rs.randn(3, 4, 3).astype("float32"),
            "upd@LEN": np.array([4, 1, 3], "int64"),
            "lens": np.array([0, 6, 3], "int64"),
            "a": a, "b": rs.randint(0, 3, (3, 4)).astype("float32")}


@pytest.mark.parametrize("build", [_nets_img, _nets_attention, _extras_seq,
                                   _extras_compare],
                         ids=lambda f: f.__name__.strip("_"))
def test_layers_build_and_run_the_reference_programs(build):
    """The ported ``nets`` helpers and ``nn_extras`` layers build the
    reference's programs byte for byte and, from the reference's
    startup values, fetch what the reference fetches (a batch-norm
    training step included)."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu.core import unique_name as ju
    from paddle_tpu_torch.core import unique_name as tu
    res, init = [], None
    for fluid, unique, exe in ((jf, ju, jf.Executor()),
                               (tf, tu, tf.Executor("cpu"))):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), unique.guard():
            outs = build(fluid)
        names = {n for op in prog.global_block.ops for s in op.inputs.values()
                 for n in s}
        feed = {k: v for k, v in _layer_feeds(np.random.RandomState(3))
                .items() if k in names}
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if init is None:
                init = {v.name: np.array(scope.find_var(v.name))
                        for v in startup.global_block.vars.values()
                        if v.persistable}
            else:
                scope.load_numpy(init, device="cpu")
            got = exe.run(prog, feed=feed, fetch_list=[o.name for o in outs],
                          sync=True)
        res.append(([np.asarray(g) for g in got], prog.serialize(),
                    startup.serialize()))
    (want, jp, js), (got, tp, ts) = res
    assert (tp, ts) == (jp, js)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if _is_float(w):
            np.testing.assert_allclose(g, w, **TOL)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64))
