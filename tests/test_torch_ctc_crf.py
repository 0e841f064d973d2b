"""The structured sequence losses and ``cos_sim``: ``warpctc``,
``ctc_align``, ``linear_chain_crf``, ``crf_decoding`` and ``cos_sim``
against the reference's rules on the same numpy inputs, and the port
against the brute-force sums of the reference's own cases
(``tests/test_op_tail.py:53-190``, ``test_op_tail2.py:83``).

Float outputs and the gradients of sum(out * cot) within 1e-5
relative (+1e-6 absolute): float32 dynamic programs over T steps in
log space in two frameworks.  Integer outputs (``ctc_align``'s ids and
lengths, the Viterbi path) exactly.  The inputs hold ragged lengths
with a length-1 and a full row, a label length 0, repeated labels (the
skip rule), and ties for ``crf_decoding``'s first-index rule.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as j_registry
from paddle_tpu_torch.core import registry as t_registry

TOL = dict(rtol=1e-5, atol=1e-6)


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _reference(op, ins, attrs, wrt):
    rule = j_registry.get(op).lower
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}

    def call(*xs):
        cur = {k: list(v) for k, v in jins.items()}
        for (slot, j), x in zip(wrt, xs):
            cur[slot][j] = x
        return {k: v[0] for k, v in rule(None, cur, attrs).items()}

    xs = [jins[s][j] for s, j in wrt]
    outs = {k: np.asarray(v) for k, v in jax.jit(call)(*xs).items()}
    if not wrt:
        return outs, None, None
    rs = np.random.RandomState(5)
    cots = {k: rs.randn(*v.shape).astype("float32")
            for k, v in sorted(outs.items()) if _is_float(v)}

    def loss(*xs):
        o = call(*xs)
        return sum(jnp.sum(o[k].astype(jnp.float32) * c)
                   for k, c in cots.items())

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(wrt)))))(*xs)
    return outs, cots, [np.asarray(g) for g in grads]


def _port(op, ins, attrs, wrt=(), cots=None):
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
    return got, [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _compare(op, ins, attrs, wrt):
    want, cots, gwant = _reference(op, ins, attrs, wrt)
    got, ggot = _port(op, ins, attrs, wrt, cots)
    assert sorted(got) == sorted(want)
    for slot, w in want.items():
        assert got[slot].shape == w.shape, slot
        if _is_float(w):
            np.testing.assert_allclose(got[slot], w, err_msg=slot, **TOL)
        else:
            np.testing.assert_array_equal(got[slot].astype(np.int64),
                                          w.astype(np.int64), err_msg=slot)
    for (slot, j), g, w in zip(wrt, ggot or [], gwant or []):
        assert np.isfinite(g).all(), slot
        np.testing.assert_allclose(g, w, err_msg=f"{slot} grad", **TOL)
    return got


_RS = np.random.RandomState(8)

CTC = {
    "ragged": ({"Logits": [_RS.randn(4, 9, 6).astype("float32")],
                "Label": [np.array([[1, 2, 2, 3], [4, 0, 0, 0],
                                    [5, 5, 1, 2], [1, 0, 0, 0]], "int64")],
                "LogitsLength": [np.array([9, 3, 7, 1], "int64")],
                "LabelLength": [np.array([4, 1, 3, 0], "int64")]},
               {"blank": 0}),
    "norm_by_times_blank_last": (
        {"Logits": [_RS.randn(3, 6, 5).astype("float32")],
         "Label": [np.array([[0, 1], [2, 2], [3, 0]], "int64")[..., None]],
         "LogitsLength": [np.array([6, 5, 4], "int64")],
         "LabelLength": [np.array([2, 2, 1], "int64")]},
        {"blank": 4, "norm_by_times": True}),
    "full_lengths": ({"Logits": [_RS.randn(2, 5, 4).astype("float32")],
                      "Label": [np.array([[1, 3], [2, 1]], "int64")]},
                     {"blank": 0}),
}


@pytest.mark.parametrize("case", list(CTC))
def test_warpctc_matches_reference(case):
    ins, attrs = CTC[case]
    _compare("warpctc", ins, attrs, [("Logits", 0)])


def _ctc_brute(logp, labels, blank):
    """-log of the summed probability of every alignment that collapses
    to ``labels`` (tiny T and C only)."""
    T, C = logp.shape

    def collapse(path):
        out, prev = [], blank
        for p in path:
            if p != blank and p != prev:
                out.append(p)
            prev = p
        return tuple(out)

    total = sum(np.exp(sum(logp[t, p] for t, p in enumerate(path)))
                for path in itertools.product(range(C), repeat=T)
                if collapse(path) == tuple(labels))
    return -np.log(total)


def test_warpctc_matches_brute_force():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 4, 3).astype("float32")
    ins = {"Logits": [logits], "Label": [np.array([[1, 2], [2, 2]], "int64")],
           "LogitsLength": [np.array([4, 3], "int64")],
           "LabelLength": [np.array([2, 1], "int64")]}
    got, _ = _port("warpctc", ins, {"blank": 0})
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    want = [_ctc_brute(logp[0, :4], [1, 2], 0),
            _ctc_brute(logp[1, :3], [2], 0)]
    np.testing.assert_allclose(got["Loss"].reshape(-1), want, rtol=1e-5)


@pytest.mark.parametrize("squeeze", [False, True], ids=["2d", "3d"])
def test_ctc_align_matches_reference(squeeze):
    ids = np.array([[1, 1, 0, 2, 2, 3, 0, 3], [0, 0, 0, 0, 0, 0, 0, 0],
                    [4, 4, 4, 1, 0, 1, 1, 2], [2, 0, 2, 0, 2, 2, 5, 5]],
                   "int64")
    ins = {"Input": [ids[..., None] if squeeze else ids],
           "InputLength": [np.array([8, 5, 7, 4], "int64")]}
    got = _compare("ctc_align", ins, {"blank": 0, "merge_repeated": True},
                   [])
    np.testing.assert_array_equal(got["OutputLength"], [4, 0, 3, 2])


def test_ctc_greedy_decoder_program_matches_reference():
    """``layers.ctc_greedy_decoder`` (``arg_max`` then ``ctc_align``) in
    a program built by both packages: the reference's case, argmax path
    1 1 0 2 2 3 -> 1 2 3, and a random batch."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu.core import unique_name as ju
    from paddle_tpu_torch.core import unique_name as tu
    probs = np.random.RandomState(2).rand(3, 6, 4).astype("float32")
    probs[0] = 0
    for t, c in enumerate([1, 1, 0, 2, 2, 3]):
        probs[0, t, c] = 5.0
    res = []
    for fluid, unique, exe in ((jf, ju, jf.Executor()),
                               (tf, tu, tf.Executor("cpu"))):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), unique.guard():
            x = fluid.layers.data("x", [6, 4])
            out, lens = fluid.layers.ctc_greedy_decoder(x, blank=0)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            res.append([np.asarray(v) for v in exe.run(
                prog, feed={"x": probs}, fetch_list=[out.name, lens.name],
                sync=True)] + [prog.serialize()])
    (w_ids, w_len, w_prog), (g_ids, g_len, g_prog) = res
    assert g_prog == w_prog
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_array_equal(g_len, w_len)
    assert int(g_len[0]) == 3
    np.testing.assert_array_equal(g_ids[0, :3], [1, 2, 3])


def _crf_inputs(seed, B=4, T=7, C=5, lens=(7, 3, 1, 5)):
    rs = np.random.RandomState(seed)
    return {"Emission": [rs.randn(B, T, C).astype("float32")],
            "Transition": [(rs.randn(C + 2, C) * 0.5).astype("float32")],
            "Label": [rs.randint(0, C, (B, T, 1)).astype("int64")],
            "Length": [np.array(lens, "int64")]}


def test_linear_chain_crf_matches_reference():
    _compare("linear_chain_crf", _crf_inputs(3), {},
             [("Emission", 0), ("Transition", 0)])


def test_linear_chain_crf_full_lengths_matches_reference():
    ins = _crf_inputs(4)
    del ins["Length"]
    ins["Label"] = [ins["Label"][0][..., 0]]
    _compare("linear_chain_crf", ins, {},
             [("Emission", 0), ("Transition", 0)])


def test_crf_decoding_matches_reference():
    ins = _crf_inputs(5)
    del ins["Label"]
    _compare("crf_decoding", ins, {}, [])


def test_crf_decoding_ties_take_the_first_index():
    """Integer-valued scores make exact ties everywhere: the reference's
    ``jnp.argmax`` and the port's ``torch.argmax`` both take the first
    maximum, so the paths agree exactly."""
    rs = np.random.RandomState(6)
    ins = {"Emission": [rs.randint(0, 2, (3, 6, 4)).astype("float32")],
           "Transition": [rs.randint(0, 2, (6, 4)).astype("float32")],
           "Length": [np.array([6, 4, 2], "int64")]}
    _compare("crf_decoding", ins, {}, [])


def _crf_brute(emission, trans_full, labels):
    start, stop, trans = trans_full[0], trans_full[1], trans_full[2:]
    T, C = emission.shape

    def score(path):
        s = start[path[0]] + emission[0, path[0]]
        for t in range(1, T):
            s += trans[path[t - 1], path[t]] + emission[t, path[t]]
        return s + stop[path[-1]]

    paths = list(itertools.product(range(C), repeat=T))
    logz = np.log(sum(np.exp(score(p)) for p in paths))
    return score(tuple(labels)) - logz, max(paths, key=score)


def test_crf_matches_brute_force():
    rng = np.random.RandomState(3)
    B, T, C = 2, 4, 3
    emission = rng.randn(B, T, C).astype("float32")
    trans = (rng.randn(C + 2, C) * 0.5).astype("float32")
    labels = rng.randint(0, C, (B, T)).astype("int64")
    ll, _ = _port("linear_chain_crf", {"Emission": [emission],
                                       "Transition": [trans],
                                       "Label": [labels]}, {})
    path, _ = _port("crf_decoding", {"Emission": [emission],
                                     "Transition": [trans]}, {})
    for b in range(B):
        want_ll, want_path = _crf_brute(emission[b].astype(np.float64),
                                        trans.astype(np.float64), labels[b])
        np.testing.assert_allclose(ll["LogLikelihood"][b, 0], want_ll,
                                   rtol=1e-5)
        np.testing.assert_array_equal(path["ViterbiPath"][b], want_path)


@pytest.mark.parametrize("y_rows", [5, 1], ids=["rows", "broadcast"])
def test_cos_sim_matches_reference(y_rows):
    rs = np.random.RandomState(7)
    ins = {"X": [rs.randn(5, 6).astype("float32")],
           "Y": [rs.randn(y_rows, 6).astype("float32")]}
    got = _compare("cos_sim", ins, {}, [("X", 0), ("Y", 0)])
    assert got["Out"].shape == (5, 1) and got["YNorm"].shape == (y_rows, 1)
