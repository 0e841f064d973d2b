"""The port's fused GRU (K8a/K8b plain versions and the ``gru`` op)
against the JAX reference on the same numpy inputs, and the CPU models of
K8a's and K8b's split-TF32 products (``kernels/_tf32.py``) against the
bounds the card holds them to, each with one TF32 product a term as the
control that must miss it.

The reference's Pallas kernels run in interpret mode on the CPU, as its
own ``tests/test_rnn_kernel.py`` runs them; the JAX scan is the XLA
lowering's math and its ``jax.grad`` the reference's default gradient.
Tolerances are the reference tests' own: 1e-5 for the forward, 2e-4 for
the gradients (float32 in two frameworks, different summation orders
through the recurrence).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.kernels import rnn as R
from paddle_tpu.layer_helper import LayerHelper as JHelper
from paddle_tpu.layers.nn import seq_len_var as j_seq_len_var
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import rnn as TR
from paddle_tpu_torch.kernels._tf32 import matmul_tf32, matmul_tf32x3
from paddle_tpu_torch.layer_helper import LayerHelper as THelper
from paddle_tpu_torch.layers.nn import seq_len_var as t_seq_len_var

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _scan(xproj, w, h0, mask):
    """jnp scan with the math of the reference's XLA gru lowering."""
    H = w.shape[0]
    w_uz, w_c = w[:, :2 * H], w[:, 2 * H:]
    xs = jnp.swapaxes(xproj, 0, 1)
    ms = jnp.swapaxes(mask, 0, 1)[..., None]

    def step(h, inp):
        x_t, m_t = inp
        uz = jax.nn.sigmoid(x_t[:, :2 * H] + jnp.matmul(h, w_uz))
        u, r = uz[:, :H], uz[:, H:]
        c = jnp.tanh(x_t[:, 2 * H:] + jnp.matmul(r * h, w_c))
        h_new = u * h + (1 - u) * c
        h_new = m_t * h_new + (1 - m_t) * h
        return h_new, h_new

    _, hs = jax.lax.scan(step, h0, (xs, ms))
    return jnp.swapaxes(hs, 0, 1)


def _data(masked, B=4, T=6, H=16, seed=3):
    rs = np.random.RandomState(seed)
    xproj = rs.randn(B, T, 3 * H).astype("float32") * 0.5
    w = rs.randn(H, 3 * H).astype("float32") * 0.3
    h0 = rs.randn(B, H).astype("float32") * 0.1
    lens = rs.randint(1, T + 1, (B,)) if masked else np.full((B,), T)
    lens[0] = 1
    mask = (np.arange(T)[None, :] < lens[:, None]).astype("float32")
    return xproj, w, h0, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("masked", [False, True])
def test_gru_ref_matches_pallas_forward_and_scan(masked):
    args = _data(masked)
    hs = TR.gru_ref(*_t(*args)).numpy()
    np.testing.assert_allclose(
        hs, np.asarray(R.gru_fused(*map(jnp.asarray, args), True)), **FWD_TOL)
    np.testing.assert_allclose(
        hs, np.asarray(_scan(*map(jnp.asarray, args))), **FWD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_gru_grad_ref_matches_pallas_backward_and_scan(masked):
    """The cotangent of loss = |hs|^2, as the reference's
    test_fused_gru_forward_and_grads_match_scan feeds it: against the
    Pallas backward in interpret mode and ``jax.grad`` of the scan."""
    args = _data(masked, seed=4)
    xproj, w, h0, mask = map(jnp.asarray, args)
    hs = R.gru_fused(xproj, w, h0, mask, True)
    want_p = R.gru_fused_grad(xproj, w, h0, mask, hs, 2.0 * hs, True)
    want_s = jax.grad(lambda x, w_, h: jnp.sum(_scan(x, w_, h, mask) ** 2),
                      (0, 1, 2))(xproj, w, h0)
    hs_n = np.asarray(hs)
    got = TR.gru_grad_ref(*_t(*args, hs_n, 2.0 * hs_n))
    for name, a, b, c in zip(["dx", "dw", "dh0"], got, want_p, want_s):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_gru_ref_split_tf32_model_matches_pallas_forward(masked):
    """``gru_ref`` with K8a's split-TF32 products (``kernels/_tf32.py``)
    against the reference's Pallas forward in interpret mode, at the
    reference tests' forward tolerance."""
    args = _data(masked, seed=7)
    hs = TR.gru_ref(*_t(*args), matmul=matmul_tf32x3).numpy()
    np.testing.assert_allclose(
        hs, np.asarray(R.gru_fused(*map(jnp.asarray, args), True)), **FWD_TOL)


# chip_smoke.py's bound on K8a's hs, max|d| <= K8A_FWD_ATOL: the CPU model
# of its split-TF32 products reaches 3.0e-7..3.9e-7 at machine
# translation's shape on the four seeds below, one TF32 product a term
# 1.4e-4..1.6e-4, which the recurrent kernels' LSTM_FWD_ATOL = 1e-4 would
# tell apart by a slim margin only
K8A_FWD_ATOL = 1e-5
K8A_SEEDS = [30, 31, 32, 33]


def _k8a_mt_err(matmul, seed):
    """max|d| of :func:`TR.gru_ref` with both recurrent products taken by
    ``matmul``, against the float32 plain forward, at machine
    translation's shape (B=64, T=32, H=256, ragged 8..32)."""
    rs = np.random.RandomState(seed)
    B, T, H = 64, 32, 256
    xproj = rs.randn(B, T, 3 * H).astype("float32") * 0.5
    w = (rs.randn(H, 3 * H) / np.sqrt(H)).astype("float32")
    h0 = rs.randn(B, H).astype("float32") * 0.1
    lens = rs.randint(8, T + 1, (B,))
    mask = (np.arange(T)[None, :] < lens[:, None]).astype("float32")
    args = _t(xproj, w, h0, mask)
    return (TR.gru_ref(*args, matmul=matmul)
            - TR.gru_ref(*args)).abs().max().item()


@pytest.mark.parametrize("seed", K8A_SEEDS)
def test_split_tf32_model_holds_k8as_tolerance(seed):
    """K8a's products in split TF32 (the kernel's arithmetic): hs within
    K8A_FWD_ATOL of the float32 plain forward."""
    assert _k8a_mt_err(matmul_tf32x3, seed) <= K8A_FWD_ATOL


@pytest.mark.parametrize("seed", K8A_SEEDS)
def test_one_tf32_product_breaks_k8as_tolerance(seed):
    """The control: the same forward with one TF32 product a term misses
    K8A_FWD_ATOL, which the card holds K8a to."""
    assert _k8a_mt_err(matmul_tf32, seed) > K8A_FWD_ATOL


# name -> (B, T, H, ragged lengths, rows a group, dw splits, a row
# masked at every step)
PHASE_CASES = {
    "ragged_b6_groups_of_4": (6, 7, 16, True, 4, 3, False),
    "t1": (4, 1, 16, True, 32, 2, False),
    "h20_b5_groups_of_2_dead_row": (5, 6, 20, True, 2, 2, True),
    "full_lengths": (4, 6, 16, False, 32, 1, False),
}


@pytest.mark.parametrize("name", list(PHASE_CASES))
def test_gru_grad_phases_match_pallas_backward(name):
    """K8b's decomposition (the gates of every step in two products, the
    recurrence per batch group, dw as one split product) against the
    reference's fused backward in interpret mode: ragged masks, T=1, a
    batch that is not a multiple of the group, H not a multiple of 16
    and a row masked throughout."""
    B, T, H, masked, rows, splits, dead_row = PHASE_CASES[name]
    args = _data(masked, B=B, T=T, H=H, seed=8)
    if dead_row:
        args[3][-1] = 0.0
    xproj, w, h0, mask = map(jnp.asarray, args)
    hs = R.gru_fused(xproj, w, h0, mask, True)
    want = R.gru_fused_grad(xproj, w, h0, mask, hs, 2.0 * hs, True)
    hs_n = np.asarray(hs)
    got = TR.gru_grad_phases(*_t(*args, hs_n, 2.0 * hs_n), rows=rows,
                             splits=splits)
    for gname, a, b in zip(["dx", "dw", "dh0"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=gname,
                                   **GRAD_TOL)
    if dead_row:
        assert torch.count_nonzero(got[0][-1]).item() == 0


# chip_smoke.py's bound on K8b's gradients, max|d| <= bound * max|ref|:
# LSTM_GRAD_REL, the recurrent kernels' bound, and K8b's own tighter one
# for its split-TF32 products.  At machine translation's shape the CPU
# model of K8b's arithmetic reaches 1.7e-7..4.6e-7 of max|ref| on the four
# seeds below, one TF32 product a term 2.4e-4..2.8e-4
LSTM_GRAD_REL = 1e-3
K8B_GRAD_REL = 2e-5
K8B_SEEDS = [20, 21, 22, 23]


def _k8b_mt_rel(matmul, seed):
    """max|d| / max|ref| of each gradient of :func:`TR.gru_grad_phases`
    with every product taken by ``matmul``, against the float32 plain
    backward, at machine translation's shape (B=64, T=32, H=256, ragged
    8..32)."""
    rs = np.random.RandomState(seed)
    B, T, H = 64, 32, 256
    xproj = rs.randn(B, T, 3 * H).astype("float32") * 0.5
    w = (rs.randn(H, 3 * H) / np.sqrt(H)).astype("float32")
    h0 = rs.randn(B, H).astype("float32") * 0.1
    lens = rs.randint(8, T + 1, (B,))
    mask = (np.arange(T)[None, :] < lens[:, None]).astype("float32")
    dhs = rs.randn(B, T, H).astype("float32")
    args = _t(xproj, w, h0, mask)
    hs = TR.gru_ref(*args)
    ref = TR.gru_grad_ref(*args, hs, *_t(dhs))
    got = TR.gru_grad_phases(*args, hs, *_t(dhs), matmul=matmul)
    return {gname: ((a - b).abs().max() / b.abs().max()).item()
            for gname, a, b in zip(["dx", "dw", "dh0"], got, ref)}


@pytest.mark.parametrize("seed", K8B_SEEDS)
def test_split_tf32_model_holds_k8bs_tolerance(seed):
    """K8b's products in split TF32 (``kernels/_tf32.py``, the kernel's
    arithmetic): every gradient within K8B_GRAD_REL of max|ref|."""
    for gname, rel in _k8b_mt_rel(matmul_tf32x3, seed).items():
        assert rel <= min(LSTM_GRAD_REL, K8B_GRAD_REL), (gname, rel)


@pytest.mark.parametrize("seed", K8B_SEEDS)
def test_one_tf32_product_breaks_k8bs_bound(seed):
    """The control: the same backward with each product taken once in
    TF32 stays within LSTM_GRAD_REL (so that bound alone cannot tell it
    from split TF32) but not within K8B_GRAD_REL, which the card holds
    K8b to."""
    rels = _k8b_mt_rel(matmul_tf32, seed)
    assert max(rels.values()) <= LSTM_GRAD_REL, rels
    assert max(rels.values()) > K8B_GRAD_REL, rels


def test_wrappers_take_the_plain_versions_on_the_cpu():
    args = _t(*_data(True, seed=5))
    n = (TR.gru_fused.launches, TR.gru_fused_grad.launches)
    hs = TR.gru_fused(*args)
    assert torch.equal(hs, TR.gru_ref(*args))
    for a, b in zip(TR.gru_fused_grad(*args, hs, hs),
                    TR.gru_grad_ref(*args, hs, hs)):
        assert torch.equal(a, b)
    assert (TR.gru_fused.launches, TR.gru_fused_grad.launches) == n


B, T, H = 4, 5, 8
LENS = np.array([5, 3, 1, 4], "int64")


def _gru_program(fluid, Program, guard, unique, Helper, seq_len_var,
                 reverse, use_kernel, with_h0):
    prog, startup = Program(), Program()
    prog.random_seed = startup.random_seed = 7
    with guard(prog, startup), unique.guard():
        d = fluid.layers.data("x", [T, 3 * H], lod_level=1,
                              stop_gradient=False)
        helper = Helper("gru")
        w = helper.create_parameter("w", (H, 3 * H), "float32")
        hidden = helper.create_variable_for_type_inference(
            "float32", shape=(B, T, H))
        last_h = helper.create_variable_for_type_inference(
            "float32", shape=(B, H))
        ins = {"Input": [d], "Weight": [w], "SeqLen": [seq_len_var(d)]}
        if with_h0:
            ins["H0"] = [fluid.layers.data("h0", [H], stop_gradient=False)]
        attrs = {"is_reverse": reverse}
        if use_kernel is not None:
            attrs["use_pallas_kernel"] = use_kernel
        helper.append_op("gru", ins, {"Hidden": [hidden], "LastH": [last_h]},
                         attrs)
        loss = fluid.layers.elementwise_add(
            fluid.layers.mean(hidden), fluid.layers.mean(last_h))
        fluid.append_backward(loss)
    fetch = [hidden.name, last_h.name, "w@GRAD", "x@GRAD"]
    if with_h0:
        fetch.append("h0@GRAD")
    return prog, startup, fetch


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("use_kernel", [True, None, False],
                         ids=["pallas", "default", "scan"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_op_in_program_matches_reference(reverse, use_kernel, with_h0):
    """The gru op and its explicit grad inside a program, ragged lengths
    (one row of length 1) with the LastH cotangent and an optional H0:
    the port against the reference run with the same
    ``use_pallas_kernel`` (True is the Pallas kernels in interpret mode;
    absent and False its XLA scan and ``jax.vjp``)."""
    rs = np.random.RandomState(6)
    feed = {"x": rs.randn(B, T, 3 * H).astype("float32") * 0.3,
            "x@LEN": LENS}
    if with_h0:
        feed["h0"] = rs.randn(B, H).astype("float32") * 0.2
    prog, startup, fetch = _gru_program(
        jfluid, JProgram, j_guard, j_unique, JHelper, j_seq_len_var, reverse,
        use_kernel, with_h0)
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {"w": np.array(scope.find_var("w"))}
        want = exe.run(prog, feed=feed, fetch_list=fetch)

    prog, _, fetch = _gru_program(
        tfluid, TProgram, t_guard, t_unique, THelper, t_seq_len_var, reverse,
        use_kernel, with_h0)
    scope = tfluid.Scope()
    scope.load_numpy(init, device="cpu")
    n = (TR.gru_fused.launches, TR.gru_fused_grad.launches,
         t_lowering.grad_recomputes)
    got = tfluid.Executor("cpu").run(prog, feed=feed, fetch_list=fetch,
                                     scope=scope)
    assert (TR.gru_fused.launches, TR.gru_fused_grad.launches,
            t_lowering.grad_recomputes) == n
    for name, a, b in zip(fetch[:2], got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **FWD_TOL)
    for name, a, b in zip(fetch[2:], got[2:], want[2:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
