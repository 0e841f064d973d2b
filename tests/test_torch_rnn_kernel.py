"""The port's fused LSTM (K6/K7 plain versions and the ``lstm`` op)
against the JAX reference on the same numpy inputs.

The reference's Pallas kernels run in interpret mode on the CPU, as its
own ``tests/test_rnn_kernel.py`` runs them; the JAX scan is the XLA
lowering's math.  Tolerances are the reference tests' own: 1e-5 for the
forward, 2e-4 for the gradients (float32 in two frameworks, different
summation orders through the recurrence).
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


def _scan(xproj, w, h0, c0, mask):
    """jnp scan with the math of the reference's XLA lstm lowering."""
    xs = jnp.swapaxes(xproj, 0, 1)
    ms = jnp.swapaxes(mask, 0, 1)[..., None]

    def step(carry, inp):
        h, c = carry
        x_t, m_t = inp
        i, f, g, o = jnp.split(x_t + jnp.matmul(h, w), 4, axis=-1)
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        c_new = f * c + i * jnp.tanh(g)
        h_new = o * jnp.tanh(c_new)
        c_new = m_t * c_new + (1 - m_t) * c
        h_new = m_t * h_new + (1 - m_t) * h
        return (h_new, c_new), (h_new, c_new)

    _, (hs, cs) = jax.lax.scan(step, (h0, c0), (xs, ms))
    return jnp.swapaxes(hs, 0, 1), jnp.swapaxes(cs, 0, 1)


def _data(masked, B=4, T=6, H=16, seed=3):
    rs = np.random.RandomState(seed)
    xproj = rs.randn(B, T, 4 * H).astype("float32") * 0.5
    w = rs.randn(H, 4 * H).astype("float32") * 0.3
    h0 = rs.randn(B, H).astype("float32") * 0.1
    c0 = rs.randn(B, H).astype("float32") * 0.1
    lens = rs.randint(1, T + 1, (B,)) if masked else np.full((B,), T)
    lens[0] = 1
    mask = (np.arange(T)[None, :] < lens[:, None]).astype("float32")
    return xproj, w, h0, c0, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("masked", [False, True])
def test_lstm_ref_matches_pallas_forward_and_scan(masked):
    args = _data(masked)
    hs, cs = TR.lstm_ref(*_t(*args))
    hs_p, cs_p = R.lstm_fused(*map(jnp.asarray, args), True)
    hs_s, cs_s = _scan(*map(jnp.asarray, args))
    for got, want in ((hs, hs_p), (cs, cs_p), (hs, hs_s), (cs, cs_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_lstm_grad_ref_matches_pallas_backward(masked):
    """The cotangents of loss = |hs|^2 + 0.5|cs|^2, as the reference's
    test_fused_lstm_grads_match_scan feeds them."""
    args = _data(masked, seed=4)
    hs, cs = R.lstm_fused(*map(jnp.asarray, args), True)
    want = R.lstm_fused_grad(*map(jnp.asarray, args), hs, cs, 2.0 * hs,
                             1.0 * cs, True)
    hs_n, cs_n = np.asarray(hs), np.asarray(cs)
    got = TR.lstm_grad_ref(*_t(*args, hs_n, cs_n, 2.0 * hs_n, cs_n.copy()))
    for name, a, b in zip(["dx", "dw", "dh0", "dc0"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


# name -> (B, T, H, ragged lengths, rows a group, dW splits, a row
# masked at every step)
PHASE_CASES = {
    "ragged_b6_groups_of_4": (6, 7, 16, True, 4, 3, False),
    "t1": (4, 1, 16, True, 32, 2, False),
    "h20_b5_groups_of_2_dead_row": (5, 6, 20, True, 2, 2, True),
    "full_lengths": (4, 6, 16, False, 32, 1, False),
}


@pytest.mark.parametrize("name", list(PHASE_CASES))
def test_lstm_grad_phases_match_pallas_backward(name):
    """K7's decomposition (gates of every step in one product, the
    recurrence per batch group, dW as one split product) against the
    reference's fused backward in interpret mode: ragged masks, T=1, a
    batch that is not a multiple of the group, H not a multiple of 16
    and a row masked throughout."""
    B, T, H, masked, rows, splits, dead_row = PHASE_CASES[name]
    args = _data(masked, B=B, T=T, H=H, seed=8)
    if dead_row:
        args[4][-1] = 0.0
    hs, cs = R.lstm_fused(*map(jnp.asarray, args), True)
    want = R.lstm_fused_grad(*map(jnp.asarray, args), hs, cs, 2.0 * hs,
                             1.0 * cs, True)
    hs_n, cs_n = np.asarray(hs), np.asarray(cs)
    got = TR.lstm_grad_phases(*_t(*args, hs_n, cs_n, 2.0 * hs_n,
                                  cs_n.copy()), rows=rows, splits=splits)
    for gname, a, b in zip(["dx", "dw", "dh0", "dc0"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=gname,
                                   **GRAD_TOL)
    if dead_row:
        assert torch.count_nonzero(got[0][-1]).item() == 0


# chip_smoke.py's bounds on K7's gradients, max|d| <= bound * max|ref|:
# LSTM_GRAD_REL for the recurrent kernels, and K7's own tighter one for
# its split-TF32 products
LSTM_GRAD_REL = 1e-3
K7_GRAD_REL = 1.5e-4


def _k7_bench_rel(matmul):
    """max|d| / max|ref| of each gradient of :func:`TR.lstm_grad_phases`
    with every product taken by ``matmul``, against the float32 plain
    backward, at the bench's widths, B=128 and H=512, with T cut to 8
    (the error of a product does not grow with T; the carries are summed
    in float32 either way)."""
    rs = np.random.RandomState(12)
    B, T, H = 128, 8, 512
    xproj = rs.randn(B, T, 4 * H).astype("float32") * 0.5
    w = (rs.randn(H, 4 * H) / np.sqrt(H)).astype("float32")
    h0 = rs.randn(B, H).astype("float32") * 0.1
    c0 = rs.randn(B, H).astype("float32") * 0.1
    lens = rs.randint(1, T + 1, (B,))
    mask = (np.arange(T)[None, :] < lens[:, None]).astype("float32")
    dhs = rs.randn(B, T, H).astype("float32")
    dcs = rs.randn(B, T, H).astype("float32")
    args = _t(xproj, w, h0, c0, mask)
    hs, cs = TR.lstm_ref(*args)
    ref = TR.lstm_grad_ref(*args, hs, cs, *_t(dhs, dcs))
    got = TR.lstm_grad_phases(*args, hs, cs, *_t(dhs, dcs), matmul=matmul)
    return {gname: ((a - b).abs().max() / b.abs().max()).item()
            for gname, a, b in zip(["dx", "dw", "dh0", "dc0"], got, ref)}


def test_split_tf32_model_holds_k7s_tolerance():
    """K7's products in split TF32 (``kernels/_tf32.py``, the kernel's
    arithmetic): every gradient within LSTM_GRAD_REL and within K7's own
    K7_GRAD_REL of max|ref|."""
    for gname, rel in _k7_bench_rel(matmul_tf32x3).items():
        assert rel <= min(LSTM_GRAD_REL, K7_GRAD_REL), (gname, rel)


def test_one_tf32_product_breaks_k7s_bound():
    """The control: the same backward with each product taken once in
    TF32 stays within LSTM_GRAD_REL (so that bound alone cannot tell it
    from split TF32) but not within K7_GRAD_REL, which the card holds
    K7 to."""
    rels = _k7_bench_rel(matmul_tf32)
    assert max(rels.values()) <= LSTM_GRAD_REL, rels
    assert max(rels.values()) > K7_GRAD_REL, rels


# the bounds on K6's hs and cs: max|d| <= LSTM_FWD_ATOL, the bound of a
# float32 recurrence, and K6_FWD_ATOL, K6's own in chip_smoke.py: split TF32
# reaches 2.3e-7..3.9e-7 here, one TF32 product a term 1.2e-4..1.8e-4
LSTM_FWD_ATOL = 1e-4
K6_FWD_ATOL = 1e-5
# (seed, T): the bench's B=128 and H=512 with T cut to 8 on four seeds,
# and the bench's T=128
K6_CASES = [(12, 8), (13, 8), (14, 8), (12, 128)]


def _k6_bench_err(matmul, seed, T):
    """max|d| over hs and cs of :func:`TR.lstm_ref` with the recurrent
    product taken by ``matmul``, against the float32 plain forward, at the
    bench's widths, B=128 and H=512, ragged, over T steps."""
    rs = np.random.RandomState(seed)
    B, H = 128, 512
    xproj = rs.randn(B, T, 4 * H).astype("float32") * 0.5
    w = (rs.randn(H, 4 * H) / np.sqrt(H)).astype("float32")
    h0 = rs.randn(B, H).astype("float32") * 0.1
    c0 = rs.randn(B, H).astype("float32") * 0.1
    lens = rs.randint(1, T + 1, (B,))
    mask = (np.arange(T)[None, :] < lens[:, None]).astype("float32")
    args = _t(xproj, w, h0, c0, mask)
    ref = TR.lstm_ref(*args)
    got = TR.lstm_ref(*args, matmul=matmul)
    return max((a - b).abs().max().item() for a, b in zip(got, ref))


@pytest.mark.parametrize("case", K6_CASES,
                         ids=[f"seed{s}_t{t}" for s, t in K6_CASES])
def test_split_tf32_model_holds_k6s_tolerance(case):
    """K6's recurrent product in split TF32 (``kernels/_tf32.py``, the
    kernel's arithmetic): hs and cs within K6_FWD_ATOL (and so within
    LSTM_FWD_ATOL)."""
    assert _k6_bench_err(matmul_tf32x3, *case) <= K6_FWD_ATOL


@pytest.mark.parametrize("case", K6_CASES,
                         ids=[f"seed{s}_t{t}" for s, t in K6_CASES])
def test_one_tf32_product_breaks_k6s_tolerance(case):
    """The control: the same forward with one TF32 product a term misses
    K6_FWD_ATOL, which the card holds K6 to.  It misses LSTM_FWD_ATOL too,
    but only by 1.2-1.8x, too slim a margin to be K6's bound alone."""
    assert _k6_bench_err(matmul_tf32, *case) > K6_FWD_ATOL


def test_wrappers_take_the_plain_versions_on_the_cpu():
    args = _t(*_data(True, seed=5))
    n = (TR.lstm_fused.launches, TR.lstm_fused_grad.launches)
    hs, cs = TR.lstm_fused(*args)
    ref = TR.lstm_ref(*args)
    assert torch.equal(hs, ref[0]) and torch.equal(cs, ref[1])
    g = TR.lstm_fused_grad(*args, hs, cs, hs, cs)
    for a, b in zip(g, TR.lstm_grad_ref(*args, hs, cs, hs, cs)):
        assert torch.equal(a, b)
    assert (TR.lstm_fused.launches, TR.lstm_fused_grad.launches) == n


B, T, H = 4, 5, 8
LENS = np.array([5, 3, 1, 4], "int64")


def _lstm_program(fluid, Program, guard, unique, Helper, seq_len_var,
                  reverse, use_kernel):
    prog, startup = Program(), Program()
    prog.random_seed = startup.random_seed = 7
    with guard(prog, startup), unique.guard():
        d = fluid.layers.data("x", [T, 4 * H], lod_level=1,
                              stop_gradient=False)
        helper = Helper("lstm")
        w = helper.create_parameter("w", (H, 4 * H), "float32")
        outs = {s: helper.create_variable_for_type_inference(
                    "float32", shape=shp)
                for s, shp in (("Hidden", (B, T, H)), ("Cell", (B, T, H)),
                               ("LastH", (B, H)), ("LastC", (B, H)))}
        attrs = {"is_reverse": reverse}
        if use_kernel is not None:
            attrs["use_pallas_kernel"] = use_kernel
        helper.append_op(
            "lstm", {"Input": [d], "Weight": [w], "SeqLen": [seq_len_var(d)]},
            {s: [v] for s, v in outs.items()}, attrs)
        loss = fluid.layers.elementwise_add(
            fluid.layers.mean(outs["Hidden"]), fluid.layers.mean(outs["LastH"]))
        fluid.append_backward(loss)
    fetch = [outs["Hidden"].name, outs["Cell"].name, outs["LastH"].name,
             outs["LastC"].name, "w@GRAD", "x@GRAD"]
    return prog, startup, fetch


@pytest.mark.parametrize("use_kernel", [True, None, False],
                         ids=["pallas", "default", "scan"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_op_in_program_matches_reference(reverse, use_kernel):
    """The lstm op and its explicit grad inside a program, ragged lengths
    (one row of length 1) with the LastH cotangent: the port against the
    reference run with the same ``use_pallas_kernel`` (True is the
    Pallas kernels in interpret mode; absent and False its XLA scan)."""
    x = np.random.RandomState(6).randn(B, T, 4 * H).astype("float32") * 0.3
    feed = {"x": x, "x@LEN": LENS}
    prog, startup, fetch = _lstm_program(
        jfluid, JProgram, j_guard, j_unique, JHelper, j_seq_len_var, reverse,
        use_kernel)
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {"w": np.array(scope.find_var("w"))}
        want = exe.run(prog, feed=feed, fetch_list=fetch)

    prog, _, fetch = _lstm_program(
        tfluid, TProgram, t_guard, t_unique, THelper, t_seq_len_var, reverse,
        use_kernel)
    scope = tfluid.Scope()
    scope.load_numpy(init, device="cpu")
    n = (TR.lstm_fused.launches, TR.lstm_fused_grad.launches,
         t_lowering.grad_recomputes)
    got = tfluid.Executor("cpu").run(prog, feed=feed, fetch_list=fetch,
                                     scope=scope)
    assert (TR.lstm_fused.launches, TR.lstm_fused_grad.launches,
            t_lowering.grad_recomputes) == n
    for name, a, b in zip(fetch[:4], got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **FWD_TOL)
    for name, a, b in zip(fetch[4:], got[4:], want[4:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


# the H100's numbers for the eligibility gates: 132 SMs, 233,472 bytes of
# shared memory an SM (at most 232,448 a block, 1 KB of it reserved a
# resident block), 2,048 threads an SM (8 blocks of the kernels' 256)
def _h100_capacity(smem):
    return 132 * min(8, 233472 // (smem + 1024)) if smem <= 232448 else 0


def _lstm_fwd_smem(H):   # lstm_fwd.cu: fwd_smem_bytes, 16 units or 8
    units = 16 if H <= 512 else 8
    return 4 * (4 * units * (-(-H // 128) * 128 + 4) + 18432) + 4 * 260


def _gru_fwd_smem(H):   # gru_fwd.cu: fwd_smem_bytes, 16 units' columns or 8
    units = 16 if H <= 896 else 8
    return 4 * (3 * units * (-(-H // 128) * 128 + 4) + 13824) + 4 * 260


def _lstm_bwd_smem(H):   # lstm_bwd.cu: recur_smem_floats
    return 4 * (16 * (-(-4 * H // 32) * 32 + 4) + 2 * 8704 + 256 * 16 + 8)


def _gru_bwd_smem(H):   # gru_bwd.cu: recur_smem_bytes, 16 units' rows or 8
    units = 16 if H <= 896 else 8
    w_ld = -(-2 * H // 128) * 128 + -(-H // 128) * 128 + 4
    return 4 * (units * w_ld + 13824) + 4 * 2 * (2 * 128 + 1)


@pytest.mark.parametrize("gate", ["lstm", "lstm_bwd", "gru", "gru_bwd"])
@pytest.mark.parametrize("case", [
    ("B128_H512", 128, 128, 512, torch.float32, True),
    ("H2048", 2, 3, 2048, torch.float32, False),
    ("bf16", 8, 4, 64, torch.bfloat16, False),
    ("float64", 8, 4, 64, torch.float64, False),
    ("empty_batch", 0, 4, 64, torch.float32, False),
    ("H1", 1, 1, 1, torch.float32, True),
    ("B1024_H512", 1024, 8, 512, torch.float32, True),
    # K6, K8a and K8b at 8 units a block; K7's 16 units' W no longer fits
    # a block
    ("H1024", 8, 4, 1024, torch.float32,
     {"lstm": True, "lstm_bwd": False, "gru": True, "gru_bwd": True}),
], ids=lambda c: c[0] if isinstance(c, tuple) else c)
def test_eligibility_gates_with_the_h100s_numbers(gate, case):
    """``lstm_eligible``/``gru_eligible`` are pure: float32, non-empty,
    and the kernel's persistent blocks within the card's resident-block
    capacity at the kernel's shared memory a block (0 when a block may
    not have that much).  K6 and K7's recurrence need ceil(H/16) blocks,
    whatever B (their batch groups take turns when the card cannot hold
    them side by side), K6 ceil(H/8) past H=512; K8a's and K8b's
    recurrences ceil(H/16) as K7's, ceil(H/8) past H=896.  At H=2048 a
    block of K6 would need 337,424 bytes and one of K7 610,336; an H100
    holds 132 blocks of K6's 206,864 bytes at H=512 and of its 206,352 at
    H=1024, 132 of K7's 217,376, of K8a's 155,408 and of K8b's 155,912 at
    H=512, and 132 of K8a's 155,024 and of K8b's 155,784 at H=1024."""
    _, B, T, H, dtype, want = case
    if isinstance(want, dict):
        want = want[gate]
    if gate == "lstm_bwd":
        fn = lambda *a: TR.lstm_eligible(*a, lib="lstm_bwd")  # noqa: E731
        smem, need = _lstm_bwd_smem(H), 32
    elif gate == "gru_bwd":
        fn = lambda *a: TR.gru_eligible(*a, lib="gru_bwd")  # noqa: E731
        smem, need = _gru_bwd_smem(H), 32
    elif gate == "lstm":
        fn = TR.lstm_eligible
        smem, need = _lstm_fwd_smem(H), 32
    else:
        fn = TR.gru_eligible
        smem, need = _gru_fwd_smem(H), 32
    assert fn(B, T, H, dtype, _h100_capacity(smem)) is want
    # a block over the shared-memory limit has capacity 0; the capacity
    # alone decides
    assert _h100_capacity(232448 + 4) == 0
    assert not fn(128, 128, 512, torch.float32, _h100_capacity(232448 + 4))
    assert not fn(128, 128, 512, torch.float32, need - 1)
    assert fn(128, 128, 512, torch.float32, need)


@pytest.mark.parametrize("H, blocks, on_h100", [
    (512, 32, True), (513, 65, True), (1024, 128, True), (1056, 132, True),
    (1064, 133, False)])
def test_k6_takes_eight_units_a_block_past_h512(H, blocks, on_h100):
    """K6's blocks are ceil(H/16) up to H=512 and ceil(H/8) past it, where
    16 units' W no longer fits a block: one block an SM, so an H100's 132
    SMs take K6 up to H=1056."""
    assert TR._blocks("lstm_fwd", H) == blocks
    cap = _h100_capacity(_lstm_fwd_smem(H))
    assert cap == 132
    assert TR.lstm_eligible(8, 4, H, torch.float32, cap) is on_h100


@pytest.mark.parametrize("H, blocks, on_h100", [
    (896, 56, True), (897, 113, True), (1024, 128, True), (1056, 132, True),
    (1064, 133, False)])
def test_k8b_takes_eight_units_a_block_past_h896(H, blocks, on_h100):
    """K8b's recurrence takes ceil(H/16) blocks up to H=896 and ceil(H/8)
    past it, where 16 units' rows of w no longer fit a block: one block
    an SM, so an H100's 132 SMs take K8b up to H=1056, and K8a, whose
    blocks follow the same rule, as far."""
    assert TR._blocks("gru_bwd", H) == blocks
    cap = _h100_capacity(_gru_bwd_smem(H))
    assert cap == 132
    assert TR.gru_eligible(8, 4, H, torch.float32, cap, "gru_bwd") is on_h100
    assert TR.gru_eligible(8, 4, H, torch.float32,
                           _h100_capacity(_gru_fwd_smem(H))) is on_h100


def test_gru_gate_keeps_the_h_over_4_rule():
    """K8a's first version needed ceil(H/4) blocks whatever B; its
    recurrence now takes K6's and K8b's grid, so ``gru_eligible`` gates
    it on one batch group's ceil(H/16) blocks (its groups take turns)."""
    assert TR._blocks("gru_fwd", 64) == 4
    assert TR.gru_eligible(4096, 8, 64, torch.float32, 4)
    assert not TR.gru_eligible(4096, 8, 64, torch.float32, 3)
    assert TR.gru_eligible(4096, 8, 64, torch.float32, 4, "gru_fwd")
    assert TR.lstm_eligible(4096, 8, 64, torch.float32, 4, "lstm_bwd")
    assert not TR.lstm_eligible(4096, 8, 64, torch.float32, 3, "lstm_bwd")
    assert TR.lstm_eligible(4096, 8, 64, torch.float32, 4)
    assert not TR.lstm_eligible(4096, 8, 64, torch.float32, 3)


def test_gru_bwd_gate_takes_one_batch_group():
    """K8b's recurrence (``lib="gru_bwd"``) is gated on its own grid:
    one batch group's ceil(H/16) blocks whatever B (its groups take
    turns), as K7's and K8a's."""
    assert TR._blocks("gru_bwd", 256) == 16
    assert TR._blocks("gru_fwd", 256) == 16
    assert TR.gru_eligible(4096, 8, 64, torch.float32, 4, "gru_bwd")
    assert not TR.gru_eligible(4096, 8, 64, torch.float32, 3, "gru_bwd")
    assert TR.gru_eligible(64, 32, 256, torch.float32, 16, "gru_bwd")
    assert not TR.gru_eligible(64, 32, 256, torch.float32, 15, "gru_bwd")
    assert not TR.gru_eligible(64, 32, 256, torch.bfloat16, 132, "gru_bwd")


def test_rnn_ops_on_the_cpu_never_consult_the_gate(monkeypatch):
    """On the CPU the op takes the wrappers (their plain versions) with
    no card query; an explicit use_pallas_kernel still decides."""
    from paddle_tpu_torch.ops import nn_ops

    def no_query(*a, **k):
        raise AssertionError("kernel_capacity queried on the CPU")

    monkeypatch.setattr(TR, "kernel_capacity", no_query)
    x = torch.zeros(2, 3, 16)
    assert nn_ops._use_kernel(None, {}, "lstm_fwd", x)
    assert not nn_ops._use_kernel(None, {"use_pallas_kernel": False},
                                  "gru_bwd", x)
    assert nn_ops._use_kernel(None, {"use_pallas_kernel": True},
                              "gru_fwd", x.bfloat16())
