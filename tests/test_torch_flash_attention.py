"""The port's plain flash attention (the CPU path of kernels K1–K3)
against the JAX package's Pallas kernels, run in interpret mode as
tests/test_attention.py runs them: out and the base-2 LSE from
``_pallas_fwd``, dq/dk/dv from ``_pallas_bwd``, dropout bits included.

Tolerances: both sides compute in float32 over at most a few hundred
keys of O(1) values, in different summation orders, so out/lse agree
to about 1e-6 and the gradients (sums of products of those) to about
1e-5; the bounds below leave a few-fold margin.

bfloat16 inputs (``BF16_CASES``): the kernels' products take bfloat16
operands with float32 sums, and they round to bfloat16 in five places
(the pre-scaled q, p before P . V, the ones-lane mass, ds, p * drop
before its product with dO), which the plain version mirrors; the two
then differ only where a float32 sum taken in another order lands on
the other side of a bfloat16 rounding (a score one float32 ulp off
rounds its p, or a ds, the other way).  One such flip moves a sum of
p- or ds-weighted terms by at most one bfloat16 ulp of its largest
term, so the bar is: every element of out, dq, dk and dv within one
bfloat16 ulp of its tensor's max|ref|, and at most 1% of each
tensor's elements differing at all (leaving out any one of the five
roundings makes a third or more differ).  The LSE within 1e-5, and
where the mass l sums the rounded p (the ones lane), within 1e-5 plus
one flip's share, 2^-8 / (l ln 2).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import attention as JA
from paddle_tpu_torch.kernels import attention as TA
from paddle_tpu_torch.kernels._tf32 import matmul_tf32, matmul_tf32x3

FWD_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# name -> (B, H, Tq, Tk, D, causal, dropout rate, all-masked batch row)
CASES = {
    "noncausal": (2, 2, 64, 64, 16, False, 0.0, False),
    "causal": (2, 2, 64, 64, 16, True, 0.0, False),
    "ragged_multi_tile": (1, 2, 160, 160, 16, True, 0.0, False),
    "cross_tk_gt_tq_causal": (1, 2, 128, 256, 16, True, 0.0, False),
    "all_masked_row": (2, 2, 40, 40, 8, False, 0.0, True),
    "all_masked_row_causal": (2, 2, 40, 40, 8, True, 0.0, True),
    "dropout": (2, 2, 48, 48, 16, False, 0.1, False),
    "dropout_causal_multi_tile": (1, 2, 140, 140, 8, True, 0.1, False),
}


def _inputs(B, H, Tq, Tk, D, all_masked, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, Tq, D).astype("float32")
    k = rs.randn(B, H, Tk, D).astype("float32")
    v = rs.randn(B, H, Tk, D).astype("float32")
    g = rs.randn(B, H, Tq, D).astype("float32")
    mask = (rs.rand(B, Tk) > 0.25).astype("float32")
    mask[:, 0] = 1.0
    if all_masked:
        mask[-1] = 0.0
    return q, k, v, g, mask


def _reference(name):
    B, H, Tq, Tk, D, causal, rate, all_masked = CASES[name]
    q, k, v, g, mask = _inputs(B, H, Tq, Tk, D, all_masked,
                               seed=len(name))
    seed = np.array([1234567], "int32")
    js = jnp.asarray(seed)
    out, lse = JA._pallas_fwd(q, k, v, mask, causal, None, rate, js,
                              interpret=True)
    dq, dk, dv = JA._pallas_bwd(q, k, v, mask, out, lse, g, causal, None,
                                rate, js, interpret=True)
    lse = np.asarray(lse)[:, 0, :Tq]
    return dict(inputs=(q, k, v, g, mask, seed), causal=causal, rate=rate,
                out=np.asarray(out), lse=lse, dq=np.asarray(dq),
                dk=np.asarray(dk), dv=np.asarray(dv))


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _reference(name)
        return cache[name]
    return get


def _port(r):
    q, k, v, g, mask, seed = (torch.from_numpy(x) for x in r["inputs"])
    out, lse = TA.flash_attention_ref(q, k, v, mask, r["causal"], None,
                                      r["rate"], seed)
    dq, dk, dv = TA.flash_attention_bwd_ref(q, k, v, mask, out, lse, g,
                                            r["causal"], None, r["rate"],
                                            seed)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_matches_pallas_interpret(refs, name):
    r = refs(name)
    got = _port(r)
    for key in ("out", "lse"):
        np.testing.assert_allclose(got[key].numpy(), r[key], err_msg=key,
                                   **FWD_TOL)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[key].numpy(), r[key], err_msg=key,
                                   **GRAD_TOL)


def test_cross_length_keys_past_frontier_get_zero_grad(refs):
    """The pin of test_pallas_bwd_cross_length_causal: a k-block wholly
    above the causal frontier (Tk > Tq) gets exactly zero dk/dv."""
    got = _port(refs("cross_tk_gt_tq_causal"))
    assert torch.count_nonzero(got["dk"][:, :, 128:]) == 0
    assert torch.count_nonzero(got["dv"][:, :, 128:]) == 0


def test_all_masked_row_averages_padded_values(refs):
    """A row whose keys are all masked averages V over the reference's
    padded key frame (zero rows past Tk), finite, never NaN."""
    r = refs("all_masked_row")
    got = _port(r)
    v = r["inputs"][2]
    want = v[-1].sum(axis=1) / 128.0          # Tk=40 padded to 128
    np.testing.assert_allclose(got["out"][-1, :, 0].numpy(), want,
                               **FWD_TOL)
    assert torch.isfinite(got["dq"]).all()


def test_dropout_bits_equal_the_tile_hash():
    """The plain tile hash reproduces _tile_dropout bit for bit on one
    logical tile (here a 128 x 128 tile of a T=200 frame)."""
    rate, seed = 0.3, np.array([-5], "int32")
    bh, qi, kb = 3, 1, 1
    ref = np.asarray(JA._tile_dropout(jnp.asarray(seed), bh, qi, kb,
                                      (128, 128), rate))
    full = TA.tile_dropout_ref(torch.from_numpy(seed), 2, 2, 200, 200, rate,
                               "cpu")
    got = full[1, 1, 128:256, 128:256].numpy()        # bh 3 = (1, 1)
    np.testing.assert_array_equal(got[:72], ref[:72])


@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.0),
                                         (False, 0.2), (True, 0.2)])
def test_mha_ref_matches_mha_xla(causal, rate):
    B, H, T, D = 2, 3, 24, 8
    q, k, v, g, mask = _inputs(B, H, T, T, D, False, seed=5)
    seed = np.array([99], "int32")
    ref = np.asarray(JA.mha_xla(q, k, v, mask, causal, None,
                                dropout_rate=rate,
                                dropout_seed=jnp.asarray(seed)))
    got = TA.mha_ref(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), torch.from_numpy(mask), causal,
                     None, rate, torch.from_numpy(seed))
    np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL)


def test_hash_dropout_bits_equal():
    shape, rate = (2, 3, 8, 16), 0.25
    seed = np.array([2 ** 31 - 7], "int32")
    ref = np.asarray(JA._hash_dropout(jnp.asarray(seed).reshape(()), 0,
                                      shape, rate))
    got = TA.hash_dropout_ref(torch.from_numpy(seed), shape, rate)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_autograd_function_uses_saved_lse_on_cpu():
    """flash_attention's backward on the CPU equals the plain backward
    from the saved forward, and launches no kernel."""
    q, k, v, g, mask = _inputs(1, 2, 20, 20, 8, False, seed=9)
    q, k, v, g, mask = (torch.from_numpy(x) for x in (q, k, v, g, mask))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (TA.flash_attention_fwd.launches,
              TA.flash_attention_bwd_dq.launches,
              TA.flash_attention_bwd_dkv.launches)
    out = TA.flash_attention(*leaves, mask, True)
    grads = torch.autograd.grad(out, leaves, g)
    o_ref, lse = TA.flash_attention_ref(q, k, v, mask, True)
    want = TA.flash_attention_bwd_ref(q, k, v, mask, o_ref, lse, g, True)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b)
    assert (TA.flash_attention_fwd.launches,
            TA.flash_attention_bwd_dq.launches,
            TA.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_model_holds_k1s_tolerance(causal):
    """K1's two products in split TF32 (``kernels/_tf32.py``, the
    kernel's arithmetic) at the bench's per-head shape, T=256, D=64,
    dropout 0.1, ragged key masks, with B x H cut to 2 x 8 (heads are
    independent): out and lse within FWD_TOL (chip_smoke.py's
    FLASH_FWD_TOL) of the float32 plain forward."""
    rs = np.random.RandomState(21)
    B, H, T, D = 2, 8, 256, 64
    q, k, v = (torch.from_numpy(rs.randn(B, H, T, D).astype("float32"))
               for _ in range(3))
    lens = rs.randint(1, T + 1, (B,))
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype("float32"))
    seed = torch.tensor([77], dtype=torch.int32)
    ref = TA.flash_attention_ref(q, k, v, mask, causal, None, 0.1, seed)
    got = TA.flash_attention_ref(q, k, v, mask, causal, None, 0.1, seed,
                                 matmul=matmul_tf32x3)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **FWD_TOL)


def _bench_head_inputs(seed):
    """The bench's per-head shape, T=256, D=64, ragged key masks, with
    B x H cut to 2 x 8 (heads are independent)."""
    rs = np.random.RandomState(seed)
    B, H, T, D = 2, 8, 256, 64
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, T, D).astype("float32"))
                   for _ in range(4))
    lens = rs.randint(1, T + 1, (B,))
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype("float32"))
    return q, k, v, do, mask


def _bwd_tol_ratio(causal, matmul):
    """max over dq, dk, dv of |d| / (atol + rtol |ref|) under GRAD_TOL
    (chip_smoke.py's FLASH_GRAD_TOL) for the backward with its five
    products taken by ``matmul``, against the float32 plain backward, at
    dropout 0.1, from the same float32 forward's lse and delta."""
    q, k, v, do, mask = _bench_head_inputs(22)
    seed = torch.tensor([78], dtype=torch.int32)
    out, lse = TA.flash_attention_ref(q, k, v, mask, causal, None, 0.1, seed)
    ref = TA.flash_attention_bwd_ref(q, k, v, mask, out, lse, do, causal,
                                     None, 0.1, seed)
    got = TA.flash_attention_bwd_ref(q, k, v, mask, out, lse, do, causal,
                                     None, 0.1, seed, matmul=matmul)
    return {n: ((a - b).abs() / (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                                 * b.abs())).max().item()
            for n, a, b in zip(("dq", "dk", "dv"), got, ref)}


@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_model_holds_k2_k3s_tolerance(causal):
    """K2's and K3's products in split TF32 (``kernels/_tf32.py``, the
    kernels' arithmetic): dq, dk and dv within GRAD_TOL of the float32
    plain backward at the bench's per-head shape."""
    ratios = _bwd_tol_ratio(causal, matmul_tf32x3)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_breaks_k2_k3s_tolerance(causal):
    """The control: the same backward with each product taken once in
    TF32 leaves GRAD_TOL, so the card's bound tells split TF32 from one
    TF32 product without a bound of its own."""
    ratios = _bwd_tol_ratio(causal, matmul_tf32)
    assert max(ratios.values()) > 1.0, ratios


# bfloat16 cases: name -> (B, H, Tq, Tk, D, causal, rate, all-masked row)
BF16_CASES = {
    "ones_lane_d16": (2, 2, 64, 64, 16, False, 0.0, False),
    "ones_lane_d64_causal": (1, 2, 256, 256, 64, True, 0.0, False),
    "d128": (1, 2, 128, 128, 128, False, 0.0, False),
    "dropout": (2, 2, 48, 48, 16, False, 0.1, False),
    "dropout_causal_multi_tile": (1, 2, 140, 140, 8, True, 0.1, False),
    "masked_all_masked_row": (2, 2, 40, 40, 8, False, 0.0, True),
    "ragged_multi_tile": (1, 2, 160, 160, 16, True, 0.0, False),
    "cross_tk_gt_tq_causal": (1, 2, 128, 256, 16, True, 0.0, False),
}
BF16_DIFFER_FRAC = 0.01
BF16_LSE_ATOL = 1e-5


def _bf16_np(x):
    """float32 numpy values rounded to bfloat16 (returned as float32)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _ulp_bf16(x):
    """The bfloat16 spacing at |x| (0 where x is 0)."""
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _within_bf16_bar(name, got, ref):
    diff = np.abs(got.float().numpy() - ref)
    assert diff.max() <= _ulp_bf16(np.abs(ref).max()), (name, diff.max())
    frac = np.count_nonzero(diff) / diff.size
    assert frac <= BF16_DIFFER_FRAC, (name, frac)


def _ones_lane_mass(r):
    """The reference's softmax mass l of each row, [B*H, Tq], from its
    LSE and the row's largest visited score."""
    q, k, _, _, mask, _ = (torch.from_numpy(x) for x in r["inputs"])
    s = TA._padded_scores(q.bfloat16(), k.bfloat16(), mask, r["causal"],
                          1.0 / np.sqrt(q.shape[-1]))
    key_end, _ = TA._visits(q.shape[2], k.shape[2], r["causal"], "cpu")
    vis = torch.arange(s.shape[-1])[None] < key_end[:, None]
    m = s.masked_fill(~vis, -np.inf).amax(-1).reshape(r["lse"].shape)
    return np.exp2(r["lse"] - m.numpy())


def _bf16_reference(name):
    B, H, Tq, Tk, D, causal, rate, all_masked = BF16_CASES[name]
    q, k, v, g, mask = (_bf16_np(x) if x.ndim == 4 else x
                        for x in _inputs(B, H, Tq, Tk, D, all_masked,
                                         len(name)))
    seed = np.array([-99], "int32")
    js = jnp.asarray(seed)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    out, lse = JA._pallas_fwd(jq, jk, jv, mask, causal, None, rate, js,
                              interpret=True)
    dq, dk, dv = JA._pallas_bwd(jq, jk, jv, mask, out, lse, jg, causal,
                                None, rate, js, interpret=True)

    def f32(x):
        return np.asarray(x, np.float32)
    return dict(inputs=(q, k, v, g, mask, seed), causal=causal, rate=rate,
                out=f32(out), lse=f32(lse)[:, 0, :Tq], dq=f32(dq),
                dk=f32(dk), dv=f32(dv))


@pytest.fixture(scope="module")
def bf16_refs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _bf16_reference(name)
        return cache[name]
    return get


def _port_bf16(r):
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in r["inputs"][:4])
    mask, seed = (torch.from_numpy(x) for x in r["inputs"][4:])
    out, lse = TA.flash_attention_ref(q, k, v, mask, r["causal"], None,
                                      r["rate"], seed)
    dq, dk, dv = TA.flash_attention_bwd_ref(q, k, v, mask, out, lse, g,
                                            r["causal"], None, r["rate"],
                                            seed)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_plain_flash_bf16_within_one_ulp_of_pallas(bf16_refs, name):
    r = bf16_refs(name)
    got = _port_bf16(r)
    for key in ("out", "dq", "dk", "dv"):
        assert got[key].dtype == torch.bfloat16, key
        _within_bf16_bar(key, got[key], r[key])
    assert got["lse"].dtype == torch.float32
    bound = BF16_LSE_ATOL
    D = r["inputs"][0].shape[-1]
    if D < 128 and r["rate"] == 0.0:      # the ones lane
        bound = bound + 2.0 ** -8 / (_ones_lane_mass(r) * np.log(2.0))
    assert (np.abs(got["lse"].numpy() - r["lse"]) <= bound).all()


def test_bf16_gradients_hold_the_references_bar():
    """The reference's test_pallas_bwd_bf16_grad_precision bar on the
    plain versions: flash_attention's bfloat16 gradients against
    float32 attention of the same inputs, relative maxdiff < 0.02."""
    rng = np.random.RandomState(0)
    B, H, T, D = 1, 2, 256, 64
    q, k, v = (torch.from_numpy(rng.randn(B, H, T, D) * 0.3).bfloat16()
               for _ in range(3))

    def grads(*xs):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        loss = (TA.flash_attention(*leaves, None, True).float() ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(q, k, v), grads(q.float(), k.float(), v.float())):
        assert a.dtype == torch.bfloat16
        rel = (a.float() - b).abs().max() / b.abs().max().clamp(min=1e-6)
        assert rel < 0.02, rel



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_dq_takes_delta_from_out(dtype, causal):
    """``flash_attention_bwd_dq(delta=None, out=out)`` (what the
    backward calls; on the card the bfloat16 K2 computes delta itself)
    returns the dq of the same call with delta given and, beside it,
    delta = rowsum(dO * O) in float32, as ``_pallas_bwd`` takes it
    (``paddle_tpu/kernels/attention.py:566-569``); without ``out`` it
    raises."""
    q, k, v, g, mask = _inputs(2, 2, 40, 56, 16, False, seed=5)
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(x).to(dt) for x in (q, k, v, g))
    mask = torch.from_numpy(mask)
    out, lse = TA.flash_attention_ref(q, k, v, mask, causal)
    want = TA.flash_attention_delta(out, g)
    dq = TA.flash_attention_bwd_dq(q, k, v, mask, lse, want, g, causal)
    dq_own, delta = TA.flash_attention_bwd_dq(q, k, v, mask, lse, None, g,
                                              causal, out=out)
    assert torch.equal(dq_own, dq) and torch.equal(delta, want)
    ref = jnp.sum(jnp.asarray(g.float().numpy()) *
                  jnp.asarray(out.float().numpy()), axis=-1)
    np.testing.assert_allclose(delta.numpy(),
                               np.asarray(ref).reshape(delta.shape),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        TA.flash_attention_bwd_dq(q, k, v, mask, lse, None, g, causal)

def test_kernel_dtype_rules():
    """What the kernels take (checked before a launch): q, k, v and dO
    of one dtype, float32 or bfloat16; mask, lse and delta float32; the
    seed int32.  Anything else raises TypeError."""
    q = torch.zeros(1, 2, 8, 16)
    mask, row = torch.ones(1, 8), torch.zeros(2, 8)
    seed = torch.zeros(1, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        x = q.to(dt)
        TA._check_flash(x, x, x, mask, seed, lse=row, delta=row, do=x)
    bad = [
        ((q.half(),) * 3, {}),
        ((q.bfloat16(), q, q.bfloat16()), {}),
        ((q.bfloat16(),) * 3, dict(lse=row.bfloat16(), delta=row,
                                   do=q.bfloat16())),
        ((q.bfloat16(),) * 3, dict(lse=row, delta=row, do=q)),
    ]
    for (a, b, c), extra in bad:
        with pytest.raises(TypeError):
            TA._check_flash(a, b, c, mask, seed, **extra)
    with pytest.raises(TypeError):
        TA._check_flash(q, q, q, mask.bfloat16(), seed)
