"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine) and runs on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` because the suite's conftest sets JAX up, and the
card's machine needs no JAX: this file imports none).  ``chip_smoke.py``
checks the kernels at the main path's shapes; these cover the edges:
head dims that are not a multiple of 32, one-token blocks, the largest
head dim, many slots, context lengths past the block table, an empty
context, a launch on a side stream, and a table cut into context
splits (f32 and int8, against the plain version, bit-identical on a
rerun and on a side stream); for the flash kernels, odd
lengths, dropout and all-masked rows at head dims 32, 64 and 128,
cross lengths that are multiples of neither 32 nor 64, a bit-identical
backward on a rerun at the bench shape and a long causal backward
against SDPA's; for
the LSTM kernels, batches of one row, one row past K7's 32-row batch
group and past one 128-row chunk, a batch whose K7 groups take
turns, hidden sizes that are not a multiple of 4, 16 or 32, all-masked rows, steps where no row lives (forward and
backward), a bit-identical forward and backward on a rerun, the op's
reversed path and the shapes past what a card can hold; the same for the GRU kernels (K8a, K8b), with an
initial state and a bit-identical forward and backward on a rerun; K8b's
three launches, and for both steps where no row lives, a row masked
throughout, and batch groups that take turns, bit-identical on a rerun;
for the sparse kernels (K9, K10), an empty batch, every id the same, ids
at and past +-H, width 1, a table of 3 rows, skewed (Zipf) ids, bit for
bit against the plain versions, no fallback when the kernel library is
missing, and one sort a DeepFM step; for K9 also int32 ids, four tables
of widths 1, 3, 10 and 64, tables that start at row 1 and one float past
a 16-byte boundary, one and 33 ids, bit-identical on a rerun and on a
side stream, writing nothing past its outputs, and a batch whose
n * sum(D) passes 2^31; the raw current stream every wrapper passes
(``_build.current_stream``); for the ``lstm`` and ``gru`` ops, both sides of the
eligibility gate (an ineligible shape or dtype runs the plain scan, an
eligible one launches the kernel); for the int8 FC (K5), the int8
Transformer's four shapes at bucket 8, an odd shape and one row, every
act of the epilogue with a calibrated and a dynamic scale, no bias, a
side stream, every tile edge (M, N and K not multiples of the tile, one
row, byte loads), the K-major weight copy made once a weight, the tiles
the path's shapes take, and what it refuses; for ring attention (K11),
the ring over K1-K3 on four shards of one card against the plain ring,
all-masked pairs and dropout included, its exact launch counts, and the
same in bfloat16.  The flash kernels' bfloat16 mode (K1-K3 on bfloat16
q, k, v) is held against the plain bfloat16 version at the same edges:
head dims 32, 64, 128 and 40 (no 16-byte copies), odd lengths,
dropout, all-masked rows, cross lengths, a bit-identical rerun; the
kernels refuse float16 and mixed dtypes.  The bfloat16 K2/K3 (wgmma and
TMA) also at lengths past their tiles (333 x 200, 200 x 333, causal,
an all-masked row), at the ring's pair (B*H = 4, 4,096 keys; D = 32
and 128), with K2's own delta (against ``flash_attention_delta`` within
the float32 sum-order bound, bit-identical on a rerun), through
``flash_attention``'s backward with no torch delta reduction, and their
occupancy (one block an SM, shared memory within 232,448 bytes).  The
bfloat16 K1 (wgmma, TMA, two consumer warpgroups that pair causal
q-blocks i and n - 1 - i) alone: causal lengths with an odd middle
q-block and a ragged last one (320, 333 x 200, 200 x 333, dropout, an
all-masked row) at D = 64 and 128, fewer queries than a q-block, a q off
16 bytes and D = 40 (the producer's plain loads), the ring's pair
(4,096 x 4,096, D = 64 and 128, causal and not), a bit-identical rerun,
and its occupancy with no local (spill) bytes.
"""
import math

import pytest
import torch

from paddle_tpu_torch.core import registry as t_registry
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.kernels import rnn as R
from paddle_tpu_torch.kernels.quant import kv_quantize

pytestmark = pytest.mark.cuda

TOL = 1e-5      # float32 sums in two orders over at most 2,048 positions


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _inputs(dev, S, H, D, bs, MB, N, cls, quantized, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(N, bs, H, D, generator=g, device=dev)
    v = torch.randn(N, bs, H, D, generator=g, device=dev)
    q = torch.randn(S, H, D, generator=g, device=dev)
    bt = torch.randint(1, N, (S, MB), generator=g, device=dev,
                       dtype=torch.int32)
    out = dict(q=q, k_cache=k, v_cache=v, block_tables=bt,
               context_lens=torch.tensor(cls, dtype=torch.int32,
                                         device=dev))
    if quantized:
        ks = k.abs().amax(dim=(1, 3)).contiguous()
        vs = v.abs().amax(dim=(1, 3)).contiguous()
        out.update(k_cache=kv_quantize(k, ks[:, None, :]),
                   v_cache=kv_quantize(v, vs[:, None, :]),
                   k_scale=ks, v_scale=vs)
    return out


SHAPES = {   # S, H, D, bs, MB, N, context lens
    "full_width": (8, 8, 64, 16, 16, 129,
                   [1, 15, 16, 17, 256, 100, 200, 64]),
    "odd": (3, 2, 16, 4, 4, 13, [1, 7, 16]),
    "d48_bs1": (4, 4, 48, 1, 9, 40, [1, 2, 9, 5]),
    "d256": (2, 16, 256, 32, 2, 5, [64, 33]),
    "many_slots_d100": (64, 2, 100, 8, 3, 200,
                        [1 + (7 * i) % 24 for i in range(64)]),
    "past_the_table": (2, 1, 32, 4, 2, 5, [9, 100]),
}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_kernel_matches_plain_version(dev, shape, quantized):
    inp = _inputs(dev, *SHAPES[shape], quantized=quantized)
    before = A.decode_attention.launches
    got = A.decode_attention(**inp)
    torch.cuda.synchronize()
    assert A.decode_attention.launches == before + 1
    ref = A.paged_attention_ref(**inp)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= TOL


def test_empty_context_gives_zeros(dev):
    inp = _inputs(dev, 2, 2, 16, 4, 2, 5, [0, 3], quantized=False)
    got = A.decode_attention(**inp)
    ref = A.paged_attention_ref(**inp)
    assert torch.count_nonzero(got[0]).item() == 0
    assert (got[1] - ref[1]).abs().max().item() <= TOL


def test_launch_on_a_side_stream(dev):
    inp = _inputs(dev, *SHAPES["full_width"], quantized=True, seed=5)
    ref = A.decode_attention(**inp)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = A.decode_attention(**inp)
    side.synchronize()
    assert torch.equal(got, ref)


# tables long enough to be cut into context splits (2,048 positions of bs
# 16; on an H100, 8 splits of 256 positions in float32, 2 of 1,024 in
# int8): contexts of 1, bs, bs + 1, a multiple of the split, past the
# table and with a split boundary inside, at 2 heads and at 8
SPLIT_SHAPE = (6, 2, 64, 16, 128, 800)   # S, H, D, bs, MB, N
SPLIT_CLS = [1, 16, 17, 1024, 5000, 1300]
SPLIT_CASES = {"h2": (SPLIT_SHAPE, SPLIT_CLS),
               "h8": ((3, 8, 64, 16, 128, 400), [2000, 17, 1400])}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", list(SPLIT_CASES), ids=list(SPLIT_CASES))
def test_kernel_matches_plain_version_across_context_splits(dev, case,
                                                            quantized):
    shape, cls = SPLIT_CASES[case]
    S, H, D, bs, MB, N = shape
    assert A.decode_splits(S, H, D, bs, MB, quantized, dev) > 1
    inp = _inputs(dev, *shape, cls, quantized=quantized, seed=7)
    before = A.decode_attention.launches
    got = A.decode_attention(**inp)
    torch.cuda.synchronize()
    assert A.decode_attention.launches == before + 1
    ref = A.paged_attention_ref(**inp)
    assert (got - ref).abs().max().item() <= TOL


def test_context_splits_are_bit_identical_on_a_rerun_and_a_side_stream(dev):
    """The splits' partial states merge in a fixed order: a rerun, and a
    launch on another stream, give the same bits (f32 and int8)."""
    for quantized in (False, True):
        inp = _inputs(dev, *SPLIT_SHAPE, SPLIT_CLS, quantized=quantized,
                      seed=8)
        ref = A.decode_attention(**inp)
        again = A.decode_attention(**inp)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got = A.decode_attention(**inp)
        side.synchronize()
        assert torch.equal(again, ref) and torch.equal(got, ref)


def test_kernel_refuses_what_it_does_not_take(dev):
    inp = _inputs(dev, *SHAPES["odd"], quantized=False)
    with pytest.raises(TypeError):
        A.decode_attention(**dict(inp, q=inp["q"].double()))
    with pytest.raises(ValueError):
        A.decode_attention(**dict(
            inp, k_cache=inp["k_cache"].transpose(0, 1).contiguous()
            .transpose(0, 1)))
    with pytest.raises(ValueError):
        A.decode_attention(**dict(inp, block_tables=inp["block_tables"]
                                  .cpu()))


# ---------------------------------------------------------------------------
# flash attention (K1 forward, K2 dq, K3 dk/dv)
# ---------------------------------------------------------------------------

FWD_TOL = dict(rtol=1e-5, atol=2e-5)    # float32, different sum orders
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _flash_inputs(dev, B, H, Tq, Tk, D, seed=0, all_masked=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, Tq, D, generator=g, device=dev)
    k = torch.randn(B, H, Tk, D, generator=g, device=dev)
    v = torch.randn(B, H, Tk, D, generator=g, device=dev)
    do = torch.randn(B, H, Tq, D, generator=g, device=dev)
    mask = (torch.rand(B, Tk, generator=g, device=dev) > 0.25).float()
    mask[:, 0] = 1.0
    if all_masked:
        mask[-1] = 0.0
    return q, k, v, do, mask


def _flash_check(dev, B, H, Tq, Tk, D, causal, rate=0.0, seed=0,
                 all_masked=False):
    q, k, v, do, mask = _flash_inputs(dev, B, H, Tq, Tk, D, seed,
                                      all_masked)
    s = torch.tensor([12345 + seed], dtype=torch.int32, device=dev)
    n = (A.flash_attention_fwd.launches, A.flash_attention_bwd_dq.launches,
         A.flash_attention_bwd_dkv.launches)
    out, lse = A.flash_attention_fwd(q, k, v, mask, causal, None, rate, s)
    delta = A.flash_attention_delta(out, do)
    dq = A.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, causal,
                                  None, rate, s)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                                       causal, None, rate, s)
    torch.cuda.synchronize()
    assert (A.flash_attention_fwd.launches, A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == tuple(x + 1 for x in n)
    o_ref, l_ref = A.flash_attention_ref(q, k, v, mask, causal, None, rate, s)
    dq_r, dk_r, dv_r = A.flash_attention_bwd_ref(q, k, v, mask, o_ref, l_ref,
                                                 do, causal, None, rate, s)
    torch.testing.assert_close(out, o_ref, **FWD_TOL)
    torch.testing.assert_close(lse, l_ref, **FWD_TOL)
    for a, b in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    return dk, dv


@pytest.mark.parametrize("T", [1, 17, 255, 512])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_kernels_match_plain(dev, D, T):
    _flash_check(dev, 2, 3, T, T, D, causal=(T % 2 == 1), seed=D + T)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_dropout_and_all_masked_row(dev, causal, D):
    _flash_check(dev, 2, 2, 200, 200, D, causal, rate=0.1, seed=3,
                 all_masked=True)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_kernels_cross_length_causal(dev, rate):
    """Tk > Tq causal: keys wholly above the frontier get zero dk/dv."""
    dk, dv = _flash_check(dev, 1, 2, 128, 300, 48, causal=True, rate=rate,
                          seed=4)
    assert torch.count_nonzero(dk[:, :, 128:]) == 0
    assert torch.count_nonzero(dv[:, :, 128:]) == 0


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_at_the_bench_length_other_head_dims(dev, causal, D):
    _flash_check(dev, 4, 4, 256, 256, D, causal, rate=0.1, seed=D + 7)


@pytest.mark.parametrize("Tq,Tk", [(100, 77), (77, 100), (33, 65)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_odd_cross_lengths(dev, causal, Tq, Tk):
    """Lengths that are multiples of neither 32 nor 64 (K2/K3's tiles)."""
    _flash_check(dev, 2, 3, Tq, Tk, 64, causal, rate=0.1, seed=Tq + Tk)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_is_deterministic(dev, causal):
    """K2/K3 at the bench shape (B=32, H=8, T=256, D=64, dropout 0.1):
    a rerun on the same inputs gives the same bits (no atomics)."""
    q, k, v, do, mask = _flash_inputs(dev, 32, 8, 256, 256, 64, seed=8)
    s = torch.tensor([99], dtype=torch.int32, device=dev)
    out, lse = A.flash_attention_fwd(q, k, v, mask, causal, None, 0.1, s)
    delta = A.flash_attention_delta(out, do)

    def run():
        dq = A.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, causal,
                                      None, 0.1, s)
        return (dq, *A.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                                               causal, None, 0.1, s))
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# K2/K3 vs SDPA's backward at a long causal context: both
# float32-equivalent, summing up to 8192 rows or keys in other orders
# (chip_smoke.py's FLASH_LONG_GRAD_REL)
FLASH_LONG_GRAD_REL = 1e-4


def test_flash_backward_long_causal_matches_sdpa(dev):
    """B=1, H=2, T=8192, D=64, causal, no mask or dropout: dq, dk, dv
    from K1's lse through K2/K3 against SDPA's autograd backward with
    ``is_causal=True`` (the plain version's [T, T] scores are the
    cost this context avoids)."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(10)
    q, k, v, do = (torch.randn(1, 2, 8192, 64, generator=g, device=dev)
                   for _ in range(4))
    out, lse = A.flash_attention_fwd(q, k, v, None, True)
    delta = A.flash_attention_delta(out, do)
    dq = A.flash_attention_bwd_dq(q, k, v, None, lse, delta, do, True)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, None, lse, delta, do, True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, do)
    for a, b in zip((dq, dk, dv), ref):
        assert (a - b).abs().max() <= FLASH_LONG_GRAD_REL * b.abs().max()


def test_flash_autograd_on_a_side_stream(dev):
    q, k, v, do, mask = _flash_inputs(dev, 2, 2, 64, 64, 64, seed=6)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(A.flash_attention(*leaves, mask, True),
                              leaves, do)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = torch.autograd.grad(A.flash_attention(*leaves, mask, True),
                                  leaves, do)
    side.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# bfloat16: the kernel rounds p against its own 64-key tile's running
# max, the plain version against the reference's logical tile's, so a p
# (and then out) may round to the neighbouring bfloat16: out within one
# rounding of the largest value, 2^-7 * max|ref|.  The LSE within 1e-4,
# plus, where the mass sums the rounded p (the ones lane, D < 128 and no
# dropout), each p's half-ulp rounding in both versions, 2^-8 / ln 2.
# K2/K3 take the plain version's own lse and delta, so they round where
# it rounds and differ only in the order of float32 sums: a ds rounds
# the other way now and then, within 2^-7 * max|ref| again.  Where a
# row's mass sits on one key (T=1) dp - delta cancels, and ds, dq and dk
# are the float32 noise of two D-term sums, ~D * 2^-24 of |dO||v|: an
# absolute floor of 1e-5 covers it.
BF16_REL = 2.0 ** -7
BF16_ATOL = 1e-5
BF16_LSE_ATOL = 1e-4


def _bf16_close(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max()
    assert err <= BF16_REL * ref.float().abs().max() + BF16_ATOL, err.item()


def _flash_check_bf16(dev, B, H, Tq, Tk, D, causal, rate=0.0, seed=0,
                      all_masked=False):
    q, k, v, do, mask = (x.bfloat16() if x.dim() == 4 else x
                         for x in _flash_inputs(dev, B, H, Tq, Tk, D, seed,
                                                all_masked))
    s = torch.tensor([12345 + seed], dtype=torch.int32, device=dev)
    n = (A.flash_attention_fwd.launches, A.flash_attention_bwd_dq.launches,
         A.flash_attention_bwd_dkv.launches)
    out, lse = A.flash_attention_fwd(q, k, v, mask, causal, None, rate, s)
    o_ref, l_ref = A.flash_attention_ref(q, k, v, mask, causal, None, rate, s)
    delta = A.flash_attention_delta(o_ref, do)
    dq = A.flash_attention_bwd_dq(q, k, v, mask, l_ref, delta, do, causal,
                                  None, rate, s)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, mask, l_ref, delta, do,
                                       causal, None, rate, s)
    torch.cuda.synchronize()
    assert (A.flash_attention_fwd.launches, A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == tuple(x + 1 for x in n)
    dq_r, dk_r, dv_r = A.flash_attention_bwd_ref(q, k, v, mask, o_ref, l_ref,
                                                 do, causal, None, rate, s)
    assert lse.dtype == torch.float32
    lse_tol = BF16_LSE_ATOL + (2.0 ** -8 / math.log(2.0)
                               if D < 128 and rate == 0.0 else 0.0)
    assert (lse - l_ref).abs().max() <= lse_tol
    for a, b in ((out, o_ref), (dq, dq_r), (dk, dk_r), (dv, dv_r)):
        _bf16_close(a, b)
    return dk, dv


@pytest.mark.parametrize("T", [1, 17, 255, 512])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_bf16_kernels_match_plain(dev, D, T):
    _flash_check_bf16(dev, 2, 3, T, T, D, causal=(T % 2 == 1), seed=D + T)


@pytest.mark.parametrize("D", [32, 40, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_kernels_dropout_and_all_masked_row(dev, causal, D):
    _flash_check_bf16(dev, 2, 2, 200, 200, D, causal, rate=0.1, seed=3,
                      all_masked=True)


@pytest.mark.parametrize("Tq,Tk", [(100, 77), (77, 100), (128, 300)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_kernels_odd_cross_lengths(dev, causal, Tq, Tk):
    dk, dv = _flash_check_bf16(dev, 2, 3, Tq, Tk, 64, causal, rate=0.1,
                               seed=Tq + Tk)
    if causal and Tk > Tq:   # keys wholly above the frontier
        assert torch.count_nonzero(dk[:, :, 128:]) == 0
        assert torch.count_nonzero(dv[:, :, 128:]) == 0


def test_flash_bf16_backward_is_deterministic(dev):
    q, k, v, do, mask = (x.bfloat16() if x.dim() == 4 else x
                         for x in _flash_inputs(dev, 32, 8, 256, 256, 64,
                                                seed=8))
    s = torch.tensor([99], dtype=torch.int32, device=dev)
    out, lse = A.flash_attention_fwd(q, k, v, mask, True, None, 0.1, s)
    delta = A.flash_attention_delta(out, do)

    def run():
        dq = A.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, True,
                                      None, 0.1, s)
        return (dq, *A.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do,
                                               True, None, 0.1, s))
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)



@pytest.mark.parametrize("Tq,Tk", [(333, 200), (200, 333)])
def test_flash_bf16_backward_past_its_tiles(dev, Tq, Tk):
    """K2/K3 (wgmma, TMA) at lengths that are multiples of neither their
    64-row tiles nor their 128-row blocks, Tq > Tk and Tq < Tk, causal,
    dropout, an all-masked row."""
    _flash_check_bf16(dev, 2, 3, Tq, Tk, 64, True, rate=0.1, seed=Tq,
                      all_masked=True)


@pytest.mark.parametrize("D", [32, 128])
def test_flash_bf16_backward_at_the_ring_pair(dev, D):
    """The bf16 ring's pair: B*H = 4, 4,096 queries and keys (128
    blocks of 128 rows fill the card's 132 SMs once), ragged keys."""
    _flash_check_bf16(dev, 1, 4, 4096, 4096, D, False, seed=D)


def _delta_bound(out, do):
    # two float32 sums of D products in other orders: D * 2^-23 * the
    # largest row's sum of |dO * O|
    return out.shape[-1] * 2.0 ** -23 * (out.float() * do.float()).abs() \
        .sum(-1).max().item()


@pytest.mark.parametrize("D,Tq,causal", [(64, 256, True), (128, 333, False),
                                          (40, 77, True)])
def test_flash_bf16_k2_computes_delta(dev, D, Tq, causal):
    """With delta=None K2 computes rowsum(dO * O) for its rows (one
    launch): it matches flash_attention_delta within the float32
    sum-order bound, its dq matches the plain version, and a rerun is bit
    for bit."""
    q, k, v, do, mask = (x.bfloat16() if x.dim() == 4 else x
                         for x in _flash_inputs(dev, 2, 3, Tq, Tq, D, seed=D))
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    out, lse = A.flash_attention_fwd(q, k, v, mask, causal, None, 0.1, s)
    n = A.flash_attention_bwd_dq.launches
    dq, delta = A.flash_attention_bwd_dq(q, k, v, mask, lse, None, do, causal,
                                         None, 0.1, s, out=out)
    again = A.flash_attention_bwd_dq(q, k, v, mask, lse, None, do, causal,
                                     None, 0.1, s, out=out)
    torch.cuda.synchronize()
    assert A.flash_attention_bwd_dq.launches == n + 2
    want = A.flash_attention_delta(out, do)
    assert delta.dtype == torch.float32 and delta.shape == want.shape
    assert (delta - want).abs().max().item() <= _delta_bound(out, do)
    assert torch.equal(again[0], dq) and torch.equal(again[1], delta)
    dq_r = A._bwd_ref(q, k, v, mask, lse, want, do, causal, D ** -0.5, 0.1, s,
                      True, False)[0]
    _bf16_close(dq, dq_r)


def test_flash_bf16_autograd_takes_no_torch_delta(dev, monkeypatch):
    """FlashAttentionFn's bf16 backward on the card runs K2 (with its own
    delta) and K3, and no torch reduction for delta: with
    flash_attention_delta made to raise, the gradients still match the
    plain version's."""
    q, k, v, do, mask = (x.bfloat16() if x.dim() == 4 else x
                         for x in _flash_inputs(dev, 2, 2, 200, 200, 64,
                                                seed=4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = A.flash_attention(*leaves, mask, True)
    o_ref, l_ref = A.flash_attention_ref(q, k, v, mask, True)
    want = A.flash_attention_bwd_ref(q, k, v, mask, o_ref, l_ref, do, True)

    def no_delta(*a, **kw):
        raise AssertionError("torch delta reduction on the card")
    monkeypatch.setattr(A, "flash_attention_delta", no_delta)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for a, b in zip(grads, want):
        _bf16_close(a, b)


def test_flash_bf16_backward_occupancy(dev):
    """K2/K3 launch one block of two consumer warpgroups and a producer
    warp an SM, within the 232,448 bytes of shared memory a block may
    have, at every head-dim width."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    fn = _build.load("flash_attn_bwd_bf16").flash_attn_bwd_bf16_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for D in (32, 64, 128):
        out = (ctypes.c_int * 8)()
        assert fn(D, 0, out) == 0
        for i in (0, 4):
            assert out[i + 1] + out[i + 2] <= 232448
            assert out[i + 3] == 1

def _fwd_check_bf16(dev, q, k, v, mask, causal, rate, seed=0):
    """K1 bf16 alone against the plain bf16 version: out within one
    rounding of max|ref|, the LSE within BF16_LSE_ATOL (plus the ones
    lane's share), one launch; returns (out, lse)."""
    s = torch.tensor([777 + seed], dtype=torch.int32, device=dev)
    n = A.flash_attention_fwd.launches
    out, lse = A.flash_attention_fwd(q, k, v, mask, causal, None, rate, s)
    torch.cuda.synchronize()
    assert A.flash_attention_fwd.launches == n + 1
    o_ref, l_ref = A.flash_attention_ref(q, k, v, mask, causal, None, rate, s)
    D = q.shape[-1]
    lse_tol = BF16_LSE_ATOL + (2.0 ** -8 / math.log(2.0)
                               if D < 128 and rate == 0.0 else 0.0)
    assert (lse - l_ref).abs().max() <= lse_tol
    _bf16_close(out, o_ref)
    return out, lse


def _bf16_qkv(dev, B, H, Tq, Tk, D, seed, all_masked=False):
    q, k, v, _, mask = _flash_inputs(dev, B, H, Tq, Tk, D, seed, all_masked)
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), mask


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Tq,Tk", [(320, 320), (333, 200), (200, 333)])
def test_flash_bf16_forward_pairs_causal_q_blocks(dev, Tq, Tk, D):
    """Causal K1 bf16 pairs q-blocks i and n - 1 - i of 64 rows in a
    block: Tq = 320 has an odd middle q-block (one consumer idle), 333 a
    ragged last one; cross lengths both ways, dropout, an all-masked
    row."""
    q, k, v, mask = _bf16_qkv(dev, 2, 3, Tq, Tk, D, seed=Tq + D,
                              all_masked=True)
    _fwd_check_bf16(dev, q, k, v, mask, True, 0.1, seed=Tq)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq", [1, 40, 63])
def test_flash_bf16_forward_fewer_queries_than_a_q_block(dev, Tq, causal):
    """Tq < 64: one q-block, the second consumer idle."""
    q, k, v, mask = _bf16_qkv(dev, 2, 3, Tq, 100, 64, seed=Tq)
    _fwd_check_bf16(dev, q, k, v, mask, causal, 0.0)
    _fwd_check_bf16(dev, q, k, v, mask, causal, 0.1, seed=1)


@pytest.mark.parametrize("D", [40, 64])
def test_flash_bf16_forward_where_tma_cannot_describe_the_tensors(dev, D):
    """A q that starts 2 bytes past a 16-byte boundary (a view into a
    larger buffer, contiguous) and D = 40 (a row stride that is not a
    multiple of 16 bytes) take the producer's plain loads into the same
    swizzled layout."""
    q, k, v, mask = _bf16_qkv(dev, 2, 2, 200, 200, D, seed=D, all_masked=True)
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    q_off = buf[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 != 0
    for causal, rate in ((False, 0.1), (True, 0.0)):
        got, lse = _fwd_check_bf16(dev, q_off, k, v, mask, causal, rate)
        want, want_lse = A.flash_attention_fwd(
            q, k, v, mask, causal, None, rate,
            torch.tensor([777], dtype=torch.int32, device=dev))
        if D % 8 == 0:   # q by TMA stages the same tiles: the same bits
            assert torch.equal(got, want) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_forward_at_the_ring_pair(dev, D, causal):
    """The bf16 ring's pair (B*H = 4, 4,096 queries and keys, ragged
    keys): an off-diagonal hop (dropout 0.1) and the causal diagonal (rate
    0), whose pairing halves its blocks' work."""
    q, k, v, mask = _bf16_qkv(dev, 1, 4, 4096, 4096, D, seed=D)
    lens = torch.tensor([3 * 4096 // 4], device=dev)
    mask = (torch.arange(4096, device=dev)[None] < lens[:, None]).float()
    _fwd_check_bf16(dev, q, k, v, mask, causal, 0.0 if causal else 0.1)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_forward_is_deterministic(dev, causal):
    """K1 bf16 at the bench shape (B=32, H=8, T=256, D=64, dropout 0.1):
    a rerun gives the same bits."""
    q, k, v, mask = _bf16_qkv(dev, 32, 8, 256, 256, 64, seed=9)
    s = torch.tensor([5], dtype=torch.int32, device=dev)
    first = A.flash_attention_fwd(q, k, v, mask, causal, None, 0.1, s)
    second = A.flash_attention_fwd(q, k, v, mask, causal, None, 0.1, s)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_flash_bf16_forward_occupancy(dev):
    """K1 bf16 (wgmma, TMA) launches one block of two consumer
    warpgroups and a producer an SM, within the 232,448 bytes of shared
    memory a block may have, and spills nothing (no local bytes), at every
    head-dim width, with and without dropout."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    fn = _build.load("flash_attn_fwd_bf16").flash_attn_fwd_bf16_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for D in (32, 64, 96, 128):
        out = (ctypes.c_int * 10)()
        assert fn(D, 0, out) == 0
        for i in (0, 5):
            assert out[i + 1] + out[i + 2] <= 232448
            assert out[i + 3] == 1
            assert out[i + 4] == 0, f"D={D}: {out[i + 4]} local bytes"


def test_flash_kernels_refuse_what_they_do_not_take(dev):
    q, k, v, do, mask = _flash_inputs(dev, 1, 2, 16, 16, 32)
    with pytest.raises(TypeError):
        A.flash_attention_fwd(q.half(), k.half(), v.half(), mask)
    with pytest.raises(TypeError):
        A.flash_attention_fwd(q.bfloat16(), k, v.bfloat16(), mask)
    with pytest.raises(TypeError):
        A.flash_attention_bwd_dq(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 mask, torch.zeros(2, 16, device=dev),
                                 torch.zeros(2, 16, device=dev), do)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q.transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 1, 4, 160, device=dev)
        A.flash_attention_fwd(big, big, big)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q, k, v, mask.cpu())


# ---------------------------------------------------------------------------
# fused LSTM (K6 forward, K7 backward)
# ---------------------------------------------------------------------------

# forward: float32 sums over H in another order, carried through T steps
# (1e-4 absolute for a float32 recurrence); backward: max|d| <=
# LSTM_GRAD_REL * max|ref| (sums over B*T for dW)
LSTM_GRAD_REL = 1e-3
# K6 and K7 multiply in split TF32 and are held tighter (chip_smoke.py's
# K6_FWD_ATOL, K7_GRAD_REL): one TF32 product a term would pass
# LSTM_GRAD_REL, and miss the forward's 1e-4 by a slim margin only
K6_FWD_ATOL = 1e-5
K7_GRAD_REL = 1.5e-4


def _lstm_inputs(dev, B, T, H, seed=0, masked=True, all_masked=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    xproj = torch.randn(B, T, 4 * H, generator=g, device=dev) * 0.5
    w = torch.randn(H, 4 * H, generator=g, device=dev) / H ** 0.5
    h0 = torch.randn(B, H, generator=g, device=dev) * 0.1
    c0 = torch.randn(B, H, generator=g, device=dev) * 0.1
    lens = (torch.randint(1, T + 1, (B,), generator=g, device=dev) if masked
            else torch.full((B,), T, device=dev))
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    if all_masked:
        mask[-1] = 0.0
    dhs = torch.randn(B, T, H, generator=g, device=dev)
    dcs = torch.randn(B, T, H, generator=g, device=dev)
    return (xproj, w, h0, c0, mask), dhs, dcs


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


LSTM_SHAPES = {   # B, T, H
    "b1_t1_h8": (1, 1, 8),
    "b3_t17_h40": (3, 17, 40),
    "b33_t5_h40": (33, 5, 40),
    "b5_t6_h37": (5, 6, 37),
    "b200_t9_h40": (200, 9, 40),
    "b3_t128_h512": (3, 128, 512),
    "b128_t128_h512": (128, 128, 512),
    # more of K7's batch groups than the card holds side by side
    "b1024_t3_h512": (1024, 3, 512),
}


@pytest.mark.parametrize("masked", [True, False], ids=["ragged", "full"])
@pytest.mark.parametrize("shape", list(LSTM_SHAPES), ids=list(LSTM_SHAPES))
def test_lstm_kernels_match_plain(dev, shape, masked):
    B, T, H = LSTM_SHAPES[shape]
    args, dhs, dcs = _lstm_inputs(dev, B, T, H, seed=B + T + H,
                                  masked=masked, all_masked=masked)
    n = (R.lstm_fused.launches, R.lstm_fused_grad.launches)
    hs, cs = R.lstm_fused(*args)
    grads = R.lstm_fused_grad(*args, hs, cs, dhs, dcs)
    torch.cuda.synchronize()
    assert (R.lstm_fused.launches, R.lstm_fused_grad.launches) == \
        (n[0] + 1, n[1] + 1)
    hs_r, cs_r = R.lstm_ref(*args)
    assert (hs - hs_r).abs().max().item() <= K6_FWD_ATOL
    assert (cs - cs_r).abs().max().item() <= K6_FWD_ATOL
    ref = R.lstm_grad_ref(*args, hs, cs, dhs, dcs)
    for name, a, b in zip(("dxproj", "dw", "dh0", "dc0"), grads, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel(a, b) <= K7_GRAD_REL, name
    if masked:   # the all-masked row keeps h0 and takes no gate gradient
        assert torch.equal(hs[-1], args[2][-1].expand(T, H))
        assert torch.count_nonzero(grads[0][-1]).item() == 0


def test_lstm_backward_with_steps_where_no_row_lives(dev):
    """Steps at which every row is masked (K7's batch groups skip their
    barrier and product there) in the middle and at the end, at the
    bench's width: the carries pass through them unchanged."""
    args, dhs, dcs = _lstm_inputs(dev, 64, 16, 512, seed=17, masked=False)
    mask = args[4]
    mask[:, 5:9] = 0.0
    mask[:, 13:] = 0.0
    hs, cs = R.lstm_fused(*args)
    grads = R.lstm_fused_grad(*args, hs, cs, dhs, dcs)
    torch.cuda.synchronize()
    ref = R.lstm_grad_ref(*args, hs, cs, dhs, dcs)
    for name, a, b in zip(("dxproj", "dw", "dh0", "dc0"), grads, ref):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= K7_GRAD_REL, name
    assert torch.count_nonzero(grads[0][:, 5:9]).item() == 0


def test_lstm_forward_with_steps_where_no_row_lives(dev):
    """K6 at the bench's width with steps at which every row is masked,
    in the middle and at the end (its batch groups skip their barrier and
    product there): h and c pass through them unchanged."""
    args, _, _ = _lstm_inputs(dev, 64, 16, 512, seed=17, masked=False)
    mask = args[4]
    mask[:, 5:9] = 0.0
    mask[:, 13:] = 0.0
    hs, cs = R.lstm_fused(*args)
    torch.cuda.synchronize()
    hs_r, cs_r = R.lstm_ref(*args)
    assert (hs - hs_r).abs().max().item() <= K6_FWD_ATOL
    assert (cs - cs_r).abs().max().item() <= K6_FWD_ATOL
    for x in (hs, cs):
        assert torch.equal(x[:, 5:9], x[:, 4:5].expand(-1, 4, -1))
        assert torch.equal(x[:, 13:], x[:, 12:13].expand(-1, 3, -1))


def test_lstm_forward_where_batch_groups_take_turns(dev):
    """B=1024 at H=512: more of K6's batch groups than the card holds
    side by side, so they take turns; ragged lengths, and a rerun gives
    the same bits."""
    args, _, _ = _lstm_inputs(dev, 1024, 8, 512, seed=19)
    hs, cs = R.lstm_fused(*args)
    hs2, cs2 = R.lstm_fused(*args)
    torch.cuda.synchronize()
    hs_r, cs_r = R.lstm_ref(*args)
    assert (hs - hs_r).abs().max().item() <= K6_FWD_ATOL
    assert (cs - cs_r).abs().max().item() <= K6_FWD_ATOL
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)


# K6 past H=512, at 8 units a block (K7 does not take these widths)
LSTM_WIDE_SHAPES = {   # B, T, H
    "b8_t5_h640": (8, 5, 640),
    "b128_t16_h1024": (128, 16, 1024),
    "b3_t7_h1056": (3, 7, 1056),
    "b200_t4_h520": (200, 4, 520),
}


@pytest.mark.parametrize("shape", list(LSTM_WIDE_SHAPES),
                         ids=list(LSTM_WIDE_SHAPES))
def test_lstm_forward_past_h512(dev, shape):
    """K6 at widths whose 16 units' W no longer fits a block, ragged with
    an all-masked row: the gate takes them on the card (ceil(H/8) blocks),
    the kernel matches its plain version and a rerun gives the same
    bits."""
    B, T, H = LSTM_WIDE_SHAPES[shape]
    cap = R.kernel_capacity("lstm_fwd", B, H, dev)
    assert R.lstm_eligible(B, T, H, torch.float32, cap)
    args, _, _ = _lstm_inputs(dev, B, T, H, seed=B + T + H, all_masked=True)
    hs, cs = R.lstm_fused(*args)
    hs2, cs2 = R.lstm_fused(*args)
    torch.cuda.synchronize()
    hs_r, cs_r = R.lstm_ref(*args)
    assert (hs - hs_r).abs().max().item() <= K6_FWD_ATOL
    assert (cs - cs_r).abs().max().item() <= K6_FWD_ATOL
    assert torch.equal(hs[-1], args[2][-1].expand(T, H))
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)


def test_lstm_forward_is_deterministic(dev):
    """K6 at the bench shape with ragged lengths: a rerun gives the same
    bits (the K-slices' partial sums meet in a fixed order)."""
    args, _, _ = _lstm_inputs(dev, 128, 128, 512, seed=23)
    a = R.lstm_fused(*args)
    b = R.lstm_fused(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_lstm_backward_is_deterministic(dev):
    args, dhs, dcs = _lstm_inputs(dev, 64, 32, 128, seed=9)
    hs, cs = R.lstm_fused(*args)
    a = R.lstm_fused_grad(*args, hs, cs, dhs, dcs)
    b = R.lstm_fused_grad(*args, hs, cs, dhs, dcs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_op_kernel_path_matches_plain_scan(dev, reverse):
    """The op and its grad rule on the card: K6/K7 (attr absent) against
    the plain scan (use_pallas_kernel False), with ragged lengths, the
    whole-axis flip of is_reverse and a LastH cotangent."""
    B, T, H = 6, 11, 40
    args, dhs, _ = _lstm_inputs(dev, B, T, H, seed=21)
    xproj, w = args[0], args[1]
    lens = torch.tensor([11, 1, 5, 0, 7, 3], dtype=torch.int32, device=dev)
    ins = {"Input": [xproj], "Weight": [w], "SeqLen": [lens]}
    op = t_registry.get("lstm")
    outs = {}
    for name, attrs in (("kernel", {"is_reverse": reverse}),
                        ("plain", {"is_reverse": reverse,
                                   "use_pallas_kernel": False})):
        fwd = op.lower(None, ins, attrs)
        gin = {**ins, **fwd, "Hidden@GRAD": [dhs],
               "LastH@GRAD": [dhs[:, 0] * 0.5]}
        outs[name] = (fwd, op.grad(None, gin, attrs))
    (fk, gk), (fp, gp) = outs["kernel"], outs["plain"]
    for slot in ("Hidden", "Cell", "LastH", "LastC"):
        assert (fk[slot][0] - fp[slot][0]).abs().max().item() <= \
            K6_FWD_ATOL, slot
    for slot in ("Input@GRAD", "Weight@GRAD"):
        assert _rel(gk[slot][0], gp[slot][0]) <= LSTM_GRAD_REL, slot


def test_lstm_kernels_on_a_side_stream(dev):
    args, dhs, dcs = _lstm_inputs(dev, 16, 20, 64, seed=13)
    hs, cs = R.lstm_fused(*args)
    grads = R.lstm_fused_grad(*args, hs, cs, dhs, dcs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hs2, cs2 = R.lstm_fused(*args)
        grads2 = R.lstm_fused_grad(*args, hs2, cs2, dhs, dcs)
    side.synchronize()
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)


def test_lstm_kernels_refuse_what_they_do_not_take(dev):
    args, dhs, dcs = _lstm_inputs(dev, 2, 3, 8)
    xproj, w, h0, c0, mask = args
    with pytest.raises(TypeError):
        R.lstm_fused(xproj.double(), w, h0, c0, mask)
    with pytest.raises(ValueError):
        R.lstm_fused(xproj.transpose(0, 1).contiguous().transpose(0, 1), w,
                     h0, c0, mask)
    with pytest.raises(ValueError):
        R.lstm_fused(xproj, w, h0, c0, mask.cpu())
    with pytest.raises(ValueError):
        R.lstm_fused(xproj, w[:, :8], h0, c0, mask)
    hs, cs = R.lstm_fused(*args)
    with pytest.raises(ValueError):
        R.lstm_fused_grad(*args, hs, cs, dhs.transpose(1, 2), dcs)
    # past the shared memory or the co-residency a card offers
    big, _, _ = _lstm_inputs(dev, 1, 1, 2048)
    with pytest.raises(ValueError, match="resident|shared memory"):
        R.lstm_fused(*big)
    zeros = torch.zeros(1, 1, 2048, device=dev)
    with pytest.raises(ValueError, match="resident|shared memory"):
        R.lstm_fused_grad(*big, zeros, zeros, zeros, zeros)


# K8a and K8b multiply in split TF32 and are held to their own
# chip_smoke.py bounds, K8A_FWD_ATOL and K8B_GRAD_REL: one TF32 product a
# term would miss the forward's 1e-4 by a slim margin only and pass
# LSTM_GRAD_REL
K8A_FWD_ATOL = 1e-5
K8B_GRAD_REL = 2e-5
# K8b's three launches; profiler event names contain these
K8B_LAUNCHES = ("gru_bwd_gates", "gru_bwd_recurrence", "gru_bwd_dw")
GRU_SHAPES = {   # B, T, H
    "b1_t1_h8": (1, 1, 8),
    "b5_t7_h96": (5, 7, 96),
    "b5_t6_h37": (5, 6, 37),
    "b200_t9_h40": (200, 9, 40),
    "b64_t32_h256": (64, 32, 256),
    "b3_t64_h512": (3, 64, 512),
    # more of K8a's and K8b's batch groups than the card holds side by side
    "b4096_t3_h256": (4096, 3, 256),
    # K8a and K8b at 16 units a block at their widest, then 8 units a
    # block past H=896, up to the widest the card holds (132 blocks)
    "b8_t5_h896": (8, 5, 896),
    "b16_t8_h1024": (16, 8, 1024),
    "b8_t6_h1056": (8, 6, 1056),
}


def _gru_inputs(dev, B, T, H, seed=0, masked=True, all_masked=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    xproj = torch.randn(B, T, 3 * H, generator=g, device=dev) * 0.5
    w = torch.randn(H, 3 * H, generator=g, device=dev) / H ** 0.5
    h0 = torch.randn(B, H, generator=g, device=dev) * 0.1
    lens = (torch.randint(1, T + 1, (B,), generator=g, device=dev) if masked
            else torch.full((B,), T, device=dev))
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    if all_masked:
        mask[-1] = 0.0
    dhs = torch.randn(B, T, H, generator=g, device=dev)
    return (xproj, w, h0, mask), dhs


@pytest.mark.parametrize("masked", [True, False], ids=["ragged", "full"])
@pytest.mark.parametrize("shape", list(GRU_SHAPES), ids=list(GRU_SHAPES))
def test_gru_kernels_match_plain(dev, shape, masked):
    B, T, H = GRU_SHAPES[shape]
    args, dhs = _gru_inputs(dev, B, T, H, seed=B + T + H, masked=masked,
                            all_masked=masked)
    n = (R.gru_fused.launches, R.gru_fused_grad.launches)
    hs = R.gru_fused(*args)
    grads = R.gru_fused_grad(*args, hs, dhs)
    torch.cuda.synchronize()
    assert (R.gru_fused.launches, R.gru_fused_grad.launches) == \
        (n[0] + 1, n[1] + 1)
    assert (hs - R.gru_ref(*args)).abs().max().item() <= K8A_FWD_ATOL
    assert torch.equal(hs, R.gru_fused(*args))   # bit-identical on a rerun
    ref = R.gru_grad_ref(*args, hs, dhs)
    for name, a, b in zip(("dxproj", "dw", "dh0"), grads, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel(a, b) <= K8B_GRAD_REL, name
    if masked:   # the all-masked row keeps h0 and takes no gate gradient
        assert torch.equal(hs[-1], args[2][-1].expand(T, H))
        assert torch.count_nonzero(grads[0][-1]).item() == 0


def test_gru_backward_runs_as_three_launches(dev):
    """One call of K8b is one launch of each of its three kernels: the
    gates, the recurrence and dw (and a memset of its counters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args, dhs = _gru_inputs(dev, 64, 32, 256, seed=12)
    hs = R.gru_fused(*args)
    R.gru_fused_grad(*args, hs, dhs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        R.gru_fused_grad(*args, hs, dhs)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    for k in K8B_LAUNCHES:
        assert sum(k in n for n in names) == 1, (k, names)


def test_gru_backward_with_steps_where_no_row_lives(dev):
    """Steps at which every row is masked (K8b's batch groups skip both
    barriers and products there) in the middle and at the end, and a row
    masked throughout: the carry passes through them unchanged."""
    args, dhs = _gru_inputs(dev, 64, 16, 256, seed=17, masked=False)
    mask = args[3]
    mask[:, 5:9] = 0.0
    mask[:, 13:] = 0.0
    mask[7] = 0.0
    hs = R.gru_fused(*args)
    grads = R.gru_fused_grad(*args, hs, dhs)
    torch.cuda.synchronize()
    ref = R.gru_grad_ref(*args, hs, dhs)
    for name, a, b in zip(("dxproj", "dw", "dh0"), grads, ref):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= K8B_GRAD_REL, name
    assert torch.count_nonzero(grads[0][:, 5:9]).item() == 0
    assert torch.count_nonzero(grads[0][7]).item() == 0


def test_gru_forward_with_steps_where_no_row_lives(dev):
    """Steps at which every row is masked (K8a's batch groups skip both
    products and both waits there) in the middle and at the end, and a
    row masked throughout: h passes through them unchanged."""
    args, _ = _gru_inputs(dev, 64, 16, 256, seed=18, masked=False)
    mask = args[3]
    mask[:, 5:9] = 0.0
    mask[:, 13:] = 0.0
    mask[7] = 0.0
    hs = R.gru_fused(*args)
    torch.cuda.synchronize()
    assert (hs - R.gru_ref(*args)).abs().max().item() <= K8A_FWD_ATOL
    assert torch.equal(hs[:, 5:9], hs[:, 4:5].expand(-1, 4, -1))
    assert torch.equal(hs[7], args[2][7].expand(16, 256))


def test_gru_forward_where_batch_groups_take_turns_is_deterministic(dev):
    """More of K8a's batch groups than the card holds side by side (they
    take turns in their slots), ragged: bit-identical on a rerun."""
    args, _ = _gru_inputs(dev, 4096, 6, 256, seed=20)
    a = R.gru_fused(*args)
    b = R.gru_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (a - R.gru_ref(*args)).abs().max().item() <= K8A_FWD_ATOL


def test_gru_backward_where_batch_groups_take_turns_is_deterministic(dev):
    """More batch groups than the card holds side by side (they take
    turns in their slots), ragged: bit-identical on a rerun."""
    args, dhs = _gru_inputs(dev, 4096, 4, 256, seed=19)
    hs = R.gru_fused(*args)
    a = R.gru_fused_grad(*args, hs, dhs)
    b = R.gru_fused_grad(*args, hs, dhs)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, R.gru_grad_ref(*args, hs, dhs)):
        assert torch.equal(x, y)
        assert _rel(x, z) <= K8B_GRAD_REL


def test_gru_backward_dw_lists_its_chunks_a_window_at_a_time(dev):
    """B*T = 163,840 rows (5,120 chunks of 32, over 1,024 a split at
    H=64): K8b's dw lists each split's live chunks a window of 1,024 at a
    time in a fixed amount of shared memory; within K8B_GRAD_REL of the
    plain backward and bit-identical on a rerun."""
    args, dhs = _gru_inputs(dev, 4096, 40, 64, seed=23)
    hs = R.gru_fused(*args)
    a = R.gru_fused_grad(*args, hs, dhs)
    b = R.gru_fused_grad(*args, hs, dhs)
    torch.cuda.synchronize()
    for name, x, y, z in zip(("dxproj", "dw", "dh0"), a, b,
                             R.gru_grad_ref(*args, hs, dhs)):
        assert torch.equal(x, y), name
        assert _rel(x, z) <= K8B_GRAD_REL, name


def test_gru_kernels_are_deterministic(dev):
    args, dhs = _gru_inputs(dev, 64, 32, 256, seed=9)
    hs = R.gru_fused(*args)
    assert torch.equal(hs, R.gru_fused(*args))
    a = R.gru_fused_grad(*args, hs, dhs)
    b = R.gru_fused_grad(*args, hs, dhs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_op_kernel_path_matches_plain_scan(dev, reverse, h0):
    """The op and its grad rule on the card: K8a/K8b (attr absent)
    against the plain scan (use_pallas_kernel False), with ragged
    lengths (one of them 0), the whole-axis flip of is_reverse, an
    optional H0 and a LastH cotangent."""
    B, T, H = 6, 11, 40
    args, dhs = _gru_inputs(dev, B, T, H, seed=22)
    xproj, w = args[0], args[1]
    lens = torch.tensor([11, 1, 5, 0, 7, 3], dtype=torch.int32, device=dev)
    ins = {"Input": [xproj], "Weight": [w], "SeqLen": [lens]}
    if h0:
        ins["H0"] = [args[2]]
    op = t_registry.get("gru")
    outs = {}
    for name, attrs in (("kernel", {"is_reverse": reverse}),
                        ("plain", {"is_reverse": reverse,
                                   "use_pallas_kernel": False})):
        fwd = op.lower(None, ins, attrs)
        gin = {**ins, **fwd, "Hidden@GRAD": [dhs],
               "LastH@GRAD": [dhs[:, 0] * 0.5]}
        outs[name] = (fwd, op.grad(None, gin, attrs))
    (fk, gk), (fp, gp) = outs["kernel"], outs["plain"]
    for slot in ("Hidden", "LastH"):
        assert (fk[slot][0] - fp[slot][0]).abs().max().item() <= \
            K8A_FWD_ATOL, slot
    assert sorted(gk) == sorted(gp)
    assert ("H0@GRAD" in gk) == h0
    for slot in gk:
        assert _rel(gk[slot][0], gp[slot][0]) <= K8B_GRAD_REL, slot


def test_gru_kernels_on_a_side_stream(dev):
    args, dhs = _gru_inputs(dev, 16, 20, 64, seed=13)
    hs = R.gru_fused(*args)
    grads = R.gru_fused_grad(*args, hs, dhs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hs2 = R.gru_fused(*args)
        grads2 = R.gru_fused_grad(*args, hs2, dhs)
    side.synchronize()
    assert torch.equal(hs, hs2)
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)


def test_gru_kernels_refuse_what_they_do_not_take(dev):
    args, dhs = _gru_inputs(dev, 2, 3, 8)
    xproj, w, h0, mask = args
    with pytest.raises(TypeError):
        R.gru_fused(xproj.double(), w, h0, mask)
    with pytest.raises(ValueError):
        R.gru_fused(xproj.transpose(0, 1).contiguous().transpose(0, 1), w,
                    h0, mask)
    with pytest.raises(ValueError):
        R.gru_fused(xproj, w, h0, mask.cpu())
    with pytest.raises(ValueError):
        R.gru_fused(xproj, w[:, :8], h0, mask)
    hs = R.gru_fused(*args)
    with pytest.raises(ValueError):
        R.gru_fused_grad(*args, hs, dhs.transpose(1, 2))
    # past what a card offers: 8 units' columns of w take more shared
    # memory than a block may have
    big, _ = _gru_inputs(dev, 1, 1, 8192)
    with pytest.raises(ValueError, match="resident|shared memory"):
        R.gru_fused(*big)
    zeros = torch.zeros(1, 1, 8192, device=dev)
    with pytest.raises(ValueError, match="resident|shared memory"):
        R.gru_fused_grad(*big, zeros, zeros)


# ---------------------------------------------------------------------------
# K9 (fused multi-table gather) and K10 (row-wise lazy update)
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    """Bit for bit, NaN rows included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _zipf_ids(n, H, seed, top=0.1):
    """n ids in [0, H) with Zipf frequencies (p_k proportional to k^-s,
    s set so the hottest id covers a ``top`` share of the batch), the
    ranks spread over the rows by a seeded permutation."""
    import numpy as np
    rs = np.random.RandomState(seed)
    k = np.arange(1, H + 1, dtype=np.float64)
    lo, hi = 0.0, 8.0
    for _ in range(60):   # the hottest id's share grows with s
        s = (lo + hi) / 2
        lo, hi = (lo, s) if 1.0 / np.sum(k ** -s) > top else (s, hi)
    p = k ** -s
    return rs.permutation(H)[rs.choice(H, n, p=p / p.sum())]


def _sparse_case(dev, H, D, n, seed=0, lo=0, hi=None, dup=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = H if hi is None else hi
    ids = torch.randint(lo, hi, (n,), generator=g, device=dev)
    if dup == "zipf":
        ids = torch.tensor(_zipf_ids(n, H, seed), device=dev)
    elif dup is not None:
        ids[:] = dup
    vals = torch.randn(n, D, generator=g, device=dev)
    p = torch.randn(H, D, generator=g, device=dev)
    m = torch.randn(H, D, generator=g, device=dev)
    m2 = torch.rand(H, D, generator=g, device=dev)
    return ids, vals, p, m, m2


# table widths (each table [H, D]), H, n, id range (or "edges" / "zipf"),
# id dtype, and where the tables start: "row" at row 1 of an [H + 1, D]
# table, "float" one float past a 16-byte boundary (a base the kernel's
# vector loads must not assume aligned)
GATHER_CASES = {
    "in_range": ((10, 1), 1000, 4096, (0, 1000), torch.int64, None),
    "out_of_range": ((7, 1), 50, 300, (-60, 60), torch.int64, None),
    "ids_at_the_edges": ((3, 1), 13, 4, "edges", torch.int64, None),
    "three_rows": ((1, 1), 3, 17, (-3, 3), torch.int64, None),
    "empty": ((4, 1), 20, 0, (0, 20), torch.int64, None),
    "int32_ids": ((10, 1), 1000, 4096, (-1100, 1100), torch.int32, None),
    "four_mixed_widths": ((1, 3, 10, 64), 1000, 4096, (-1100, 1100),
                          torch.int64, None),
    "odd_row_offset": ((10, 1, 3, 16), 1000, 4096, (-1000, 1000),
                       torch.int32, "row"),
    "unaligned_base": ((16, 2), 1000, 515, (-1000, 1000), torch.int64,
                       "float"),
    "n1": ((10, 1), 1000, 1, (0, 1000), torch.int64, None),
    "n33": ((10, 1), 1000, 33, (-1000, 1000), torch.int32, None),
    # Zipf ids, the hottest a tenth of the batch
    "skewed": ((10, 1), 1000, 4096, "zipf", torch.int64, None),
}


def _gather_case(dev, case):
    widths, H, n, ids_kind, dtype, start = GATHER_CASES[case]
    g = torch.Generator(device=dev).manual_seed(11)
    if ids_kind == "edges":
        ids = torch.tensor([H - 1, -H, H, -H - 1], device=dev)
    elif ids_kind == "zipf":
        ids = torch.tensor(_zipf_ids(n, H, 4), device=dev)
    else:
        ids = torch.randint(*ids_kind, (n,), generator=g, device=dev)
    tabs = []
    for d in widths:
        if start == "row":
            tabs.append(torch.randn(H + 1, d, generator=g, device=dev)[1:])
        elif start == "float":
            flat = torch.randn(H * d + 1, generator=g, device=dev)
            tabs.append(flat[1:].view(H, d))
        else:
            tabs.append(torch.randn(H, d, generator=g, device=dev))
    ids = ids.to(dtype)
    return tabs, ids.reshape(-1, 1) if n else ids


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_sparse_gather_matches_plain_bitwise(dev, case):
    """K9 against its plain version bit for bit, one launch (none for an
    empty batch), bit-identical on a rerun and on a side stream."""
    from paddle_tpu_torch.kernels import sparse as S
    tabs, ids = _gather_case(dev, case)
    before = S.fused_gather.launches
    got = S.fused_gather(tabs, ids)
    torch.cuda.synchronize()
    assert S.fused_gather.launches == before + (1 if ids.numel() else 0)
    want = S.fused_gather_ref(tabs, ids)
    again = S.fused_gather(tabs, ids)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = S.fused_gather(tabs, ids)
    side.synchronize()
    for a, b, c, d in zip(got, want, again, other):
        assert _bits_equal(a, b)
        assert _bits_equal(c, b) and _bits_equal(d, b)


def test_sparse_gather_64bit_index_path(dev):
    """n * sum(D) >= 2^31 takes the kernel's 64-bit index math (about
    17 GB of card memory with the plain version)."""
    from paddle_tpu_torch.kernels import sparse as S
    H, D = 1000, 64
    n = (1 << 25) + 3          # n * D = 2^31 + 192
    g = torch.Generator(device=dev).manual_seed(12)
    table = torch.randn(H, D, generator=g, device=dev)
    ids = torch.randint(-H - 10, H + 10, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    (got,) = S.fused_gather([table], ids)
    torch.cuda.synchronize()
    (want,) = S.fused_gather_ref([table], ids)
    assert _bits_equal(got, want)
    del got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("case", [c for c in GATHER_CASES
                                  if GATHER_CASES[c][2]])
def test_sparse_gather_writes_only_its_outputs(dev, case):
    """K9's entry called on outputs cut from one buffer, with a guard of
    1,024 words before, between and after them: the outputs match the
    plain version and every guard word keeps its sentinel."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import sparse as S
    tabs, ids = _gather_case(dev, case)
    n, guard, sentinel = ids.numel(), 1024, 0x7F7F7F7F
    widths = [t.shape[1] for t in tabs]
    buf = torch.full((guard + sum(n * d + guard for d in widths),), sentinel,
                     dtype=torch.int32, device=dev)
    outs, kept, at = [], torch.ones_like(buf, dtype=torch.bool), guard
    for d in widths:
        outs.append(buf[at:at + n * d].view(torch.float32).view(
            *ids.shape, d))
        kept[at:at + n * d] = False
        at += n * d + guard
    err = S._kernel_fn(S._GATHER, S._GATHER_ARGS)(
        S.gather_params(ids, n, tabs, outs, [t.shape[0] for t in tabs],
                        widths, ids.get_device()),
        _build.current_stream(ids))
    torch.cuda.synchronize()
    assert err == 0
    for a, b in zip(outs, S.fused_gather_ref(tabs, ids)):
        assert _bits_equal(a, b)
    assert bool((buf[kept] == sentinel).all())


def test_current_stream_is_torchs(dev):
    """The raw stream every wrapper passes is PyTorch's current stream,
    on the default stream and on a side stream."""
    from paddle_tpu_torch.kernels import _build
    t = torch.zeros(1, device=dev)
    assert _build.current_stream(t) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.current_stream(t) == side.cuda_stream != \
            torch.cuda.default_stream().cuda_stream


UPDATE_CASES = {   # H, D, n, id range, every id the same
    "bench_width": (1000, 10, 4096, 0, 1000, None),
    "d1": (1000, 1, 4096, 0, 1000, None),
    "every_id_the_same": (40, 5, 513, 0, 40, 7),
    "wrapped_and_edge_ids": (23, 5, 17, -23, 23, None),
    "three_rows": (3, 2, 65, 0, 3, None),
    # Zipf ids, the hottest a tenth of the batch: a run of ~410 positions
    "skewed": (1000, 10, 4096, 0, 1000, "zipf"),
}


@pytest.mark.parametrize("kind", ["adam", "momentum", "nesterov",
                                  "adagrad"])
@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_sparse_update_matches_plain_bitwise(dev, case, kind):
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.kernels import sparse as S
    H, D, n, lo, hi, dup = UPDATE_CASES[case]
    ids, vals, p, m, m2 = _sparse_case(dev, H, D, n, seed=3, lo=lo, hi=hi,
                                       dup=dup)
    hyper = {"adam": dict(beta1=0.9, beta2=0.999, eps=1e-8),
             "momentum": dict(mu=0.9, nesterov=False),
             "nesterov": dict(mu=0.9, nesterov=True),
             "adagrad": dict(eps=1e-6)}[kind]
    base = "momentum" if kind == "nesterov" else kind
    tabs = {"adam": [p, m, m2], "momentum": [p, m], "adagrad": [p, m2]}[base]
    lr = torch.tensor(0.01, device=dev)
    sr = SelectedRows(ids, vals, H)
    got = [t.clone() for t in tabs]
    before = S.rowwise_update.launches
    S.rowwise_update(sr, got, lr, base, **hyper)
    torch.cuda.synchronize()
    assert S.rowwise_update.launches == before + 1
    want = [t.clone() for t in tabs]
    S.rowwise_update_ref(*S.sorted_segments(ids, H), vals, want, lr, base,
                         **hyper)
    touched = torch.zeros(H, dtype=torch.bool, device=dev)
    touched[torch.where(ids < 0, ids + H, ids)] = True
    for a, b, t in zip(got, want, tabs):
        assert _bits_equal(a, b)
        assert torch.equal(a[~touched], t[~touched])


def test_sparse_update_empty_batch_launches_nothing(dev):
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.kernels import sparse as S
    p = torch.randn(9, 4, device=dev)
    tabs = [p.clone(), p.clone(), p.clone()]
    sr = SelectedRows(torch.zeros(0, dtype=torch.int64, device=dev),
                      torch.zeros(0, 4, device=dev), 9)
    before = S.rowwise_update.launches
    S.fused_adam(*tabs, sr, torch.tensor(0.1, device=dev), 0.9, 0.999, 1e-8)
    assert S.rowwise_update.launches == before
    for t in tabs:
        assert torch.equal(t, p)


def test_sparse_kernels_never_fall_back(dev, monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the library
    missing, neither wrapper runs its plain version."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.kernels import sparse as S

    def missing(name):
        raise FileNotFoundError(f"no kernel library {name}")

    monkeypatch.setattr(S._build, "load", missing)
    ids, vals, p, m, m2 = _sparse_case(dev, 30, 4, 10)
    with pytest.raises(FileNotFoundError):
        S.fused_gather([p], ids)
    with pytest.raises(FileNotFoundError):
        S.fused_adam(p, m, m2, SelectedRows(ids, vals, 30),
                     torch.tensor(0.1, device=dev), 0.9, 0.999, 1e-8)


def test_sparse_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.kernels import sparse as S
    ids, vals, p, m, m2 = _sparse_case(dev, 30, 4, 10)
    with pytest.raises(TypeError):
        S.fused_gather([p.double()], ids)
    with pytest.raises(ValueError):
        S.fused_gather([p.t()], ids)
    with pytest.raises(ValueError):
        S.fused_gather([p] * 5, ids)
    with pytest.raises(ValueError):
        S.fused_gather([p.cpu()], ids)
    sr = SelectedRows(ids, vals, 30)
    with pytest.raises(ValueError):
        S.rowwise_update(sr, [p, m[:, :2]], torch.tensor(0.1, device=dev),
                         "momentum", mu=0.9, nesterov=False)
    with pytest.raises(ValueError):
        S.rowwise_update(sr, [p, m], torch.tensor(0.1), "momentum", mu=0.9,
                         nesterov=False)
    r, order = S.sorted_segments(ids, 30)
    with pytest.raises(ValueError):   # int64 rows: the kernel takes int32
        S.rowwise_update_sorted(r.long(), order, vals, [p, m],
                                torch.tensor(0.1, device=dev), "momentum",
                                mu=0.9, nesterov=False)


def test_deepfm_step_sorts_once(dev):
    """A DeepFM step (two sparse tables looked up with one Ids var,
    FLAGS_sparse_fused_kernel on) sorts its ids once: K9 once, K10 twice,
    one sort, a step."""
    import numpy as np
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.program import Program, program_guard
    from paddle_tpu_torch.kernels import sparse as S
    from paddle_tpu_torch.models import deepfm
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        _, loss, _ = deepfm.build(dense_dim=13, sparse_fields=26,
                                  sparse_dim=5000, embed_dim=10, lr=1e-3)
    rs = np.random.RandomState(0)
    feed = {"dense": rs.randn(64, 13).astype("float32"),
            "sparse": rs.randint(0, 5000, (64, 26)).astype("int64"),
            "label": rs.randint(0, 2, (64, 1)).astype("float32")}
    exe = fluid.Executor(dev)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.set_flags({"sparse_fused_kernel": True})
    try:
        for _ in range(2):
            n = (S.fused_gather.launches, S.rowwise_update.launches,
                 S.sorted_segments.launches)
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            assert np.isfinite(l).all()
            assert (S.fused_gather.launches - n[0],
                    S.rowwise_update.launches - n[1],
                    S.sorted_segments.launches - n[2]) == (1, 2, 1)
    finally:
        fluid.set_flags({"sparse_fused_kernel": False})


def test_dense_grad_and_mask_sums_in_order_on_the_card(dev):
    """The masked-dense path's one scatter sums each row's duplicates in
    their batch order on the card too (no atomics), bit for bit as the
    CPU's serial scatter: so the flag-off update is the same in every
    run and equals the fused one."""
    from paddle_tpu_torch.core.selected_rows import (SelectedRows,
                                                     dense_grad_and_mask)
    g = torch.Generator(device="cpu").manual_seed(5)
    n, H = 20000, 50
    rows = torch.randint(-H, H, (n,), generator=g)
    vals = torch.randn(n, 3, generator=g) * 10.0 ** torch.randint(
        -6, 6, (n, 1), generator=g).float()
    want = dense_grad_and_mask(SelectedRows(rows, vals, H))
    got = dense_grad_and_mask(SelectedRows(rows.to(dev), vals.to(dev), H))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# the RNN ops' routing: the eligibility gate (lstm_eligible/gru_eligible)
# ---------------------------------------------------------------------------

def _scan_routings(cell):
    from paddle_tpu_torch.observability import stats
    c = stats.default_registry().get(f"rnn.{cell}_scan_routings")
    return c.value if c is not None else 0


def _rnn_op_case(dev, cell, B, T, H, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 4 if cell == "lstm" else 3
    xproj = (torch.randn(B, T, n * H, generator=g, device=dev) * 0.5
             ).to(dtype)
    w = (torch.randn(H, n * H, generator=g, device=dev) / H ** 0.5
         ).to(dtype)
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev).int()
    return {"Input": [xproj], "Weight": [w], "SeqLen": [lens]}


RNN_ROUTE_CASES = {   # cell, B, T, H, dtype: ineligible on an H100
    "lstm_H2048_f32": ("lstm", 2, 3, 2048, torch.float32),
    "lstm_bf16": ("lstm", 4, 5, 64, torch.bfloat16),
    "gru_bf16": ("gru", 4, 5, 64, torch.bfloat16),
    "gru_H4096_f32": ("gru", 2, 3, 4096, torch.float32),
}


@pytest.mark.parametrize("case", list(RNN_ROUTE_CASES))
def test_rnn_op_routes_an_ineligible_shape_to_the_scan(dev, case):
    """A shape or dtype the kernels cannot take runs the plain scan, as
    the reference routes what its gates refuse to its XLA scan; it used
    to raise (TypeError for bf16, ValueError past the co-residency).
    Forward and grad both route, count the routing, launch nothing, and
    equal the plain scan (use_pallas_kernel False) bit for bit."""
    cell, B, T, H, dtype = RNN_ROUTE_CASES[case]
    ins = _rnn_op_case(dev, cell, B, T, H, dtype, seed=31)
    op = t_registry.get(cell)
    fwd_k = R.lstm_fused if cell == "lstm" else R.gru_fused
    bwd_k = R.lstm_fused_grad if cell == "lstm" else R.gru_fused_grad
    before = (fwd_k.launches, bwd_k.launches, _scan_routings(cell))
    got = op.lower(None, ins, {})
    want = op.lower(None, ins, {"use_pallas_kernel": False})
    dh = torch.randn_like(got["Hidden"][0])
    g_got = op.grad(None, {**ins, **got, "Hidden@GRAD": [dh]}, {})
    g_want = op.grad(None, {**ins, **want, "Hidden@GRAD": [dh]},
                     {"use_pallas_kernel": False})
    torch.cuda.synchronize()
    assert (fwd_k.launches, bwd_k.launches) == before[:2]
    assert _scan_routings(cell) == before[2] + 2
    for slot, v in got.items():
        assert torch.equal(v[0], want[slot][0]), slot
    for slot in ("Input@GRAD", "Weight@GRAD"):
        assert torch.equal(g_got[slot][0], g_want[slot][0]), slot
    # the explicit attr still wins, and the kernel refuses the shape
    with pytest.raises((TypeError, ValueError)):
        op.lower(None, ins, {"use_pallas_kernel": True})


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_op_launches_the_kernel_on_an_eligible_shape(dev, cell):
    ins = _rnn_op_case(dev, cell, 8, 6, 256, torch.float32, seed=32)
    op = t_registry.get(cell)
    fwd_k = R.lstm_fused if cell == "lstm" else R.gru_fused
    cap = R.kernel_capacity(f"{cell}_fwd", 8, 256, dev)
    gate = R.lstm_eligible if cell == "lstm" else R.gru_eligible
    assert gate(8, 6, 256, torch.float32, cap) and cap >= 64
    before = (fwd_k.launches, _scan_routings(cell))
    got = op.lower(None, ins, {})
    want = op.lower(None, ins, {"use_pallas_kernel": False})
    torch.cuda.synchronize()
    assert fwd_k.launches == before[0] + 1
    assert _scan_routings(cell) == before[1]
    assert (got["Hidden"][0] - want["Hidden"][0]).abs().max().item() <= \
        (K6_FWD_ATOL if cell == "lstm" else K8A_FWD_ATOL)


# ---------------------------------------------------------------------------
# K5: the fused-dequant int8 FC
# ---------------------------------------------------------------------------

INT8_SHAPES = {   # M, K, N: the path's four at bucket 8, odd, one row
    "qkv_out": (2048, 512, 512),
    "ffn1": (2048, 512, 2048),
    "ffn2": (2048, 2048, 512),
    "vocab": (2048, 512, 32000),
    "odd": (5, 37, 11),
    "m1": (1, 512, 512),
}
INT8_ACTS = ["", "relu", "sigmoid", "tanh", "gelu"]


def _int8_case(dev, M, K, N, seed):
    from paddle_tpu_torch.kernels import quant as Q
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(dev)
    w = torch.randn(K, N, generator=g) / K ** 0.5
    q, s = Q.quantize_weight(w.numpy())
    return (x, torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev),
            (torch.randn(N, generator=g) * 0.1).to(dev))


@pytest.mark.parametrize("in_scale", [0.0, 3.0], ids=["dynamic", "calib"])
@pytest.mark.parametrize("act", INT8_ACTS, ids=lambda a: a or "none")
@pytest.mark.parametrize("shape", list(INT8_SHAPES))
def test_int8_fc_matches_plain(dev, shape, act, in_scale):
    """K5 against its plain version on the same inputs: bit for bit for
    "" and relu (exact int32 sums, the epilogue's rounded multiply then
    add), within 1e-6 of max|ref| for sigmoid, tanh and gelu (the
    card's and torch's transcendentals differ by ulps)."""
    from paddle_tpu_torch.kernels import quant as Q
    x, q, s, b = _int8_case(dev, *INT8_SHAPES[shape], seed=40)
    n = Q.int8_fc.launches
    got = Q.int8_fc(x, q, s, in_scale, b, act)
    torch.cuda.synchronize()
    assert Q.int8_fc.launches == n + 1
    want = Q.int8_fc_plain(x, q, s, in_scale, b, act)
    assert got.shape == want.shape and got.dtype == torch.float32
    if act in ("", "relu"):
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item(), err


def _int8_config(M, N, K, dev):
    """(tile rows, tile columns, blocks, resident blocks an SM,
    registers, shared memory) K5 takes at this shape."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    fn = _build.load("int8_fc").int8_fc_config
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    assert fn(M, N, K, dev.index, out) == 0
    return tuple(out)


INT8_EDGE_SHAPES = {   # M, K, N: tile edges in every dimension
    "m129_k80_n200": (129, 80, 200),     # K a multiple of 16, not of 64
    "m1_k4112_n33": (1, 4112, 33),       # one row, deep K
    "m300_k2064_n130": (300, 2064, 130),  # deep K, N % 4 != 0
    "m70_k37_n130": (70, 37, 130),       # K % 16 != 0: byte loads
    "m64_k16_n4": (64, 16, 4),
    "m2049_k512_n513": (2049, 512, 513),
}


@pytest.mark.parametrize("act", ["", "relu", "gelu"], ids=lambda a: a or "none")
@pytest.mark.parametrize("shape", list(INT8_EDGE_SHAPES))
def test_int8_fc_at_tile_edges(dev, shape, act):
    """M, N and K that are not multiples of K5's tiles, one row, deep K
    and byte loads: "" and relu bit for bit, gelu within 1e-6 of
    max|ref|."""
    from paddle_tpu_torch.kernels import quant as Q
    x, q, s, b = _int8_case(dev, *INT8_EDGE_SHAPES[shape], seed=43)
    got = Q.int8_fc(x, q, s, 0.0, b, act)
    torch.cuda.synchronize()
    want = Q.int8_fc_plain(x, q, s, 0.0, b, act)
    if act in ("", "relu"):
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= \
            1e-6 * want.abs().max().item()


@pytest.mark.parametrize("shape", ["qkv_out", "ffn1", "ffn2", "vocab"])
def test_int8_fc_fills_the_card_at_the_paths_shapes(dev, shape):
    """Each of the path's bucket-8 shapes launches as many blocks as its
    64 x 128 tiles, up to a block an SM (64 x 128 tiles where 128 x 128
    would leave SMs idle), every block resident with its neighbours (two
    an SM)."""
    M, K, N = INT8_SHAPES[shape]
    bm, bn, blocks, per_sm, _, _ = _int8_config(M, N, K, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert blocks >= min(sms, -(-M // 64) * -(-N // 128))
    assert per_sm >= 2
    assert (bm, bn) == ((128, 128) if shape in ("ffn1", "vocab")
                        else (64, 128))


def test_int8_fc_keeps_each_weights_kmajor_copy(dev):
    """The wrapper makes a weight's K-major copy at its first launch and
    reuses it (``quant.kmajor_copies`` counts the copies); a weight
    written in place is copied again, so K5 reads its new codes."""
    from paddle_tpu_torch.kernels import quant as Q
    x, q, s, b = _int8_case(dev, 64, 96, 130, seed=45)

    def made():
        return Q.quantz()["counters"].get("kmajor_copies", 0)

    n = made()
    first = Q.int8_fc(x, q, s, 0.0, b)
    second = Q.int8_fc(x, q, s, 0.0, b)
    torch.cuda.synchronize()
    assert made() == n + 1
    assert torch.equal(first, second)
    q[0] = -q[0]
    third = Q.int8_fc(x, q, s, 0.0, b)
    torch.cuda.synchronize()
    assert made() == n + 2
    assert torch.equal(third, Q.int8_fc_plain(x, q, s, 0.0, b))


def test_int8_fc_without_bias_and_on_a_side_stream(dev):
    from paddle_tpu_torch.kernels import quant as Q
    x, q, s, _ = _int8_case(dev, 70, 96, 130, seed=41)
    want = Q.int8_fc_plain(x, q, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = Q.int8_fc(x, q, s)
    side.synchronize()
    assert torch.equal(got, want)
    zero = Q.int8_fc(torch.zeros_like(x), q, s)
    torch.cuda.synchronize()
    assert torch.equal(zero, torch.zeros_like(zero))


def test_int8_fc_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels import quant as Q
    x, q, s, b = _int8_case(dev, 4, 16, 8, seed=42)
    with pytest.raises(ValueError, match="epilogue"):
        Q.int8_fc(x, q, s, act="leaky_relu")
    with pytest.raises(TypeError):
        Q.int8_fc(x, q.float(), s)
    with pytest.raises(ValueError):
        Q.int8_fc(x, q[:8], s)
    with pytest.raises(ValueError):
        Q.int8_fc(x, q, s.cpu())
    with pytest.raises(ValueError):
        Q.int8_fc(x, q, s, bias=b[:4])
    with pytest.raises(ValueError):
        Q.int8_fc(x, q.t().contiguous().t(), s)


# -- ring attention (K11): the ring over K1-K3 ------------------------------

@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.1)])
def test_ring_matches_plain_ring_and_counts_launches(dev, causal, rate):
    """Four shards of one card, ragged keys with a batch row whose keys
    lie in the last shard only (its other pairs all-masked): the ring
    over K1-K3 equals the plain ring (forward and autograd backward)
    within the flash kernels' tolerances, launching each kernel's ring
    entry once a hop, sp times, causal or not."""
    q, k, v, do, mask = _flash_inputs(dev, 2, 2, 256, 256, 64, seed=9)
    mask[1] = 0.0
    mask[1, -64:] = 1.0
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    out = {}
    for plain in (False, True):
        fn = A.ring_attention_ref if plain else A.ring_attention
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n0 = (A.flash_attention_fwd.launches,
              A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches)
        o = fn(*leaves, mask, [dev] * 4, causal, None, rate, seed)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        out[plain] = (o,) + grads
        n1 = (A.flash_attention_fwd.launches,
              A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches)
        want = 0 if plain else 4
        assert tuple(b - a for a, b in zip(n0, n1)) == (want,) * 3
    torch.testing.assert_close(out[False][0], out[True][0], **FWD_TOL)
    for a, b in zip(out[False][1:], out[True][1:]):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.1)])
def test_ring_bf16_matches_plain_ring(dev, causal, rate):
    """The ring over the bfloat16 K1-K3 against the plain bfloat16 ring
    (pairs merged and accumulated in float32), within the bfloat16
    kernels' bar, with the same exact launch counts (a hop's one)."""
    q, k, v, do, mask = (x.bfloat16() if x.dim() == 4 else x
                         for x in _flash_inputs(dev, 2, 2, 256, 256, 64,
                                                seed=9))
    mask[1] = 0.0
    mask[1, -64:] = 1.0
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    out = {}
    for plain in (False, True):
        fn = A.ring_attention_ref if plain else A.ring_attention
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n0 = A.flash_attention_fwd.launches
        o = fn(*leaves, mask, [dev] * 4, causal, None, rate, seed)
        out[plain] = (o,) + torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        want = 0 if plain else 4
        assert A.flash_attention_fwd.launches - n0 == want
    for a, b in zip(out[False], out[True]):
        _bf16_close(a, b)


def test_ring_refuses_float16_as_the_flash_kernels_do(dev):
    q, k, v, _, mask = _flash_inputs(dev, 1, 2, 64, 64, 32, seed=3)
    with pytest.raises(TypeError):
        A.ring_attention(q.half(), k.half(), v.half(), mask, [dev] * 4)
