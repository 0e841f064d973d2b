"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (as on a CPU-only
machine) and runs on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` because the suite's conftest sets JAX up, and the
card's machine needs no JAX: this file imports none).  ``chip_smoke.py``
checks the kernels at the main path's shapes; these cover the edges:
head dims that are not a multiple of 32, one-token blocks, the largest
head dim, many slots, context lengths past the block table, an empty
context, and a launch on a side stream.
"""
import pytest
import torch

from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.kernels.quant import kv_quantize

pytestmark = pytest.mark.cuda

TOL = 1e-5      # float32 sums in two orders over at most 256 positions


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


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_dropout_and_all_masked_row(dev, causal):
    _flash_check(dev, 2, 2, 200, 200, 64, causal, rate=0.1, seed=3,
                 all_masked=True)


def test_flash_kernels_cross_length_causal(dev):
    """Tk > Tq causal: keys wholly above the frontier get zero dk/dv."""
    dk, dv = _flash_check(dev, 1, 2, 128, 300, 48, causal=True, seed=4)
    assert torch.count_nonzero(dk[:, :, 128:]) == 0
    assert torch.count_nonzero(dv[:, :, 128:]) == 0


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


def test_flash_kernels_refuse_what_they_do_not_take(dev):
    q, k, v, do, mask = _flash_inputs(dev, 1, 2, 16, 16, 32)
    with pytest.raises(TypeError):
        A.flash_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q.transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 1, 4, 160, device=dev)
        A.flash_attention_fwd(big, big, big)
    with pytest.raises(ValueError):
        A.flash_attention_fwd(q, k, v, mask.cpu())
