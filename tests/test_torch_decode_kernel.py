"""The port's paged decode attention and KV quantization against the JAX
package, on the CPU.

``paddle_tpu_torch.kernels.attention.decode_attention`` takes its plain
PyTorch version for CPU tensors; it is held against the JAX gather
reference ``paged_attention_xla`` and against the Pallas kernel
``decode_attention(impl="pallas")`` run in interpret mode, on the same
numpy inputs, float32 and int8, at 1e-5.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``; here
the wrapper's input checks (what the kernel refuses) are exercised.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import attention as JA
from paddle_tpu.kernels import quant as JQ
from paddle_tpu_torch.kernels import attention as TA
from paddle_tpu_torch.kernels import quant as TQ

S, H, BS, MB, N = 3, 2, 4, 4, 8
CL = np.array([1, 7, 16], np.int32)


def _inputs(D, quantized, seed=0):
    rng = np.random.RandomState(seed)
    kc = rng.randn(N, BS, H, D).astype(np.float32)
    vc = rng.randn(N, BS, H, D).astype(np.float32)
    q = rng.randn(S, H, D).astype(np.float32)
    bt = rng.randint(0, N, (S, MB)).astype(np.int32)
    if not quantized:
        return q, kc, vc, bt, None, None
    ks = np.abs(kc).max(axis=(1, 3)).astype(np.float32)      # [N, H]
    vs = np.abs(vc).max(axis=(1, 3)).astype(np.float32)
    kq = np.clip(np.round(kc / ks[:, None, :, None] * 127), -127,
                 127).astype(np.int8)
    vq = np.clip(np.round(vc / vs[:, None, :, None] * 127), -127,
                 127).astype(np.int8)
    return q, kq, vq, bt, ks, vs


def _jax(fn, q, kc, vc, bt, ks, vs, **kw):
    scales = ({} if ks is None else
              dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(bt, jnp.int32),
                         jnp.asarray(CL, jnp.int32), **scales, **kw))


def _port(q, kc, vc, bt, ks, vs):
    t = torch.from_numpy
    scales = {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs))
    return TA.decode_attention(t(q), t(kc), t(vc), t(bt), t(CL),
                               **scales).numpy()


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("D", [16, 64])
def test_decode_attention_matches_jax_reference_and_pallas(D, quantized):
    args = _inputs(D, quantized)
    got = _port(*args)
    assert got.shape == (S, H, D) and got.dtype == np.float32
    ref = _jax(JA.paged_attention_xla, *args)
    pallas = _jax(JA.decode_attention, *args, impl="pallas")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


def test_paged_attention_ref_masks_past_context_len():
    """Positions >= context_len do not move the output: poison every
    cache row past each slot's frontier and the result stays put."""
    q, kc, vc, bt, _, _ = _inputs(16, False, seed=3)
    clean = _port(q, kc, vc, bt, None, None)
    kp, vp = kc.copy(), vc.copy()
    for s in range(S):
        for t in range(int(CL[s]), MB * BS):
            blk, off = bt[s, t // BS], t % BS
            # a poisoned row that some slot does read stays clean
            live = any(bt[o, u // BS] == blk and u % BS == off
                       for o in range(S) for u in range(int(CL[o])))
            if not live:
                kp[blk, off] = 1e3
                vp[blk, off] = -1e3
    np.testing.assert_array_equal(_port(q, kp, vp, bt, None, None), clean)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_decode_attention_on_a_table_wider_than_every_context(quantized):
    """On the CPU the plain version gathers only the table slots that
    some lane's context reaches; with contexts of 1-9 tokens on a
    16-slot table it still gives the JAX reference's full-table result."""
    q, kc, vc, _, ks, vs = _inputs(16, quantized, seed=5)
    cl = np.array([1, 5, 9], np.int32)
    bt = np.random.RandomState(6).randint(0, N, (S, 16)).astype(np.int32)
    scales = ({} if ks is None else
              dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    ref = np.asarray(JA.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(cl), **scales))
    t = torch.from_numpy
    got = TA.decode_attention(t(q), t(kc), t(vc), t(bt), t(cl), **(
        {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs)))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_kv_quant_helpers_exact():
    rng = np.random.RandomState(1)
    rows = (rng.randn(5, 3, 16) * 2.0).astype(np.float32)
    rows[0, 1] = 0.0                       # an all-zero head hits SCALE_EPS
    rows[2, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # ties on the rounding grid
    scales = np.abs(rng.randn(5, 3)).astype(np.float32)
    scales[1, 2] = 0.0
    j_amax = np.array(JQ.kv_head_amax(jnp.asarray(rows)))
    t_amax = TQ.kv_head_amax(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(t_amax, j_amax)
    for s in (scales, j_amax):
        jq = np.asarray(JQ.kv_quantize(jnp.asarray(rows), jnp.asarray(s)))
        tq = TQ.kv_quantize(torch.from_numpy(rows),
                            torch.from_numpy(s)).numpy()
        assert tq.dtype == np.int8
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(
            TQ.kv_dequantize(torch.from_numpy(tq),
                             torch.from_numpy(s)).numpy(),
            np.asarray(JQ.kv_dequantize(jnp.asarray(jq), jnp.asarray(s))))
    assert (TQ.QMAX, TQ.SCALE_EPS) == (JQ.QMAX, JQ.SCALE_EPS)
    # half-to-even rounding, like jnp.round
    half = torch.tensor([[[63.5, 64.5, -63.5]]]) / 127.0
    codes = TQ.kv_quantize(half, torch.ones(1, 1)).flatten().tolist()
    assert codes == [64, 64, -64]


def _kernel_args(quantized=False):
    q, kc, vc, bt, ks, vs = (None if a is None else torch.from_numpy(a)
                             for a in _inputs(16, quantized))
    return [q, kc, vc, bt, torch.from_numpy(CL), ks, vs]


@pytest.mark.parametrize("case", [
    "q_f64", "cache_f16", "int8_without_scales", "f32_with_scales",
    "non_contiguous_cache", "table_int64", "head_dim_too_big",
    "one_scale_only"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks the CUDA wrapper runs before it launches (they raise;
    nothing falls back to the plain version)."""
    a = _kernel_args(quantized=case in ("int8_without_scales",
                                        "one_scale_only"))
    if case == "q_f64":
        a[0] = a[0].double()
    elif case == "cache_f16":
        a[1], a[2] = a[1].half(), a[2].half()
    elif case == "int8_without_scales":
        a[5] = a[6] = None
    elif case == "f32_with_scales":
        a[5] = a[6] = torch.ones(N, H)
    elif case == "non_contiguous_cache":
        a[1] = a[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "table_int64":
        a[3] = a[3].long()
    elif case == "head_dim_too_big":
        D = TA.MAX_HEAD_DIM + 16
        a[0] = torch.zeros(S, H, D)
        a[1] = a[2] = torch.zeros(N, BS, H, D)
    elif case == "one_scale_only":
        a[6] = None
    with pytest.raises((TypeError, ValueError)):
        TA._check_inputs(*a)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_kernel_wrapper_accepts_what_the_kernel_takes(quantized):
    TA._check_inputs(*_kernel_args(quantized))
