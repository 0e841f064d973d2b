"""Ring attention (K11): the port's ``ring_attention`` over ``sp``
repeated CPU devices against the reference's ``ring_attention`` under
``shard_map`` on the virtual CPU mesh (its Pallas pair kernels in
interpret mode), at the shapes of the reference's own ring tests
(``tests/test_attention.py:59-175``: B <= 2, H=2, T=32-64, D=8-16).

Tolerances: the forward within 2e-5 (rtol and atol) and dq/dk/dv within
1e-4, the reference tests' own bounds (float32 in two frameworks,
different summation orders in the pairs and the merges).  Dropout bits
are the same counter hash on both sides, keyed on the same pair seeds,
so the dropped outputs agree within the forward's bound; the pair seeds
themselves agree bit for bit.

bfloat16 (``BF16_CASES``): inputs rounded to bfloat16 go through both
rings, whose pairs run the flash kernels' bfloat16 arithmetic (the
port's plain bfloat16 K1-K3 against the reference's Pallas kernels in
interpret mode; ``test_torch_flash_attention.py`` holds the pairs
alone), merged and accumulated in float32 and cast to bfloat16 once.
The reference's ring is compiled with XLA's excess precision off, so
it rounds where its program says.  Bar: ``test_torch_flash_attention.py``'s
bfloat16 one, every element within one bfloat16 ulp of its tensor's
max|ref| and at most 1% of the elements differing.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.kernels import attention as JA
from paddle_tpu_torch.kernels import attention as TA

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, H, T, D, seed=11, keys_in_last_shard=None):
    """q, k, v, the cotangent and a [B, T] key mask from a seeded numpy
    stream; ``keys_in_last_shard=sp`` leaves batch row 1 with keys only
    in the last of ``sp`` shards (every other pair of that row is
    all-masked, the merge's identity case)."""
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(B, H, T, D).astype("float32") for _ in range(4))
    mask = (rs.rand(B, T) > 0.2).astype("float32")
    mask[:, 0] = 1.0
    if keys_in_last_shard:
        mask[1] = 0.0
        mask[1, -(T // keys_in_last_shard):] = 1.0
    return q, k, v, g, mask


def _reference(q, k, v, mask, g, sp, causal, rate=0.0, seed=None,
               dtype=jnp.float32):
    """(out, dq, dk, dv) of the reference's ring under shard_map over the
    first ``sp`` virtual CPU devices, forward and VJP in one jitted call
    (run eagerly, every interpret-mode pair kernel is dispatched op by op,
    about six times slower)."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, None, "sp", None)
    s = None if seed is None else jnp.asarray(seed, jnp.int32)
    ring = jax.shard_map(
        lambda q, k, v, m: JA.ring_attention(
            q, k, v, None if mask is None else m, "sp", causal,
            dropout_rate=rate, dropout_seed=s),
        mesh=mesh, in_specs=(spec,) * 3 + (P(None, "sp"),), out_specs=spec)

    @functools.partial(jax.jit, compiler_options={
        "xla_allow_excess_precision": False})
    def fwd_vjp(q, k, v, m, g):
        out, vjp = jax.vjp(lambda q, k, v: ring(q, k, v, m), q, k, v)
        return (out,) + vjp(g)

    # with no mask the shard_map still takes one, unused, to keep one form
    m = np.ones((q.shape[0], q.shape[2]), "float32") if mask is None else mask
    q, k, v, g = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    return tuple(np.asarray(x, np.float32)
                 for x in fwd_vjp(q, k, v, jnp.asarray(m), g))


def _port(q, k, v, mask, g, sp, causal, rate=0.0, seed=None,
          dtype=torch.float32):
    """(out, dq, dk, dv) of the port's ring over ``sp`` CPU devices."""
    leaves = [torch.tensor(x, dtype=dtype, requires_grad=True)
              for x in (q, k, v)]
    m = None if mask is None else torch.tensor(mask)
    s = None if seed is None else torch.tensor([seed], dtype=torch.int32)
    out = TA.ring_attention(*leaves, m, ["cpu"] * sp, causal,
                            dropout_rate=rate, dropout_seed=s)
    out.backward(torch.tensor(g, dtype=dtype))
    assert out.dtype == dtype and all(x.grad.dtype == dtype for x in leaves)
    return tuple(x.detach().float().numpy()
                 for x in [out] + [x.grad for x in leaves])


def _close(got, ref):
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, ref,
                               (FWD_TOL,) + (GRAD_TOL,) * 3):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


# (sp, causal, B, T, D, mask, rate): every sp of 2, 4 and 8, causal and
# not, at the reference tests' shapes; "partial" leaves batch row 1 with
# keys only in the last shard (its other pairs all-masked: the kernels'
# +1e30 sentinel, the merge's -1e30 identity); dropout 0.3 with seed 7
CASES = {
    "sp8": (8, False, 2, 64, 16, "mask", 0.0),
    "sp4_causal_partial_rows": (4, True, 2, 64, 16, "partial", 0.0),
    "sp2_causal_mask_none": (2, True, 1, 32, 8, None, 0.0),
    "sp4_dropout": (4, False, 1, 64, 16, "mask", 0.3),
}


def _case(name):
    sp, causal, B, T, D, kind, rate = CASES[name]
    q, k, v, g, mask = _inputs(B, 2, T, D, keys_in_last_shard=(
        sp if kind == "partial" else None))
    return (q, k, v, None if kind is None else mask, g, sp, causal, rate,
            7 if rate else None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_reference(name):
    args = _case(name)
    got = _port(*args)
    _close(got, _reference(*args))
    if CASES[name][-1]:
        # dropout: deterministic on a rerun, other bits for seed 8, and
        # the bits do engage
        for x, y in zip(got, _port(*args)):
            np.testing.assert_array_equal(x, y)
        other = _port(*args[:-1], 8)
        assert np.abs(got[0] - other[0]).max() > 1e-4
        plain = _port(*args[:-2], 0.0, None)
        assert np.abs(got[0] - plain[0]).max() > 1e-4


BF16_CASES = {
    "sp4_causal_partial_rows": (4, True, 2, 64, 16, "partial", 0.0),
    "sp2_d64_mask_none": (2, False, 1, 64, 64, None, 0.0),
    "sp4_dropout": (4, False, 1, 64, 16, "mask", 0.3),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_ring_bf16_matches_reference(name):
    sp, causal, B, T, D, kind, rate = BF16_CASES[name]
    q, k, v, g, mask = (torch.from_numpy(x).bfloat16().float().numpy()
                        if x.ndim == 4 else x
                        for x in _inputs(B, 2, T, D, keys_in_last_shard=(
                            sp if kind == "partial" else None)))
    args = (q, k, v, None if kind is None else mask, g, sp, causal, rate,
            7 if rate else None)
    got = _port(*args, dtype=torch.bfloat16)
    ref = _reference(*args, dtype=jnp.bfloat16)
    for name_, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        diff = np.abs(a - b)
        _, e = np.frexp(np.abs(b).max())
        assert diff.max() <= np.ldexp(1.0, e - 8), (name_, diff.max())
        assert np.count_nonzero(diff) <= 0.01 * diff.size, name_


def test_pair_seed_bit_for_bit_with_wraparound():
    seeds = np.array([0, 1, 7, -1, 123456789, 2 ** 31 - 1, -2 ** 31,
                      2 ** 31 - 4000000, -2 ** 31 + 5], dtype=np.int64)
    idx = np.arange(8)
    for s0 in seeds:
        ref = np.asarray(JA._pair_seed(jnp.asarray(s0, jnp.int32),
                                       jnp.asarray(idx[:, None], jnp.int32),
                                       jnp.asarray(idx[None], jnp.int32)))
        got = TA._pair_seed(torch.tensor([s0], dtype=torch.int32),
                            torch.tensor(idx[:, None]),
                            torch.tensor(idx[None])).numpy()
        assert got.dtype == np.int32 and ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    # the grid does wrap: seed 2**31 - 1 plus a positive product
    assert TA._pair_seed(torch.tensor([2 ** 31 - 1], dtype=torch.int32),
                         1, 0).item() < 0


def test_merge_identities_match_reference():
    """The +/-1e30 sentinels: an all-masked partial (mass -1e30) leaves
    the other unchanged bit for bit, two all-masked partials stay
    all-masked, and the lse conversions agree with the reference's."""
    rs = np.random.RandomState(5)
    o_a, o_p = (rs.randn(2, 2, 8, 4).astype("float32") for _ in range(2))
    lse_a = rs.randn(2, 2, 8, 1).astype("float32") * 4
    lse_p = rs.randn(2, 2, 8, 1).astype("float32") * 4
    lse_a[0, 0, :3] = -1e30             # all-masked rows in the carry
    lse_p[0, 1] = -1e30                 # an all-masked partial
    lse_p[0, 0, :2] = -1e30             # both
    o_p[lse_p[..., 0] == -1e30] = 0.0
    o_a[lse_a[..., 0] == -1e30] = 0.0
    ref = JA._merge_partial(*(jnp.asarray(x) for x in (o_a, lse_a, o_p,
                                                        lse_p)))
    got = TA._merge_partial(*(torch.tensor(x) for x in (o_a, lse_a, o_p,
                                                         lse_p)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    o_t, lse_t = (x.numpy() for x in got)
    np.testing.assert_array_equal(o_t[0, 1], o_a[0, 1])
    np.testing.assert_array_equal(lse_t[0, 1], lse_a[0, 1])
    assert (lse_t[0, 0, :2] < -1e29).all() and (o_t[0, 0, :2] == 0).all()
    lse = np.array([1e30, -1e30, 3.5, -2.0], "float32")
    np.testing.assert_array_equal(TA._mass_lse(torch.tensor(lse)).numpy(),
                                  np.asarray(JA._mass_lse(jnp.asarray(lse))))
    np.testing.assert_array_equal(
        TA._kernel_lse(torch.tensor(lse)).numpy(),
        np.asarray(JA._kernel_lse(jnp.asarray(lse))))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_ring_equals_whole_sequence_attention(causal):
    """The plain ring (``ring_attention_ref``, forward and backward)
    against ``mha_ref`` over the whole sequence; the differentiable ring
    on the CPU (the hop route through the ring entries' plain loops) runs
    the same plain pairs in the same order, so it equals the plain ring
    bit for bit."""
    q, k, v, g, mask = _inputs(2, 2, 64, 16, seed=4)
    gt, mt = torch.tensor(g), torch.tensor(mask)
    plain = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = TA.ring_attention_ref(*plain, mt, ["cpu"] * 4, causal)
    out.backward(gt)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    ref = TA.mha_ref(*leaves, mt, causal)
    ref.backward(gt)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **FWD_TOL)
    for a, b in zip(plain, leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   **GRAD_TOL)
    got = _port(q, k, v, mask, g, 4, causal)
    np.testing.assert_array_equal(got[0], out.detach().numpy())
    for a, b in zip(got[1:], plain):
        np.testing.assert_array_equal(a, b.grad.numpy())


@pytest.mark.parametrize("sp,causal", [(4, False), (4, True), (8, True),
                                       (1, False)])
def test_pair_counts_and_no_cpu_launch(sp, causal, monkeypatch):
    """The hop route's calls ``chip_smoke.py`` counts as launches on the
    card: on one device each ring entry runs once a hop, ``sp`` times a
    pass (K1 a forward, K2 and K3 a backward), and its tables hold every
    pair once, ``sp**2`` of them (``sp * (sp + 1) / 2`` causal); on the
    CPU no launch counter moves."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    pairs = {"fwd": [], "dq": [], "dkv": []}

    def counted(key, fn):
        def wrap(*a, **kw):
            calls[key] += 1
            pairs[key] += [(i, j) for i, j, _ in a[5]]
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(TA, "flash_attention_fwd_ring",
                        counted("fwd", TA.flash_attention_fwd_ring))
    monkeypatch.setattr(TA, "flash_attention_bwd_dq_ring",
                        counted("dq", TA.flash_attention_bwd_dq_ring))
    monkeypatch.setattr(TA, "flash_attention_bwd_dkv_ring",
                        counted("dkv", TA.flash_attention_bwd_dkv_ring))
    q, k, v, g, mask = _inputs(1, 2, 32, 8)
    n0 = (TA.flash_attention_fwd.launches,
          TA.flash_attention_bwd_dq.launches,
          TA.flash_attention_bwd_dkv.launches)
    _port(q, k, v, mask, g, sp, causal)
    assert calls == {"fwd": sp, "dq": sp, "dkv": sp}
    want = sorted((i, j) for i in range(sp) for j in range(sp)
                  if not (causal and j > i))
    assert len(want) == (sp * (sp + 1) // 2 if causal else sp * sp)
    for key in pairs:
        assert sorted(pairs[key]) == want, key
    assert (TA.flash_attention_fwd.launches,
            TA.flash_attention_bwd_dq.launches,
            TA.flash_attention_bwd_dkv.launches) == n0


# (sp, causal, B, T, D, mask, rate, dtype): the hop route against the
# plain ring; T=36 over sp=4 makes 9-row shards (not a multiple of 8)
HOP_CASES = {
    "f32_sp4": (4, False, 2, 64, 16, "mask", 0.0, torch.float32),
    "f32_sp4_causal_partial_rows": (4, True, 2, 64, 16, "partial", 0.0,
                                    torch.float32),
    "f32_sp4_causal_s9_dropout": (4, True, 2, 36, 16, "mask", 0.3,
                                  torch.float32),
    "f32_sp8_causal_mask_none": (8, True, 1, 64, 8, None, 0.0,
                                 torch.float32),
    "bf16_sp4_dropout": (4, False, 1, 64, 16, "mask", 0.3, torch.bfloat16),
    "bf16_sp4_causal_partial_rows": (4, True, 2, 64, 16, "partial", 0.0,
                                     torch.bfloat16),
    "bf16_sp4_s9": (4, False, 2, 36, 16, "mask", 0.1, torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(HOP_CASES))
def test_hop_route_equals_plain_ring(name):
    """The hop route (``ring_attention``: one call of each ring entry a
    hop, the pairs' shards read as rows of the whole tensors, merges and
    sums in the entries) against the plain ring's pair-by-pair walk
    (``ring_attention_ref``), forward and backward: bit for bit, on one
    device and with the shards on two alternating places (``cpu:0``,
    ``cpu:1``: distinct devices to the route, so its frames, copies
    between hops, travelling dk/dv accumulators and gathers run)."""
    sp, causal, B, T, D, kind, rate, dtype = HOP_CASES[name]
    q, k, v, g, mask = _inputs(B, 2, T, D, seed=23, keys_in_last_shard=(
        sp if kind == "partial" else None))
    m = None if kind is None else torch.tensor(mask)
    s = torch.tensor([7], dtype=torch.int32) if rate else None

    def run(fn, devices):
        leaves = [torch.tensor(x, dtype=dtype, requires_grad=True)
                  for x in (q, k, v)]
        out = fn(*leaves, m, devices, causal, None, rate, s)
        return (out.detach(),) + torch.autograd.grad(
            out, leaves, torch.tensor(g, dtype=dtype))

    ref = run(TA.ring_attention_ref, ["cpu"] * sp)
    for devices in (["cpu"] * sp, [f"cpu:{i % 2}" for i in range(sp)]):
        got = run(TA.ring_attention, devices)
        for n, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
            assert a.dtype == dtype
            assert torch.equal(a, b), (n, devices)


def test_ring_hops_group_pairs_by_device():
    """The hop tables from a device list alone: each hop's pairs grouped
    by the device of their q shard, devices in the order they first
    appear, pairs in the reference's order (q shard ascending, kv shard
    (i - t) mod sp), the flags marking the causal diagonal, the first hop
    and each shard's last pair."""
    c0, c1 = torch.device("cuda:0"), torch.device("cuda:1")
    F, C = TA.RING_FIRST, TA.RING_CAUSAL
    LQ, LK = TA.RING_LAST_Q, TA.RING_LAST_KV
    hops = TA.ring_hops([c0, c1, c0, c1], causal=False)
    assert [[(d, [(i, j) for i, j, _ in p]) for d, p in h] for h in hops] == [
        [(c0, [(0, 0), (2, 2)]), (c1, [(1, 1), (3, 3)])],
        [(c0, [(0, 3), (2, 1)]), (c1, [(1, 0), (3, 2)])],
        [(c0, [(0, 2), (2, 0)]), (c1, [(1, 3), (3, 1)])],
        [(c0, [(0, 1), (2, 3)]), (c1, [(1, 2), (3, 0)])]]
    assert {f for h in hops[:1] for _, p in h for _, _, f in p} == {F}
    assert {f for h in hops[1:3] for _, p in h for _, _, f in p} == {0}
    assert {f for _, p in hops[3] for _, _, f in p} == {LQ | LK}
    hops = TA.ring_hops([c1, c0, c1, c0], causal=True)
    assert hops == [
        [(c1, [(0, 0, F | C | LQ), (2, 2, F | C)]),
         (c0, [(1, 1, F | C), (3, 3, F | C | LK)])],
        [(c1, [(2, 1, 0)]), (c0, [(1, 0, LQ), (3, 2, LK)])],
        [(c1, [(2, 0, LQ)]), (c0, [(3, 1, LK)])],
        [(c0, [(3, 0, LQ | LK)])]]
    # one card: one launch a hop carrying every pair of the hop
    hops = TA.ring_hops(["cuda:0"] * 4, causal=True)
    assert [len(h) for h in hops] == [1] * 4
    assert [len(h[0][1]) for h in hops] == [4, 3, 2, 1]
    assert TA.ring_hops(["cpu"], causal=False) == [
        [(torch.device("cpu"), [(0, 0, F | LQ | LK)])]]


def test_plain_merge_leaves_accumulators_on_an_empty_partial(monkeypatch):
    """The plain K1 ring entry's merge: a pair whose rows have no key
    (the kernels' lse sentinel +1e30, the merge's identity) leaves those
    rows of (o_acc, lse_acc) bit for bit, merges the other rows, and on
    the shard's last pair writes out from the untouched accumulator and
    the lse in the kernels' form."""
    B, H, T, D, sp = 1, 2, 16, 4, 2
    rs = np.random.RandomState(3)
    q = torch.tensor(rs.randn(B, H, T, D).astype("float32"))
    o_acc = torch.tensor(rs.randn(B, H, T, D).astype("float32"))
    lse_acc = torch.tensor(rs.randn(B * H, T).astype("float32") * 4)
    lse_acc[0, 2] = -1e30               # an empty row in the carry too
    o_p = torch.tensor(rs.randn(B, H, T // sp, D).astype("float32"))
    lse_p = torch.tensor(rs.randn(B * H, T // sp).astype("float32"))
    empty = torch.zeros(B * H, T // sp, dtype=torch.bool)
    empty[0, :3] = True
    empty[1, 5] = True
    lse_p[empty] = 1e30
    o_p.reshape(B * H, T // sp, D)[empty] = 0.0
    monkeypatch.setattr(TA, "flash_attention_ref",
                        lambda *a, **kw: (o_p.clone(), lse_p.clone()))
    seeds = torch.zeros(sp, sp, dtype=torch.int32)
    for last in (False, True):
        o_a, l_a = o_acc.clone(), lse_acc.clone()
        out = torch.full_like(q, float("nan"))
        pairs = [(1, 0, TA.RING_LAST_Q if last else 0)]
        TA._fwd_ring_plain(q, q, q, None, seeds, pairs, o_a, l_a, out, 0.5,
                           0.0)
        rows = torch.zeros(B * H, T, dtype=torch.bool)
        rows[:, T // sp:] = empty
        o_now = (out if last else o_a).reshape(B * H, T, D)
        assert torch.equal(o_now[rows], o_acc.reshape(B * H, T, D)[rows])
        want_lse = lse_acc[rows]
        if last:
            want_lse = TA._kernel_lse(want_lse)
        assert torch.equal(l_a[rows], want_lse)
        # the other rows of shard 1 did merge; shard 0 is untouched
        moved = ~rows
        moved[:, :T // sp] = False
        assert (o_now[moved] != o_acc.reshape(B * H, T, D)[moved]).any()
        assert torch.equal(o_a[:, :, :T // sp], o_acc[:, :, :T // sp])
        assert torch.equal(l_a[:, :T // sp], lse_acc[:, :T // sp])


def test_cpu_ring_moves_no_launch_counter():
    n0 = [TA.flash_attention_fwd.launches, TA.flash_attention_bwd_dq.launches,
          TA.flash_attention_bwd_dkv.launches]
    q, k, v, g, mask = _inputs(1, 2, 32, 8)
    _port(q, k, v, mask, g, 4, True)
    assert [TA.flash_attention_fwd.launches,
            TA.flash_attention_bwd_dq.launches,
            TA.flash_attention_bwd_dkv.launches] == n0


def test_ring_contract_errors():
    q = torch.zeros(1, 2, 30, 8)
    with pytest.raises(ValueError, match="multiples of 4"):
        TA.ring_attention(q, q, q, None, ["cpu"] * 4)
    q = torch.zeros(1, 2, 32, 8)
    with pytest.raises(ValueError, match="device type"):
        TA.ring_attention(q, q, q, None, ["cuda:0"] * 4)
