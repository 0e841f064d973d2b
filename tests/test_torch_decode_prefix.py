"""The port's refcounted block lifecycle against the JAX package's, on
the CPU: the refcounted allocator and its typed errors, the flags-off
free-list order, the prefix cache (chain keys, match/acquire/insert,
collisions served as misses, LRU park/revive/reclaim), the engine's
prefix hits with exact saved-token accounting, reclaim under pool
pressure with no leaked block, the flags-off surface, overcommit's
preemption and token-exact resume (greedy and sampled streams, float32
and int8 caches), and ``TransformerLM.prefill_suffix``.

Every scenario runs the same calls on both packages and compares what
they give: tokens exactly, counters exactly, suffix logits within 1e-5
of max|ref| and cache pools within 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import decode as J
from paddle_tpu.decode import cache as JC
from paddle_tpu_torch import decode as T
from paddle_tpu_torch.decode import cache as TC
from paddle_tpu_torch.observability import stats as tstats

TINY = dict(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
            max_seq_len=32)
ENGINE = dict(max_slots=3, block_tokens=4, prefill_buckets=(8, 16))
SUFFIX_REL = 1e-5      # suffix logits: within this of max|ref|
POOL_ATOL = 1e-6       # cache pools after a suffix prefill


def _engine(pkg, name, **kw):
    kw = {**ENGINE, **kw}
    if pkg is J:
        lm = J.TransformerLM(J.LMConfig(**TINY))
        return J.DecodeEngine(lm, lm.init_params(seed=5), name=name, **kw)
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    return T.DecodeEngine(lm, lm.init_params(seed=5), name=name,
                          device="cpu", **kw)


def _both(scenario):
    """The scenario's observations on the JAX package and on the port."""
    return scenario(JC), scenario(TC)


# ---------------------------------------------------------------------------
# allocator: refcounts, typed errors, the flags-off free-list order
# ---------------------------------------------------------------------------

def _refcounts(m):
    a = m.BlockAllocator(4)                 # blocks 1..3 usable
    (b,) = a.alloc(1)
    obs = [b, a.refcount(b)]
    a.incref(b)
    obs.append(a.refcount(b))
    free0 = a.free_blocks
    a.decref(b)                             # one sharer left: not freed
    obs += [a.refcount(b), a.free_blocks - free0]
    a.decref(b)                             # last reference: freed
    obs += [a.refcount(b), a.free_blocks - free0, a.leaked()]
    errors = []
    for call in (lambda: a.incref(2), lambda: a.decref(2),
                 lambda: a.decref(b), lambda: a.release([0])):
        try:
            call()
            errors.append(None)
        except ValueError:
            errors.append("ValueError")
    obs += [errors, a.alloc(99), a.leaked()]
    return obs


def test_allocator_refcounts_and_typed_errors():
    ref, got = _both(_refcounts)
    assert got == ref
    assert got[1:8] == [1, 2, 1, 0, 0, 1, 0]
    assert got[8] == ["ValueError"] * 4 and got[9] is None


def _free_list_order(m):
    a = m.BlockAllocator(8)                 # free: [1..7]
    g1, g2 = a.alloc(3), a.alloc(2)
    a.release(g1)                           # drop order
    obs = [g1, g2, list(a._free), a.alloc(4)]
    a.release(g2)
    return obs + [list(a._free), a.leaked()]


def test_allocator_single_owner_free_list_order_is_the_legacy_order():
    ref, got = _both(_free_list_order)
    assert got == ref
    assert got == [[1, 2, 3], [4, 5], [6, 7, 1, 2, 3], [6, 7, 1, 2],
                   [3, 4, 5], 0]


# ---------------------------------------------------------------------------
# prefix cache: chain keys, verify-on-hit, LRU park/revive/reclaim
# ---------------------------------------------------------------------------

def _chain_keys(m):
    pc = m.PrefixCache(m.BlockAllocator(8), 4, model_key="m1")
    toks = list(range(10))
    keys = pc.chain_keys(toks)
    other = m.PrefixCache(m.BlockAllocator(8), 4, model_key="m2")
    return [keys, pc.chain_keys(toks[:8]), pc.chain_keys([9] + toks[1:]),
            other.chain_keys(toks), m._fold_token(m._fnv1a64(b""), -3)]


def test_prefix_cache_chain_keys_cover_block_boundaries():
    ref, got = _both(_chain_keys)
    assert got == ref                       # the same 64-bit keys
    keys, first8, changed, other, _ = got
    assert len(keys) == 2 and first8 == keys and keys[0] != keys[1]
    assert changed[0] != keys[0] and other != keys


def _roundtrip(m):
    a = m.BlockAllocator(8)
    pc = m.PrefixCache(a, 4, model_key="m")
    toks = list(range(8))
    k1, k2 = pc.chain_keys(toks)
    b1, b2 = a.alloc(2)
    obs = [pc.insert(k1, toks[:4], b1), pc.insert(k2, toks, b2),
           pc.insert(k1, toks[:4], b1)]     # first writer wins
    hits = pc.match(toks + [40, 41], max_blocks=2)
    obs += [hits, [pc.acquire(k) for k, _ in hits], a.refcount(b1),
            pc.match(toks[:4] + [30, 31, 32, 33], 2), pc.holds(b1),
            pc.holds(7)]
    for b in (b1, b2):
        a.decref(b)
        a.decref(b)                         # zero-ref: parked, not freed
    obs += [pc.parked_blocks, a.free_blocks, a.leaked(pc.parked_blocks)]
    (hit,) = pc.match(toks[:4], 1)          # revive from the LRU
    obs += [pc.acquire(hit[0]), a.refcount(b1), pc.parked_blocks,
            pc.snapshot(), len(pc)]
    return obs


def test_prefix_cache_match_acquire_insert_roundtrip():
    ref, got = _both(_roundtrip)
    assert got == ref
    assert got[:3] == [True, True, False]
    assert got[4] == [1, 2] and got[5] == 2 and len(got[6]) == 1
    assert got[9:12] == [2, 5, 0] and got[12:15] == [1, 1, 1]


def _collision(m):
    a = m.BlockAllocator(8)
    pc = m.PrefixCache(a, 4, model_key="m")
    toks = list(range(4))
    (key,) = pc.chain_keys(toks)
    (blk,) = a.alloc(1)
    pc.insert(key, toks, blk)
    # the collision: the same key covering other tokens
    pc._entries[key] = (blk, tuple(range(100, 104)))
    return [pc.match(toks, 1), pc.collisions, pc.snapshot()]


def test_prefix_cache_hash_collision_served_as_miss():
    ref, got = _both(_collision)
    assert got == ref
    assert got[0] == [] and got[1] == 1 and got[2]["collisions"] == 1


def _lru(m):
    a = m.BlockAllocator(8)
    pc = m.PrefixCache(a, 2, model_key="m")
    toks = [7, 8, 9, 10, 11, 12]
    k1, k2, k3 = pc.chain_keys(toks)
    b1, b2, b3 = a.alloc(3)
    for k, n, b in ((k1, 2, b1), (k2, 4, b2), (k3, 6, b3)):
        pc.insert(k, toks[:n], b)
    for b in (b1, b2, b3):                  # park in age order 1, 2, 3
        a.decref(b)
    obs = [pc.parked_blocks, a.leaked(3), pc.match(toks[:4], 2)[-1],
           pc.acquire(k2)]
    a.decref(b2)                            # re-park: to the LRU tail
    obs += [pc.reclaim(2), pc.parked_blocks, list(a._free[-2:]),
            a.leaked(pc.parked_blocks), pc.match(toks, 3), [b1, b3]]
    return obs


def test_prefix_cache_lru_reclaims_oldest_and_repark_refreshes():
    ref, got = _both(_lru)
    assert got == ref
    assert got[0] == 3 and got[4:7] == [2, 1, got[9]]
    assert got[8] == []                     # evicted head: chain broken


# ---------------------------------------------------------------------------
# the engine: prefix hits, reclaim, the flags-off surface
# ---------------------------------------------------------------------------

P_A = np.arange(1, 9, dtype=np.int32)                  # 2 full blocks
P_B = np.concatenate([P_A, [9, 10]]).astype(np.int32)


def _prefix_run(pkg, name, dtype):
    eng = _engine(pkg, name, prefix_cache=True, cache_dtype=dtype)
    try:
        out = [eng.generate(P_A, max_new_tokens=4)["tokens"],
               eng.generate(P_B, max_new_tokens=4, temperature=0.7,
                            seed=4)["tokens"]]
        ps = eng._pstats
        z = eng.decodez()
        counters = dict(hits=ps.prefix_hits.value,
                        saved=ps.saved_prefill_tokens.value,
                        inserts=ps.prefix_inserts.value,
                        lookups=ps.prefix_lookups.value,
                        collisions=eng.prefix.collisions,
                        prefix_cache=z["prefix_cache"],
                        block_pool=z["block_pool"])
        assert eng.cache.allocator.leaked(eng.prefix.parked_blocks) == 0
    finally:
        eng.close()
    return out, counters


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_engine_prefix_hit_parity_and_exact_saved_tokens(dtype):
    """A prompt whose block-aligned prefix is cached gives the JAX
    engine's tokens and counters, and the flags-off engine's tokens;
    the saved-prefill accounting is exact (2 adopted blocks = 8)."""
    ref = _prefix_run(J, f"tpx_j_{dtype}", dtype)
    got = _prefix_run(T, f"tpx_t_{dtype}", dtype)
    assert got == ref
    toks, c = got
    assert (c["hits"], c["saved"], c["inserts"], c["lookups"]) == \
        (2, 8, 2, 3)
    assert c["block_pool"]["leaked"] == 0
    off = _engine(T, f"tpx_off_{dtype}", cache_dtype=dtype)
    try:
        assert [off.generate(P_A, max_new_tokens=4)["tokens"],
                off.generate(P_B, max_new_tokens=4, temperature=0.7,
                             seed=4)["tokens"]] == toks
    finally:
        off.close()


def _reclaim_run(pkg, name):
    pB = np.arange(20, 28, dtype=np.int32)              # disjoint content
    eng = _engine(pkg, name, prefix_cache=True, max_slots=2,
                  num_blocks=5)                          # 4 usable blocks
    try:
        a = eng.generate(P_A, max_new_tokens=4)["tokens"]
        parked = eng.prefix.parked_blocks                # 2 full blocks
        # pB needs 3 blocks, 2 are free: one parked block is reclaimed
        b = eng.generate(pB, max_new_tokens=4)["tokens"]
        ps = eng._pstats
        return [a, b, parked, ps.prefix_evictions.value,
                eng.prefix.parked_blocks, eng.decodez()["block_pool"]], eng
    except BaseException:
        eng.close()
        raise


def test_engine_prefix_reclaim_under_pressure_and_no_leak():
    ref, jeng = _reclaim_run(J, "tpx_evict_j")
    jeng.close()
    got, eng = _reclaim_run(T, "tpx_evict_t")
    try:
        assert got == ref
        assert got[2] == 2 and got[3] >= 1
        # a cancel mid-stream releases the slot's blocks too
        h = eng.submit(np.arange(30, 36, dtype=np.int32),
                       T.SamplingParams(max_new_tokens=8))
        assert h.next_token(timeout=30) is not None
        h.cancel()
        assert h.result(timeout=30)["finish"] == "cancelled"
        assert eng.drain(timeout=30)
        assert eng.cache.allocator.leaked(eng.prefix.parked_blocks) == 0
        assert eng._pstats.blocks_leaked.value == 0
        assert eng.decodez()["block_pool"]["leaked"] == 0
    finally:
        eng.close()


def test_engine_flags_off_surface_is_byte_identical():
    """Both flags off: no PrefixCache, no ``block_pool`` /
    ``prefix_cache`` / ``preemption`` cards, and not one
    ``prefix_* / cow_* / preempt* / blocks_*`` series."""
    eng = _engine(T, "tpx_flags_off")
    try:
        eng.generate(np.arange(1, 7, dtype=np.int32), max_new_tokens=3)
        assert eng.prefix is None and eng._pstats is None
        z = eng.decodez()
        for card in ("block_pool", "prefix_cache", "preemption"):
            assert card not in z
        names = tstats.default_registry().to_dict().keys()
        bad = [n for n in names if n.startswith("decode.tpx_flags_off.")
               and any(t in n for t in ("prefix", "cow", "preempt",
                                        "blocks_referenced",
                                        "blocks_cached", "blocks_leaked"))]
        assert bad == []
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# overcommit: preemption + token-exact re-prefill resume
# ---------------------------------------------------------------------------

OC_PROMPTS = [np.arange(1 + 7 * i, 7 + 7 * i, dtype=np.int32)
              for i in range(3)]                         # 6 tokens each


def _oc_sampling(pkg, sampled):
    # the newest stream (the one preempted) samples in the sampled case:
    # its resume must re-derive token index n_generated from the hash
    return [pkg.SamplingParams(max_new_tokens=10,
                               temperature=0.9 if sampled else 0.0,
                               top_k=(0, 6, 0)[i], seed=31 + i)
            for i in range(3)]


def _oc_run(pkg, name, dtype, sampled, **kw):
    eng = _engine(pkg, name, prefill_buckets=(8,), cache_dtype=dtype, **kw)
    try:
        hs = [eng.submit(p, s) for p, s in
              zip(OC_PROMPTS, _oc_sampling(pkg, sampled))]
        res = [h.result(timeout=120) for h in hs]
        out = [[r["tokens"] for r in res], [r["finish"] for r in res]]
        if eng._pstats is not None:
            ps = eng._pstats
            z = eng.decodez()
            out += [ps.preempts.value, ps.preempt_resumes.value,
                    ps.reprefill_tokens.value, z["preemption"],
                    z["block_pool"]]
            assert eng.cache.allocator.leaked() == 0
    finally:
        eng.close()
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_overcommit_preempt_resume_is_loss_free(dtype, sampled):
    """Three streams through a pool that holds two (4 blocks each at
    full length, 8 usable blocks): the port preempts and resumes as the
    JAX engine does, counter for counter, and every stream's tokens
    equal both the JAX engine's and a fully reserved engine's."""
    tag = f"{dtype}_{'s' if sampled else 'g'}"
    small = dict(num_blocks=9, overcommit=True)
    ref = _oc_run(J, f"toc_j_{tag}", dtype, sampled, **small)
    got = _oc_run(T, f"toc_t_{tag}", dtype, sampled, **small)
    assert got == ref
    assert got[1] == ["length"] * 3
    preempts, resumes, reprefill, card, pool = got[2:]
    assert preempts >= 1 and resumes >= 1 and reprefill >= 1
    assert card["preempts"] == preempts
    assert pool["leaked"] == 0 and pool["overcommit"] is True
    reserved = _oc_run(T, f"toc_full_{tag}", dtype, sampled)
    assert reserved[0] == got[0]


# ---------------------------------------------------------------------------
# TransformerLM.prefill_suffix against the JAX package's
# ---------------------------------------------------------------------------

BS, NB = 4, 12
MB = TINY["max_seq_len"] // BS


@pytest.fixture(scope="module")
def models():
    jlm = J.TransformerLM(J.LMConfig(**TINY))
    params = jlm.init_params(seed=5)
    tlm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    tlm.load_numpy(params)
    jlm.prefill = jax.jit(jlm.prefill)
    jlm.prefill_suffix = jax.jit(jlm.prefill_suffix)
    return jlm, jlm.param_list(params), tlm


def _run(jlm, plist, tlm, jc, tc, method, toks, ints, table, seed, temp,
         topk):
    """One prefill-type dispatch on both packages; returns (jtok, jlog,
    ttok, tlog) and leaves both caches updated."""
    quant = jc.quantized
    jargs = ([jnp.asarray(toks)] + [jnp.int32(i) for i in ints]
             + [jnp.asarray(table, jnp.int32), jnp.uint32(seed),
                jnp.float32(temp), jnp.int32(topk)])
    jk = dict(ks=jc.k_scale, vs=jc.v_scale) if quant else {}
    out = getattr(jlm, method)(plist, jc.k, jc.v, *jargs, **jk)
    jc.update(list(out[:4] if quant else out[:2]))
    targs = ([torch.from_numpy(toks)] + [torch.tensor(i) for i in ints]
             + [torch.from_numpy(np.asarray(table, np.int32)),
                torch.tensor(seed), torch.tensor(temp), torch.tensor(topk)])
    st = tc.state()
    tk = dict(ks=st[2], vs=st[3]) if quant else {}
    ttok, tlog = getattr(tlm, method)(st[0], st[1], *targs, **tk)
    return int(out[-2]), np.asarray(out[-1]), int(ttok), tlog.numpy()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_prefill_suffix_matches_jax(models, dtype):
    """A 9-token prompt prefills its first 8 (two full blocks); then
    prefill_suffix runs positions 8..L-1 against that resident prefix:
    a 5-token suffix padded to 8 lanes, greedy and sampled."""
    jlm, plist, tlm = models
    L_, H, Dh = TINY["n_layer"], TINY["n_head"], TINY["d_model"] // 2
    jc = JC.PagedKVCache(L_, H, Dh, NB, BS, dtype=dtype)
    tc = TC.PagedKVCache(L_, H, Dh, NB, BS, dtype=dtype, device="cpu")
    rng = np.random.RandomState(7)
    seq = rng.randint(0, TINY["vocab"], 13).astype(np.int32)
    table = np.zeros(MB, np.int32)
    table[:4] = [5, 2, 9, 3]
    head = np.zeros((1, 8), np.int32)
    head[0] = seq[:8]
    _run(jlm, plist, tlm, jc, tc, "prefill", head, [8], table, 0, 0.0, 0)
    sfx = np.zeros((1, 8), np.int32)
    sfx[0, :5] = seq[8:]
    for seed, temp, topk in ((0, 0.0, 0), (12, 0.8, 5)):
        jt, jl, tt, tl = _run(jlm, plist, tlm, jc, tc, "prefill_suffix",
                              sfx, [8, 13], table, seed, temp, topk)
        assert tt == jt
        np.testing.assert_allclose(
            tl, jl, rtol=0, atol=SUFFIX_REL * np.abs(jl).max())
        for j, t in zip(jc.state(), tc.state()):
            np.testing.assert_allclose(t.numpy().astype(np.float64),
                                       np.asarray(j).astype(np.float64),
                                       rtol=0, atol=POOL_ATOL)
    # and the port's suffix logits equal its own full forward's last row
    full = tlm.full_logits(torch.from_numpy(seq[None]))[0, -1].numpy()
    if dtype == "float32":
        np.testing.assert_allclose(tl, full, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# int8 caches: a stream's tokens depend on its blocks' history, in the
# reference as in the port
# ---------------------------------------------------------------------------

HIST = dict(vocab=300, d_model=64, n_head=2, d_ffn=96, n_layer=2,
            max_seq_len=128)


def _history_run(pkg, name, overcommit):
    """8 int8 streams (prompt 16, 48 new tokens) through a pool that
    holds half their full reservations."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, HIST["vocab"], 16).astype(np.int32)
               for _ in range(8)]
    kw = dict(name=name, max_slots=8, block_tokens=16, num_blocks=17,
              prefill_buckets=(16, 32, 64), cache_dtype="int8",
              overcommit=overcommit)
    if pkg is J:
        lm = J.TransformerLM(J.LMConfig(**HIST))
        eng = J.DecodeEngine(lm, lm.init_params(seed=7), **kw)
    else:
        lm = T.TransformerLM(T.LMConfig(**HIST), device="cpu")
        eng = T.DecodeEngine(lm, lm.init_params(seed=7), device="cpu", **kw)
    try:
        hs = [eng.submit(p, pkg.SamplingParams(max_new_tokens=48))
              for p in prompts]
        toks = [h.result(timeout=120)["tokens"] for h in hs]
        return toks, (eng._pstats.preempts.value if overcommit else 0)
    finally:
        eng.close()


def test_int8_overcommit_departs_from_reserved_as_the_reference_does():
    """A block handed to a stream keeps its last owner's scale, which
    the decode step's append takes as a floor, and a resumed stream's
    re-prefill quantizes its blocks once at their final scales: so an
    int8 stream's tokens depend on which blocks it got and when.  The
    port keeps the reference's behaviour: both engines give the same
    tokens in both runs, and the same streams depart from the reserved
    run (``ROADMAP.md`` queue 3)."""
    out = {}
    for pkg in (J, T):
        tag = "j" if pkg is J else "t"
        full, _ = _history_run(pkg, f"thist_full_{tag}", False)
        oc, preempts = _history_run(pkg, f"thist_oc_{tag}", True)
        out[tag] = (full, oc, preempts,
                    [i for i in range(8) if full[i] != oc[i]])
    assert out["t"] == out["j"]
    full, oc, preempts, departed = out["t"]
    assert preempts >= 1 and departed
    assert all(a[0] == b[0] for a, b in zip(full, oc))   # prefill's token
