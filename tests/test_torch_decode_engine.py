"""The port's DecodeEngine against the JAX package's, on the CPU.

The join/leave load of ``test_decode_plane.py`` (five requests onto three
slots, mixed greedy and seeded top-k/temperature sampling) yields the
same token stream per request from both engines, float32 and int8 KV
caches.  Greedy streams equal the port's own full re-forward.  Plus the
engine's lifecycle on the port: typed rejections, eos, cancel, drain,
faults on the scheduler thread reaching the handles, and refusing a KV
dtype the port does not have.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import decode as J
from paddle_tpu_torch import decode as T
from paddle_tpu_torch.kernels import attention as TA

TINY = dict(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
            max_seq_len=32)
ENGINE = dict(max_slots=3, block_tokens=4, prefill_buckets=(8, 16))


def _port_engine(name, **kw):
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    params = lm.init_params(seed=5)
    return lm, params, T.DecodeEngine(lm, params, name=name, device="cpu",
                                      **{**ENGINE, **kw})


def _load(pkg):
    """The join/leave load: some requests join only after earlier ones
    leave; even requests greedy, odd ones seeded top-k/temperature."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, TINY["vocab"], n).astype(np.int32)
               for n in (3, 7, 5, 11, 2)]
    budgets = (6, 3, 8, 4, 5)
    return [(p, pkg.SamplingParams(max_new_tokens=m,
                                   temperature=0.8 if i % 2 else 0.0,
                                   top_k=(4, 0)[i % 3 == 0], seed=100 + i))
            for i, (p, m) in enumerate(zip(prompts, budgets))]


def _run(engine, load):
    handles = [engine.submit(p, s) for p, s in load]
    return [h.result(timeout=120) for h in handles]


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_engine_streams_match_jax_engine_under_join_leave(cache_dtype,
                                                          tmp_path):
    """The port serves a model dir written by the JAX ``save_lm``."""
    jlm = J.TransformerLM(J.LMConfig(**TINY))
    jparams = jlm.init_params(seed=11)
    J.save_lm(str(tmp_path), jlm.config, jparams)
    jeng = J.DecodeEngine(jlm, jparams, name=f"tpar_j_{cache_dtype}",
                          cache_dtype=cache_dtype, **ENGINE)
    tlm, _ = T.load_lm(str(tmp_path), device="cpu")
    teng = T.DecodeEngine(tlm, name=f"tpar_t_{cache_dtype}", device="cpu",
                          cache_dtype=cache_dtype, **ENGINE)
    try:
        ref = _run(jeng, _load(J))
        got = _run(teng, _load(T))
    finally:
        jeng.close()
        teng.close()
    assert [r["tokens"] for r in got] == [r["tokens"] for r in ref]
    assert [r["finish"] for r in got] == ["length"] * 5
    assert teng.cache.allocator.leaked() == 0
    assert teng.cache.allocator.free_blocks == teng.cache.num_blocks - 1


def test_greedy_paged_decode_matches_port_full_reforward():
    """One causal re-forward of prompt + generated tokens gives every
    step's logits at once; the paged decode must agree token for token
    (logits within 1e-4)."""
    lm, _, eng = _port_engine("tpar_reforward", capture_logits=True)
    try:
        load = [(p, T.SamplingParams(max_new_tokens=s.max_new_tokens))
                for p, s in _load(T)]
        handles = [eng.submit(p, s) for p, s in load]
        for (p, s), h in zip(load, handles):
            tokens = h.result(timeout=120)["tokens"]
            assert len(tokens) == s.max_new_tokens
            seq = torch.tensor([list(p) + tokens[:-1]])
            ref = lm.full_logits(seq).numpy()[0, len(p) - 1:]
            np.testing.assert_allclose(np.stack(h.logits), ref, rtol=0,
                                       atol=1e-4)
            assert list(ref.argmax(-1)) == tokens
    finally:
        eng.close()


def test_cpu_engine_never_launches_the_kernel():
    before = TA.decode_attention.launches
    lm, _, eng = _port_engine("tpar_nokernel")
    try:
        eng.generate(np.arange(5, dtype=np.int32), max_new_tokens=4)
    finally:
        eng.close()
    assert TA.decode_attention.launches == before


def test_typed_rejections():
    _, _, eng = _port_engine("tpar_reject", max_queue=0)
    try:
        with pytest.raises(T.RequestTooLong):
            eng.submit(np.zeros(20, np.int32))       # off the ladder
        with pytest.raises(T.RequestTooLong):
            eng.submit(np.zeros(10, np.int32),
                       T.SamplingParams(max_new_tokens=30))  # past context
        with pytest.raises(T.Overloaded):
            eng.submit(np.zeros(4, np.int32),
                       T.SamplingParams(max_new_tokens=4))  # queue bound 0
        with pytest.raises(ValueError):
            eng.submit(np.zeros(0, np.int32))
        with pytest.raises(ValueError):       # ids outside the vocab
            eng.submit(np.array([0, TINY["vocab"]], np.int32))
        assert eng.stats.shed.value == 3
    finally:
        eng.close()


def test_eos_cancel_and_drain():
    _, _, eng = _port_engine("tpar_life")
    try:
        prompt = np.arange(5, dtype=np.int32)
        ref = eng.generate(prompt, max_new_tokens=6)
        out = eng.generate(prompt, max_new_tokens=6, eos_id=ref["tokens"][2])
        assert out["finish"] == "eos"
        assert out["tokens"] == ref["tokens"][:3]
        h = eng.submit(prompt, T.SamplingParams(max_new_tokens=20))
        assert h.next_token(timeout=30) == ref["tokens"][0]
        h.cancel()
        res = h.result(timeout=30)
        assert res["finish"] in ("cancelled", "length")
        assert eng.drain(timeout=30)
        assert eng.cache.allocator.free_blocks == eng.cache.num_blocks - 1
        assert eng.stats.joins.value == eng.stats.leaves.value == 3
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.arange(3, dtype=np.int32),
                   T.SamplingParams(max_new_tokens=2))


def test_fault_in_decode_step_reaches_every_handle():
    lm, _, eng = _port_engine("tpar_fault")
    try:
        def boom(*a, **kw):
            raise RuntimeError("injected decode-step fault")
        lm.decode_step = boom
        h = eng.submit(np.arange(4, dtype=np.int32),
                       T.SamplingParams(max_new_tokens=4))
        with pytest.raises(RuntimeError, match="injected"):
            h.result(timeout=30)
        assert h.tokens and len(h.tokens) == 1   # prefill's token only
        assert eng.cache.allocator.free_blocks == eng.cache.num_blocks - 1
        del lm.decode_step
        assert eng.generate(np.arange(4, dtype=np.int32),
                            max_new_tokens=3)["finish"] == "length"
    finally:
        eng.close()


def test_unported_options_raise():
    """A KV dtype the port has no kernel for is refused.  The prefix
    cache and overcommit are ported (``test_torch_decode_prefix.py``)."""
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    with pytest.raises(ValueError):
        T.DecodeEngine(lm, name="tpar_kvdtype", device="cpu",
                       cache_dtype="bfloat16")


def test_engine_without_device_raises_when_cuda_absent(monkeypatch):
    lm = T.TransformerLM(T.LMConfig(**TINY), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.DecodeEngine(lm, name="tpar_nodev")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.TransformerLM(T.LMConfig(**TINY))
