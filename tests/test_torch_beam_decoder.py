"""Beam-search decoders on the port: ``contrib.decoder``'s
``IncrementalBeamDecoder`` against the whole-sequence
``BeamSearchDecoder`` and against the reference's
``IncrementalBeamDecoder``, and ``decode.PagedBeamDecoder`` (beam search
over the paged KV cache by copy-on-write block forking) against its own
eager-copy baseline and against the reference's ``PagedBeamDecoder`` on
the same ``init_params(seed=5)`` weights; K4's plain version on one beam
step's aliased block tables against the reference's kernel.

Tolerances: the port against itself exactly (the same ops on the same
values); the incremental decoders of both packages exactly (the same
candidate stream through ``log`` -> ``elementwise_add`` ->
``beam_search`` -> ``beam_search_decode``); the paged decoders' ids and
candidate lengths exactly and their scores within 1e-5 (two LMs' float32
logits, ranked identically in numpy on the host).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from chip_smoke import k4_beam_calls
from paddle_tpu.kernels import attention as JA
from paddle_tpu.contrib.decoder import \
    IncrementalBeamDecoder as JIncrementalBeamDecoder
from paddle_tpu.decode.beam import PagedBeamDecoder as JPagedBeamDecoder
from paddle_tpu.decode.model import LMConfig as JLMConfig
from paddle_tpu.decode.model import TransformerLM as JTransformerLM
from paddle_tpu_torch.contrib.decoder import (BeamSearchDecoder,
                                              IncrementalBeamDecoder,
                                              InitState, StateCell)
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.core.program import Program, program_guard
from paddle_tpu_torch.decode import LMConfig, PagedBeamDecoder, TransformerLM
from paddle_tpu_torch.kernels import attention as TA

L = tfluid.layers

V, EMB, HID, T = 12, 16, 32, 6
END_ID = 1
TINY = dict(vocab=48, d_model=32, n_head=2, d_ffn=48, n_layer=2,
            max_seq_len=32)
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2], dtype=np.int32)
SCORE_TOL = 1e-5


def _exe():
    return tfluid.Executor("cpu", training=False)


def _mt_beam_programs(beam):
    """The machine-translation decoder pattern both ways
    (tests/test_contrib_decoder.py:181): the whole-sequence
    BeamSearchDecoder program, plus the h0 bootstrap and one-step cell
    programs the incremental path drives, sharing parameter names."""
    infer, istart = Program(), Program()
    with program_guard(infer, istart), unique_name.guard():
        src = L.data("src", [1], dtype="int64", lod_level=1)
        src_emb = L.embedding(
            src, [V, EMB], param_attr=tfluid.ParamAttr(name="dec.src_emb"))
        enc = L.sequence_pool(src_emb, "first")
        h0 = L.fc(enc, HID, act="tanh",
                  param_attr=tfluid.ParamAttr(name="dec.h0.w"),
                  bias_attr=tfluid.ParamAttr(name="dec.h0.b"))
        cell = StateCell(inputs={"x": None},
                         states={"h": InitState(init=h0)}, out_state="h")

        @cell.state_updater
        def updater(c):
            h = c.get_state("h")
            x = c.get_input("x")
            c.set_state(
                "h", L.fc(L.concat([x, h], axis=1), HID, act="tanh",
                          param_attr=tfluid.ParamAttr(name="dec.cell.w"),
                          bias_attr=tfluid.ParamAttr(name="dec.cell.b")))

        init_ids = L.data("init_ids", [1], dtype="int64")
        init_scores = L.data("init_scores", [1])
        decoder = BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=V, word_dim=EMB, topk_size=V,
            sparse_emb=False, max_len=T, beam_size=beam, end_id=END_ID,
            emb_param_attr=tfluid.ParamAttr(name="dec.tgt_emb"),
            score_param_attr=tfluid.ParamAttr(name="dec.out.w"),
            score_bias_attr=tfluid.ParamAttr(name="dec.out.b"))
        decoder.decode()

    h0p = Program()
    with program_guard(h0p, Program()), unique_name.guard():
        src = L.data("src", [1], dtype="int64", lod_level=1)
        semb = L.embedding(
            src, [V, EMB], param_attr=tfluid.ParamAttr(name="dec.src_emb"))
        enc = L.sequence_pool(semb, "first")
        h0v = L.fc(enc, HID, act="tanh",
                   param_attr=tfluid.ParamAttr(name="dec.h0.w"),
                   bias_attr=tfluid.ParamAttr(name="dec.h0.b"))

    stepp = Program()
    with program_guard(stepp, Program()), unique_name.guard():
        pre = L.data("pre_ids", [1], dtype="int64")
        hin = L.data("h_in", [HID])
        emb = L.embedding(
            pre, [V, EMB], param_attr=tfluid.ParamAttr(name="dec.tgt_emb"))
        hout = L.fc(L.concat([emb, hin], axis=1), HID, act="tanh",
                    param_attr=tfluid.ParamAttr(name="dec.cell.w"),
                    bias_attr=tfluid.ParamAttr(name="dec.cell.b"))
        probs = L.fc(hout, V, act="softmax",
                     param_attr=tfluid.ParamAttr(name="dec.out.w"),
                     bias_attr=tfluid.ParamAttr(name="dec.out.b"))
        tk_s, tk_i = L.topk(probs, k=V)
    return ((infer, istart, decoder), (h0p, h0v),
            (stepp, [hout.name, tk_i.name, tk_s.name]))


def test_incremental_beam_matches_whole_sequence_exactly():
    """The reference's pin (tests/test_contrib_decoder.py:226) on the
    port: beam state carried across dispatches through
    IncrementalBeamDecoder reproduces the whole-sequence While program's
    beam_search_decode output exactly (ids, per-step scores, candidate
    lengths).  A frozen carried state (the reference's fixed
    BeamSearchDecoder bug) would break it."""
    beam = 3
    rng = np.random.RandomState(0)
    scope, exe = tfluid.Scope(), _exe()
    (infer, istart, decoder), (h0p, h0v), (stepp, fetches) = \
        _mt_beam_programs(beam)
    with tfluid.scope_guard(scope):
        exe.run(istart)
        src1 = rng.randint(2, V, (1, T)).astype("int64")
        feed = {"src": src1[..., None],
                "src@LEN": np.full((1,), T, "int64"),
                "init_ids": np.zeros((beam, 1), "int64"),
                "init_scores": np.array([[0.0]] + [[-1e9]] * (beam - 1),
                                        "float32")}
        res_w = decoder.result
        ids_w, sc_w, cl_w = exe.run(
            infer, feed=feed,
            fetch_list=[res_w.ids.name, res_w.scores.name,
                        res_w.cand_len.name])
        h0_val, = exe.run(
            h0p, feed={"src": src1[..., None],
                       "src@LEN": np.full((1,), T, "int64")},
            fetch_list=[h0v.name])
        h = np.tile(h0_val, (beam, 1))   # beam fan-out
        ibd = IncrementalBeamDecoder(beam_size=beam, end_id=END_ID,
                                     topk_size=V, executor=exe)
        ibd.start()
        for _ in range(T):
            h_new, cand_ids, cand_probs = exe.run(
                stepp, feed={"pre_ids": ibd.pre_ids, "h_in": h},
                fetch_list=fetches)
            _sel, parent = ibd.step(cand_ids, cand_probs)
            # carried model state follows its parent
            h = h_new[parent]
        assert ibd.steps == T
        res = ibd.finalize()
    assert ids_w.shape == (beam, T)
    np.testing.assert_array_equal(ids_w, res.ids)
    np.testing.assert_array_equal(cl_w, res.cand_len)
    np.testing.assert_array_equal(sc_w, res.scores)
    # the carried state moved: not every step's top hypothesis repeats
    # the first token
    assert len(set(res.ids[0].tolist())) > 1


def _candidate_stream(beam, k, steps, seed):
    """Seeded [beam, k] candidate ids and softmax probabilities a step,
    with exact ties and one end_id candidate, so beams finish."""
    rs = np.random.RandomState(seed)
    out = []
    for s in range(steps):
        ids = np.stack([rs.permutation(20)[:k] for _ in range(beam)])
        logits = np.round(rs.randn(beam, k), 1)
        if s == 1:   # beam 0's best candidate ends it
            ids[0, 0], logits[0, 0] = END_ID, logits.max() + 3.0
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        out.append((ids.astype("int64"), p.astype("float32")))
    return out


def test_incremental_decoder_equals_reference_exactly():
    """The port's IncrementalBeamDecoder and the reference's fed the
    same seeded candidate stream: every step's selections and parents,
    and the final ids, scores and lengths, bit for bit."""
    beam, k, steps = 4, 5, 7
    mine = IncrementalBeamDecoder(beam, END_ID, k, executor=_exe())
    ref = JIncrementalBeamDecoder(beam, END_ID, k)
    mine.start()
    ref.start()
    for ids, probs in _candidate_stream(beam, k, steps, seed=11):
        got = mine.step(ids, probs)
        want = ref.step(ids, probs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    got, want = mine.finalize(), ref.finalize()
    for name in ("ids", "scores", "cand_len", "src_len"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.cand_len < steps).any()     # some beam finished


def test_incremental_decoder_contract_errors():
    ibd = IncrementalBeamDecoder(beam_size=2, end_id=END_ID, topk_size=4,
                                 executor=_exe())
    with pytest.raises(ValueError, match="finalize"):
        ibd.finalize()


def test_state_cell_contract_errors():
    prog, startup = Program(), Program()
    with program_guard(prog, startup), unique_name.guard():
        x = L.data("x", [4])
        h0 = L.fc(x, 8)
        with pytest.raises(ValueError, match="out_state"):
            StateCell(inputs={"x": None}, states={"h": InitState(init=h0)},
                      out_state="missing")
        with pytest.raises(ValueError, match="InitState"):
            StateCell(inputs={"x": None}, states={"h": h0}, out_state="h")
        cell = StateCell(inputs={"x": None},
                         states={"h": InitState(init=h0)}, out_state="h")
        with pytest.raises(ValueError, match="Invalid input"):
            cell.get_input("x")  # placeholder never fed
        with pytest.raises(ValueError, match="init_boot"):
            InitState(shape=[8])


def _lm():
    lm = TransformerLM(LMConfig(**TINY), device="cpu")
    lm.init_params(seed=5)
    return lm


def _paged(lm, name, share_prefix, beam=3):
    return PagedBeamDecoder(lm, beam_size=beam, end_id=TINY["vocab"] - 1,
                            name=name, block_tokens=4,
                            share_prefix=share_prefix,
                            executor=_exe())


def test_beam_cow_forking_matches_eager_copy_bit_exact():
    """The reference's pin (tests/test_decode_prefix.py:322) on the
    port: COW forking and the eager-copy baseline give the same ids and
    scores bit for bit, with fewer block copies, forks only on divergent
    writes, no leaked block, and a clean pool on session reuse."""
    lm = _lm()
    shared = _paged(lm, "bx_cow", True)
    eager = _paged(lm, "bx_base", False)
    try:
        rs = shared.decode(PROMPT, max_steps=6)
        assert shared.leaked() == 0
        re_ = eager.decode(PROMPT, max_steps=6)
        assert eager.leaked() == 0
        np.testing.assert_array_equal(rs.ids, re_.ids)
        np.testing.assert_array_equal(rs.scores, re_.scores)
        np.testing.assert_array_equal(rs.cand_len, re_.cand_len)
        assert shared.cow_forks >= 1
        assert shared.block_copies < eager.block_copies
        rs2 = shared.decode(PROMPT, max_steps=6)
        np.testing.assert_array_equal(rs2.ids, rs.ids)
        assert shared.leaked() == 0
    finally:
        shared.close()
        eager.close()
    assert shared.leaked() == 0 and eager.leaked() == 0
    assert shared.cache.allocator.referenced_blocks == 0


@pytest.mark.parametrize("share_prefix", [True, False])
def test_paged_beam_decoder_matches_reference(share_prefix):
    """The same init_params(seed=5) weights in both packages: ids and
    candidate lengths equal, scores within 1e-5; on the CPU the decode
    steps attend through K4's plain version (no launch)."""
    jlm = JTransformerLM(JLMConfig(**TINY))
    params = jlm.init_params(seed=5)
    ref = JPagedBeamDecoder(jlm, params, beam_size=3,
                            end_id=TINY["vocab"] - 1, name="ref",
                            block_tokens=4, share_prefix=share_prefix)
    want = ref.decode(PROMPT, max_steps=8)
    mine = _paged(_lm(), "port", share_prefix)
    n0 = TA.decode_attention.launches
    got = mine.decode(PROMPT, max_steps=8)
    assert TA.decode_attention.launches == n0
    assert got.ids.shape == (3, 8)
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_array_equal(got.cand_len, np.asarray(want.cand_len))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    assert mine.leaked() == 0
    mine.close()
    assert mine.leaked() == 0


def test_beam_step_attention_over_shared_blocks_matches_reference():
    """K4 on the paged beam path: the last beam step's own inputs, after
    the forks, with lanes whose block tables share blocks, through the
    port's ``decode_attention`` (its plain version on CPU tensors) and
    the reference's Pallas kernel in interpret mode, at 1e-5; the
    output the decode used equals a rerun."""
    dec = _paged(_lm(), "k4", True)
    calls = []
    with k4_beam_calls(calls, TINY["n_layer"]):
        dec.decode(PROMPT, max_steps=8)
    assert dec.cow_forks >= 1 and len(calls) == TINY["n_layer"]
    for (q, kc, vc, bt, cl), out in calls:
        bs = kc.shape[1]
        lanes = [set(bt[j, :-(-int(c) // bs)].tolist())
                 for j, c in enumerate(cl)]
        assert any(a & b for j, a in enumerate(lanes) for b in lanes[j + 1:])
        np.testing.assert_array_equal(
            TA.decode_attention(q, kc, vc, bt, cl).numpy(), out.numpy())
        ref = JA.decode_attention(
            *(jnp.asarray(x.numpy()) for x in (q, kc, vc, bt, cl)),
            impl="pallas")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
    dec.close()
    assert dec.leaked() == 0


def test_paged_beam_decoder_contract_errors():
    dec = _paged(_lm(), "errs", True)
    with pytest.raises(ValueError, match="empty prompt"):
        dec.decode(np.zeros((0,), np.int32), max_steps=2)
    with pytest.raises(ValueError, match="context bound"):
        dec.decode(PROMPT, max_steps=TINY["max_seq_len"])
    assert dec.leaked() == 0
