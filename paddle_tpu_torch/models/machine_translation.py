"""Attention seq2seq for machine translation (reference
benchmark/fluid/models/machine_translation.py:53,104 — bi-GRU encoder,
attention decoder trained with DynamicRNN, beam-search inference with the
While + TensorArray decode stack).

The port of ``paddle_tpu/models/machine_translation.py``: the same calls
build the reference's programs byte for byte.  ``mode="train"`` has two
``gru`` ops and the teacher-forced decoder as a ``static_rnn``
sub-block; ``mode="infer"`` has the same encoder and a ``while``
sub-block that runs one beam-search step an iteration.  Train and infer
programs share parameter names, so params trained with
``build(mode="train")`` load directly into ``build(mode="infer")``.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid
from paddle_tpu_torch.layers.nn import _tile_rows  # shared beam fan-out

L = fluid.layers


def _encoder(src_ids, src_vocab, emb_dim, hid, prefix="enc"):
    emb = L.embedding(src_ids, [src_vocab, emb_dim],
                      param_attr=fluid.ParamAttr(name=f"{prefix}.emb"))
    fwd_in = L.fc(emb, hid * 3, num_flatten_dims=2, bias_attr=False,
                  param_attr=fluid.ParamAttr(name=f"{prefix}.fwd_in.w"))
    fwd = L.dynamic_gru(fwd_in, hid,
                        param_attr=fluid.ParamAttr(name=f"{prefix}.fwd.w"),
                        bias_attr=fluid.ParamAttr(name=f"{prefix}.fwd.b"))
    bwd_in = L.fc(emb, hid * 3, num_flatten_dims=2, bias_attr=False,
                  param_attr=fluid.ParamAttr(name=f"{prefix}.bwd_in.w"))
    bwd = L.dynamic_gru(bwd_in, hid, is_reverse=True,
                        param_attr=fluid.ParamAttr(name=f"{prefix}.bwd.w"),
                        bias_attr=fluid.ParamAttr(name=f"{prefix}.bwd.b"))
    enc = L.concat([fwd, bwd], axis=2)                    # [B, T, 2H]
    return enc


def _attend(dec_h, enc_proj, enc_states, src_mask):
    """Dot attention: dec_h [B,H_d] vs enc_proj [B,T,H_d] → ctx [B,2H]."""
    scores = L.matmul(enc_proj, L.unsqueeze(dec_h, [2]))  # [B,T,1]
    scores = L.squeeze(scores, [2])                       # [B,T]
    neg = L.scale(L.elementwise_sub(src_mask,
                                    L.fill_constant_batch_size_like(
                                        src_mask, [-1, src_mask.shape[1]],
                                        "float32", 1.0)), scale=1e9)
    scores = L.elementwise_add(scores, neg)               # -1e9 on padding
    w = L.softmax(scores)                                 # [B,T]
    ctx = L.matmul(L.unsqueeze(w, [1]), enc_states)       # [B,1,2H]
    return L.squeeze(ctx, [1])


def _step_logits(cur_emb, h, enc_proj, enc_states, src_mask, hid, tgt_vocab):
    """One decoder step shared by train/infer: returns (new_h, logits)."""
    ctx = _attend(h, enc_proj, enc_states, src_mask)
    gate_in = L.fc([cur_emb, ctx, h], hid * 3, bias_attr=False,
                   param_attr=[fluid.ParamAttr(name="dec.gru_in.w_emb"),
                               fluid.ParamAttr(name="dec.gru_in.w_ctx"),
                               fluid.ParamAttr(name="dec.gru_in.w_h")])
    new_h = _gru_cell(gate_in, h, hid)
    logits = L.fc(new_h, tgt_vocab,
                  param_attr=fluid.ParamAttr(name="dec.out.w"),
                  bias_attr=fluid.ParamAttr(name="dec.out.b"))
    return new_h, logits


def _gru_cell(gates_x, h, hid):
    """Single GRU step from pre-projected x gates [B,3H] + state [B,H]
    (weights named for train/infer sharing)."""
    gates_h = L.fc(h, hid * 3, bias_attr=fluid.ParamAttr(name="dec.gru.b"),
                   param_attr=fluid.ParamAttr(name="dec.gru.w"))
    g = L.elementwise_add(gates_x, gates_h)               # [B, 3H]
    u = L.sigmoid(L.slice(g, axes=[1], starts=[0], ends=[hid]))
    r = L.sigmoid(L.slice(g, axes=[1], starts=[hid], ends=[2 * hid]))
    c_x = L.slice(gates_x, axes=[1], starts=[2 * hid], ends=[3 * hid])
    c_h = L.slice(gates_h, axes=[1], starts=[2 * hid], ends=[3 * hid])
    c = L.tanh(L.elementwise_add(c_x, L.elementwise_mul(r, c_h)))
    one_minus_u = L.scale(u, scale=-1.0, bias=1.0)
    return L.elementwise_add(L.elementwise_mul(u, h),
                             L.elementwise_mul(one_minus_u, c))


def build(src_vocab=10000, tgt_vocab=10000, emb_dim=256, hid=256,
          max_len=32, beam_size=4, mode="train", lr=1e-3,
          with_optimizer=True):
    """mode="train": returns (feed names, avg_cost).
    mode="infer": returns (feed names, BeamDecodeResult with sentence
    ids [B*beam, max_len], scores [B*beam, 1])."""
    src = L.data("src_ids", [max_len], dtype="int64")
    src_mask = L.data("src_mask", [max_len])
    enc = _encoder(src, src_vocab, emb_dim, hid)
    enc_proj = L.fc(enc, hid, num_flatten_dims=2, bias_attr=False,
                    param_attr=fluid.ParamAttr(name="dec.att_proj.w"))
    h0 = L.fc(_last_state(enc, src_mask), hid, act="tanh",
              param_attr=fluid.ParamAttr(name="dec.h0.w"),
              bias_attr=fluid.ParamAttr(name="dec.h0.b"))

    if mode == "train":
        tgt = L.data("tgt_ids", [max_len], dtype="int64")
        lbl = L.data("lbl_ids", [max_len], dtype="int64")
        tgt_mask = L.data("tgt_mask", [max_len])
        tgt_emb = L.embedding(tgt, [tgt_vocab, emb_dim],
                              param_attr=fluid.ParamAttr(name="dec.emb"))
        # teacher-forced decode as a StaticRNN over target steps
        rnn = L.StaticRNN()
        with rnn.step():
            cur = rnn.step_input(tgt_emb)                 # [B, emb]
            h = rnn.memory(init=h0)
            new_h, logits = _step_logits(cur, h, enc_proj, enc, src_mask,
                                         hid, tgt_vocab)
            rnn.update_memory(h, new_h)
            rnn.step_output(logits)
        logits_seq = rnn()                                # [B, T, V]
        loss = L.softmax_with_cross_entropy(
            logits_seq, L.unsqueeze(lbl, [2]))
        loss = L.squeeze(loss, [2])
        masked = L.elementwise_mul(loss, tgt_mask)
        avg_cost = L.elementwise_div(L.reduce_sum(masked),
                                     L.reduce_sum(tgt_mask))
        if with_optimizer:
            fluid.optimizer.Adam(lr).minimize(avg_cost)
        return (["src_ids", "src_mask", "tgt_ids", "lbl_ids", "tgt_mask"],
                avg_cost)

    # -- beam-search inference (While + TensorArray + beam_search ops) -----
    B = 1  # static batch for the decode loop; tile inputs to B*beam
    bw = B * beam_size
    start, end_id = 1, 2
    cand_ids = L.data("cand_ids", [tgt_vocab], dtype="int64")  # [bw, V] iota
    enc_t = _tile_rows(enc, beam_size)
    proj_t = _tile_rows(enc_proj, beam_size)
    mask_t = _tile_rows(src_mask, beam_size)
    h = _tile_rows(h0, beam_size)

    pre_ids = L.fill_constant([bw, 1], "int64", start)
    pre_scores = L.data("beam_seed", [1])                 # [bw,1] 0/-inf
    ids_arr = L.create_array("int64", [bw], max_len=max_len)
    par_arr = L.create_array("int64", [bw], max_len=max_len)
    score_arr = L.create_array("float32", [bw], max_len=max_len)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", max_len)
    cond = L.less_than(i, n)
    with L.While(cond).block():
        # ids [bw, 1]: the trailing-1 dim is squeezed by lookup_table,
        # giving [bw, emb] directly
        cur_emb = L.embedding(pre_ids, [tgt_vocab, emb_dim],
                              param_attr=fluid.ParamAttr(name="dec.emb"))
        new_h, logits = _step_logits(cur_emb, h, proj_t, enc_t, mask_t,
                                     hid, tgt_vocab)
        logp = L.log(L.softmax(logits))
        cand_scores = L.elementwise_add(logp, pre_scores)
        sel_ids, sel_scores, parent = L.beam_search(
            pre_ids, pre_scores, cand_ids, cand_scores,
            beam_size=beam_size, end_id=end_id)
        # beams were reordered: gather the decoder state by parent
        L.assign(L.gather(new_h, parent), h)
        L.array_write(L.squeeze(sel_ids, [1]), i, ids_arr)
        L.array_write(parent, i, par_arr)
        L.array_write(L.squeeze(sel_scores, [1]), i, score_arr)
        L.assign(sel_ids, pre_ids)
        L.assign(sel_scores, pre_scores)
        L.increment(i, 1)
        L.less_than(i, n, cond=cond)
    decode = L.beam_search_decode(ids_arr, par_arr, beam_size=beam_size,
                                  end_id=end_id, scores_array=score_arr)
    return (["src_ids", "src_mask", "cand_ids", "beam_seed"], decode,
            pre_scores)


def _last_state(enc, src_mask):
    """Masked last encoder state [B, 2H] (lengths from the mask sum)."""
    lens = L.cast(L.reduce_sum(src_mask, dim=1), "int32")
    from ..layers.nn import _alias_len
    _alias_len(enc, lens)
    return L.sequence_last_step(enc)
