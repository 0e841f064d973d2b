"""Attention seq2seq for machine translation (reference
benchmark/fluid/models/machine_translation.py:53,104 — bi-GRU encoder,
attention decoder trained with DynamicRNN, beam-search inference with the
While + TensorArray decode stack).

The port of ``paddle_tpu/models/machine_translation.py``: with
``mode="train"`` the same calls build the reference's program byte for
byte (two ``gru`` ops, the teacher-forced decoder a ``static_rnn``
sub-block).  ``mode="infer"`` raises ``NotImplementedError``: its
beam-search loop needs ``While``, the TensorArray ops, ``beam_search``,
``beam_search_decode`` and ``gather``, which are not ported yet.
"""
from __future__ import annotations

import paddle_tpu_torch as fluid

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
    mode="infer" (beam-search decoding) raises NotImplementedError: it
    needs While, the TensorArray ops, beam_search, beam_search_decode and
    gather, which are not ported yet."""
    if mode != "train":
        raise NotImplementedError(
            f"machine_translation.build(mode={mode!r}): beam-search "
            "inference needs While, the TensorArray ops, beam_search, "
            "beam_search_decode and gather, which are not ported yet")
    src = L.data("src_ids", [max_len], dtype="int64")
    src_mask = L.data("src_mask", [max_len])
    enc = _encoder(src, src_vocab, emb_dim, hid)
    enc_proj = L.fc(enc, hid, num_flatten_dims=2, bias_attr=False,
                    param_attr=fluid.ParamAttr(name="dec.att_proj.w"))
    h0 = L.fc(_last_state(enc, src_mask), hid, act="tanh",
              param_attr=fluid.ParamAttr(name="dec.h0.w"),
              bias_attr=fluid.ParamAttr(name="dec.h0.b"))

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


def _last_state(enc, src_mask):
    """Masked last encoder state [B, 2H] (lengths from the mask sum)."""
    lens = L.cast(L.reduce_sum(src_mask, dim=1), "int32")
    from ..layers.nn import _alias_len
    _alias_len(enc, lens)
    return L.sequence_last_step(enc)
