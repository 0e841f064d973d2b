"""Transformer-base encoder-decoder for WMT en-de.

Reference spec: ``python/paddle/fluid/tests/unittests/dist_transformer.py``
(Transformer-base: d_model=512, n_head=8, d_ffn=2048, 6+6 layers, shared
post-LN residual structure, noam LR schedule).

TPU-first layout: fixed max sequence length (padded; recompile-bucketed by
the feeder), batch-major [B, T, D], all attention matmuls batched 4-D on the
MXU.  Padding handled by an additive attention bias computed from the
``<name>@LEN`` companion lengths and by masking the token loss.  Under
ParallelExecutor, BuildStrategy.sharding_rules can shard the FFN and
attention projection weights over an ``mp`` axis (tensor parallelism) while
the batch is dp-sharded.
"""
from __future__ import annotations

import warnings

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.initializer import NormalInitializer, NumpyArrayInitializer


def _pos_encoding_table(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float64")
    dim = np.arange(d_model // 2)[None, :].astype("float64")
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table.astype("float32")


def _attn_bias_from_mask(mask_2d, n_head, T_q, causal=False, name=None):
    """mask_2d: [B, T_k] 1/0 validity → additive bias [B, 1, T_q, T_k]
    (broadcast over heads)."""
    bias = fluid.layers.scale(mask_2d, scale=1e9, bias=-1.0,
                              bias_after_scale=False)  # (m-1)*1e9
    bias = fluid.layers.unsqueeze(bias, [1, 2])  # [B,1,1,T_k]
    if causal:
        tri = np.triu(np.full((T_q, T_q), -1e9, "float32"), k=1)
        tri_v = fluid.layers.assign(tri)
        tri_v = fluid.layers.unsqueeze(tri_v, [0, 1])  # [1,1,T,T]
        bias = fluid.layers.elementwise_add(bias, tri_v)
    return bias


def multi_head_attention(q_in, k_in, v_in, attn_bias, d_model, n_head,
                         dropout_rate, param_prefix, kv_mask=None,
                         causal=False, impl="base"):
    d_key = d_model // n_head

    def proj(x, name):
        return fluid.layers.fc(
            x, d_model, num_flatten_dims=2, bias_attr=False,
            param_attr=fluid.ParamAttr(name=f"{param_prefix}.{name}.w"))

    q = proj(q_in, "q")
    k = proj(k_in, "k")
    v = proj(v_in, "v")

    def split_heads(x):
        x = fluid.layers.reshape(x, [0, 0, n_head, d_key])
        return fluid.layers.transpose(x, [0, 2, 1, 3])  # [B,H,T,dk]

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if impl != "base":
        if kv_mask is None:
            raise ValueError(
                "attention_impl != 'base' requires the [B,T] kv_mask "
                "(padding handled inside fused_attention)")
        from ..layer_helper import LayerHelper
        helper = LayerHelper(param_prefix + ".fa")
        ctx = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
        inputs = {"Q": [q], "K": [k], "V": [v], "KvMask": [kv_mask]}
        if dropout_rate:
            # per-step int32 seed for the attention-prob dropout (explicit
            # program input → fwd and grad see identical bits on any impl).
            # Drawn in the GLOBAL block: a stateful op inside a While/RNN
            # sub-block would make the sub-block non-differentiable.
            gb = helper.main_program.global_block
            u = gb.create_var(name=helper.name + ".seed_u", dtype="float32",
                              shape=(1,), stop_gradient=True)
            gb.append_op(
                "uniform_random", {}, {"Out": [u.name]},
                {"shape": [1], "dtype": "float32", "min": 0.0, "max": 2.0e9})
            seed = gb.create_var(name=helper.name + ".seed", dtype="int32",
                                 shape=(1,), stop_gradient=True)
            gb.append_op("cast", {"X": [u.name]}, {"Out": [seed.name]},
                         {"out_dtype": "int32"})
            inputs["Seed"] = [seed]
        helper.append_op(
            "fused_attention", inputs, {"Out": [ctx]},
            {"impl": impl, "causal": causal, "scale": d_key ** -0.5,
             "dropout_rate": dropout_rate})
    else:
        scores = fluid.layers.matmul(q, k, transpose_y=True, alpha=d_key ** -0.5)
        if attn_bias is not None:
            scores = fluid.layers.elementwise_add(scores, attn_bias)
        weights = fluid.layers.softmax(scores)
        if dropout_rate:
            weights = fluid.layers.dropout(
                weights, dropout_rate, dropout_implementation="upscale_in_train")
        ctx = fluid.layers.matmul(weights, v)  # [B,H,Tq,dk]
    ctx = fluid.layers.transpose(ctx, [0, 2, 1, 3])
    ctx = fluid.layers.reshape(ctx, [0, 0, d_model])
    return fluid.layers.fc(
        ctx, d_model, num_flatten_dims=2, bias_attr=False,
        param_attr=fluid.ParamAttr(name=f"{param_prefix}.out.w"))


def ffn(x, d_model, d_ffn, param_prefix):
    h = fluid.layers.fc(
        x, d_ffn, num_flatten_dims=2, act="relu",
        param_attr=fluid.ParamAttr(name=f"{param_prefix}.fc1.w"))
    return fluid.layers.fc(
        h, d_model, num_flatten_dims=2,
        param_attr=fluid.ParamAttr(name=f"{param_prefix}.fc2.w"))


def _residual(x, sub, dropout_rate, prefix):
    """post-LN residual (original transformer / dist_transformer.py)."""
    if dropout_rate:
        sub = fluid.layers.dropout(
            sub, dropout_rate, dropout_implementation="upscale_in_train")
    out = fluid.layers.elementwise_add(x, sub)
    return fluid.layers.layer_norm(
        out, begin_norm_axis=2,
        param_attr=fluid.ParamAttr(name=f"{prefix}.ln.scale"),
        bias_attr=fluid.ParamAttr(name=f"{prefix}.ln.bias"))


def encoder_layer(x, bias, d_model, n_head, d_ffn, dropout, prefix,
                  kv_mask=None, impl="base"):
    attn = multi_head_attention(x, x, x, bias, d_model, n_head, dropout,
                                f"{prefix}.attn", kv_mask=kv_mask, impl=impl)
    x = _residual(x, attn, dropout, f"{prefix}.attn")
    f = ffn(x, d_model, d_ffn, f"{prefix}.ffn")
    return _residual(x, f, dropout, f"{prefix}.ffn")


def decoder_layer(x, enc_out, self_bias, cross_bias, d_model, n_head, d_ffn,
                  dropout, prefix, src_mask=None, tgt_mask=None, impl="base"):
    attn = multi_head_attention(x, x, x, self_bias, d_model, n_head, dropout,
                                f"{prefix}.self", kv_mask=tgt_mask,
                                causal=True, impl=impl)
    x = _residual(x, attn, dropout, f"{prefix}.self")
    cross = multi_head_attention(x, enc_out, enc_out, cross_bias, d_model,
                                 n_head, dropout, f"{prefix}.cross",
                                 kv_mask=src_mask, impl=impl)
    x = _residual(x, cross, dropout, f"{prefix}.cross")
    f = ffn(x, d_model, d_ffn, f"{prefix}.ffn")
    return _residual(x, f, dropout, f"{prefix}.ffn")


def _embed(ids, mask, vocab, d_model, max_len, prefix, dtype):
    emb = fluid.layers.embedding(
        ids, [vocab, d_model], dtype=dtype,
        param_attr=fluid.ParamAttr(
            name=f"{prefix}.word_emb",
            initializer=NormalInitializer(0.0, d_model ** -0.5)))
    emb = fluid.layers.scale(emb, scale=d_model ** 0.5)
    T = ids.shape[1] if ids.shape[1] != -1 else max_len
    pos = fluid.layers.assign(_pos_encoding_table(max_len, d_model)[:T])
    emb = fluid.layers.elementwise_add(emb, pos, axis=1)
    # zero out padding positions
    return fluid.layers.elementwise_mul(emb, mask, axis=0)


def transformer(src_ids, tgt_ids, src_mask, tgt_mask, src_vocab, tgt_vocab,
                max_len=256, d_model=512, n_head=8, d_ffn=2048,
                n_layer=6, dropout=0.1, dtype="float32",
                attention_impl="base"):
    """Returns logits [B, T_tgt, tgt_vocab].

    masks: [B, T] float 1/0 validity (from @LEN companions or fed directly).
    """
    T_src, T_tgt = src_ids.shape[1], tgt_ids.shape[1]
    src_mask3 = fluid.layers.unsqueeze(src_mask, [2])
    tgt_mask3 = fluid.layers.unsqueeze(tgt_mask, [2])
    fused = attention_impl != "base"
    enc_bias = None if fused else _attn_bias_from_mask(src_mask, n_head, T_src)
    dec_self_bias = None if fused else _attn_bias_from_mask(
        tgt_mask, n_head, T_tgt, causal=True)
    dec_cross_bias = None if fused else _attn_bias_from_mask(src_mask, n_head, T_tgt)

    enc = _embed(src_ids, src_mask3, src_vocab, d_model, max_len, "src", dtype)
    if dropout:
        enc = fluid.layers.dropout(
            enc, dropout, dropout_implementation="upscale_in_train")
    for i in range(n_layer):
        enc = encoder_layer(enc, enc_bias, d_model, n_head, d_ffn, dropout,
                            f"enc.{i}", kv_mask=src_mask, impl=attention_impl)

    dec = _embed(tgt_ids, tgt_mask3, tgt_vocab, d_model, max_len, "tgt", dtype)
    if dropout:
        dec = fluid.layers.dropout(
            dec, dropout, dropout_implementation="upscale_in_train")
    for i in range(n_layer):
        dec = decoder_layer(dec, enc, dec_self_bias, dec_cross_bias, d_model,
                            n_head, d_ffn, dropout, f"dec.{i}",
                            src_mask=src_mask, tgt_mask=tgt_mask,
                            impl=attention_impl)

    logits = fluid.layers.fc(
        dec, tgt_vocab, num_flatten_dims=2, bias_attr=False,
        param_attr=fluid.ParamAttr(name="tgt.out_proj"))
    return logits


def build(src_vocab=30000, tgt_vocab=30000, max_len=64, d_model=512,
          n_head=8, d_ffn=2048, n_layer=6, dropout=0.1,
          warmup_steps=4000, with_optimizer=True, label_smoothing=0.0,
          dtype="float32", attention_impl="base"):
    """Train program over fixed-length padded batches.

    Feeds: src_ids [B,T], tgt_ids [B,T], lbl_ids [B,T] (tgt shifted),
    src_mask/tgt_mask [B,T] float.  Returns (feed names, avg_cost, token_acc).
    """
    src_ids = fluid.layers.data("src_ids", [max_len], dtype="int64",
                                append_batch_size=True)
    tgt_ids = fluid.layers.data("tgt_ids", [max_len], dtype="int64")
    lbl_ids = fluid.layers.data("lbl_ids", [max_len], dtype="int64")
    src_mask = fluid.layers.data("src_mask", [max_len])
    tgt_mask = fluid.layers.data("tgt_mask", [max_len])

    logits = transformer(src_ids, tgt_ids, src_mask, tgt_mask, src_vocab,
                         tgt_vocab, max_len, d_model, n_head, d_ffn, n_layer,
                         dropout, dtype, attention_impl)
    lbl = fluid.layers.unsqueeze(lbl_ids, [2])
    loss = fluid.layers.softmax_with_cross_entropy(logits, lbl)  # [B,T,1]
    loss = fluid.layers.squeeze(loss, [2])
    masked = fluid.layers.elementwise_mul(loss, tgt_mask)
    tok_count = fluid.layers.reduce_sum(tgt_mask)
    avg_cost = fluid.layers.elementwise_div(
        fluid.layers.reduce_sum(masked), tok_count)

    if with_optimizer:
        lr = fluid.layers.learning_rate_scheduler.noam_decay(
            d_model, warmup_steps)
        opt = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                                   epsilon=1e-9)
        opt.minimize(avg_cost)
    return (["src_ids", "tgt_ids", "lbl_ids", "src_mask", "tgt_mask"],
            avg_cost, tok_count)


def tp_sharding_rules():
    """Tensor-parallel PartitionSpecs for ParallelExecutor
    (BuildStrategy.sharding_rules): FFN + attention projections sharded over
    the ``mp`` mesh axis (Megatron layout: fc1/q/k/v column-, fc2/out
    row-parallel)."""
    return [
        (r".*\.ffn\.fc1\.w", (None, "mp")),
        (r".*\.ffn\.fc2\.w", ("mp", None)),
        (r".*\.attn\.(q|k|v)\.w", (None, "mp")),
        (r".*\.self\.(q|k|v)\.w", (None, "mp")),
        (r".*\.cross\.(q|k|v)\.w", (None, "mp")),
        (r".*\.(attn|self|cross)\.out\.w", ("mp", None)),
        (r".*word_emb", ("mp", None)),
        (r"tgt\.out_proj", (None, "mp")),
    ]
