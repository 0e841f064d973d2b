"""DeepFM-style CTR model with large sparse embeddings
(reference: python/paddle/fluid/tests/unittests/dist_ctr.py +
dist_ctr_reader.py — sparse embedding for categorical features, dense MLP,
joint sigmoid CTR loss).

The port of ``paddle_tpu/models/deepfm.py``: the same calls build the
reference's program byte for byte.  Its ``tp_sharding_rules`` (the
tables row-sharded over a model-parallel mesh axis) waits for the port's
multi-device plane."""
from __future__ import annotations

import paddle_tpu_torch as fluid


def ctr_deepfm(dense_input, sparse_ids, sparse_field_count, sparse_dim,
               embed_dim=10, fc_sizes=(400, 400, 400)):
    """dense_input [B, dense_dim]; sparse_ids [B, fields] int64 ids into a
    shared hash space of sparse_dim."""
    emb = fluid.layers.embedding(
        sparse_ids, [sparse_dim, embed_dim],
        param_attr=fluid.ParamAttr(
            name="ctr.sparse_emb",
            initializer=fluid.initializer.Uniform(-0.01, 0.01)),
        is_sparse=True)                            # [B, fields, embed_dim]
    # FM second-order term: 0.5*((Σv)² − Σv²)
    sum_emb = fluid.layers.reduce_sum(emb, dim=1)              # [B, k]
    sum_sq = fluid.layers.square(sum_emb)
    sq_emb = fluid.layers.square(emb)
    sq_sum = fluid.layers.reduce_sum(sq_emb, dim=1)
    fm = fluid.layers.scale(
        fluid.layers.elementwise_sub(sum_sq, sq_sum), scale=0.5)

    # first-order sparse term
    emb1 = fluid.layers.embedding(
        sparse_ids, [sparse_dim, 1],
        param_attr=fluid.ParamAttr(name="ctr.sparse_w1"),
        is_sparse=True)                            # [B, fields, 1]
    first = fluid.layers.reduce_sum(emb1, dim=1)   # [B, 1]

    # deep part
    flat = fluid.layers.reshape(emb, [0, emb.shape[1] * emb.shape[2]])
    deep = fluid.layers.concat([flat, dense_input], axis=1)
    for i, sz in enumerate(fc_sizes):
        deep = fluid.layers.fc(deep, sz, act="relu",
                               param_attr=fluid.ParamAttr(name=f"ctr.fc{i}.w"))
    deep_out = fluid.layers.fc(deep, 1)

    fm_out = fluid.layers.fc(fm, 1)
    logit = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(deep_out, fm_out), first)
    return logit


def build(dense_dim=13, sparse_fields=26, sparse_dim=int(1e5), embed_dim=10,
          lr=1e-4, with_optimizer=True):
    dense = fluid.layers.data("dense", [dense_dim])
    sparse = fluid.layers.data("sparse", [sparse_fields], dtype="int64")
    label = fluid.layers.data("label", [1])
    logit = ctr_deepfm(dense, sparse, sparse_fields, sparse_dim, embed_dim)
    loss = fluid.layers.sigmoid_cross_entropy_with_logits(logit, label)
    avg_cost = fluid.layers.mean(loss)
    if with_optimizer:
        fluid.optimizer.Adam(lr).minimize(avg_cost)
    return ["dense", "sparse", "label"], avg_cost, logit
