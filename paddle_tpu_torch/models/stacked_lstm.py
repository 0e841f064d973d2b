"""Stacked LSTM sentiment model over variable-length text
(reference: benchmark/fluid/models/stacked_dynamic_lstm.py — IMDB,
emb 512 → N × [fc + lstm] → max-pool concat → softmax)."""
from __future__ import annotations

import paddle_tpu_torch as fluid


def stacked_lstm_net(data, dict_dim, class_dim=2, emb_dim=512, hid_dim=512,
                     stacked_num=3):
    emb = fluid.layers.embedding(data, [dict_dim, emb_dim])
    fc1 = fluid.layers.fc(emb, hid_dim * 4, num_flatten_dims=2)
    lstm1, cell1 = fluid.layers.dynamic_lstm(fc1, hid_dim * 4)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fluid.layers.fc(inputs[-1], hid_dim * 4, num_flatten_dims=2)
        lstm, cell = fluid.layers.dynamic_lstm(
            fc, hid_dim * 4, is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = fluid.layers.sequence_pool(inputs[0], "max")
    lstm_last = fluid.layers.sequence_pool(inputs[1], "max")
    prediction = fluid.layers.fc([fc_last, lstm_last], class_dim,
                                 act="softmax")
    return prediction


def build(dict_dim=30000, class_dim=2, emb_dim=512, hid_dim=512,
          stacked_num=3, lr=0.002, with_optimizer=True):
    data = fluid.layers.data("words", [1], dtype="int64", lod_level=1)
    label = fluid.layers.data("label", [1], dtype="int64")
    predict = stacked_lstm_net(data, dict_dim, class_dim, emb_dim, hid_dim,
                               stacked_num)
    cost = fluid.layers.cross_entropy(predict, label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(predict, label)
    if with_optimizer:
        fluid.optimizer.Adam(lr).minimize(avg_cost)
    return ["words", "label"], avg_cost, acc
