"""MNIST convnet (reference: benchmark/fluid/models/mnist.py cnn_model).

The port of ``paddle_tpu/models/mnist.py``: the same calls build the
reference's program byte for byte."""
from __future__ import annotations

import paddle_tpu_torch as fluid


def cnn_model(data):
    conv_pool_1 = fluid.layers.conv2d(data, 20, 5, act="relu")
    pool_1 = fluid.layers.pool2d(conv_pool_1, 2, "max", 2)
    conv_pool_2 = fluid.layers.conv2d(pool_1, 50, 5, act="relu")
    pool_2 = fluid.layers.pool2d(conv_pool_2, 2, "max", 2)
    predict = fluid.layers.fc(pool_2, 10, act="softmax")
    return predict


def build(batch_size=None, lr=0.001, with_optimizer=True):
    """Build train program; returns (feeds, loss, acc)."""
    images = fluid.layers.data("pixel", [1, 28, 28])
    label = fluid.layers.data("label", [1], dtype="int64")
    predict = cnn_model(images)
    cost = fluid.layers.cross_entropy(predict, label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(predict, label)
    if with_optimizer:
        opt = fluid.optimizer.Adam(learning_rate=lr)
        opt.minimize(avg_cost)
    return ["pixel", "label"], avg_cost, acc
