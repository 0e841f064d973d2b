"""VGG-16 (reference: benchmark/fluid/models/vgg.py).

The port of ``paddle_tpu/models/vgg.py``: the same calls build the
reference's program byte for byte."""
from __future__ import annotations

import paddle_tpu_torch as fluid


def conv_block(input, num_filter, groups, dropouts):
    conv = input
    for _ in range(groups):
        conv = fluid.layers.conv2d(conv, num_filter, 3, padding=1, act="relu")
    return fluid.layers.pool2d(conv, 2, "max", 2)


def vgg16(input, class_dim):
    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])
    drop = fluid.layers.dropout(conv5, 0.5)
    fc1 = fluid.layers.fc(drop, 512, act=None)
    bn = fluid.layers.batch_norm(fc1, act="relu")
    drop2 = fluid.layers.dropout(bn, 0.5)
    fc2 = fluid.layers.fc(drop2, 512, act=None)
    return fluid.layers.fc(fc2, class_dim, act="softmax")


def build(class_dim=10, image_shape=(3, 32, 32), lr=0.01, with_optimizer=True):
    input = fluid.layers.data("data", list(image_shape))
    label = fluid.layers.data("label", [1], dtype="int64")
    predict = vgg16(input, class_dim)
    cost = fluid.layers.cross_entropy(predict, label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(predict, label)
    if with_optimizer:
        fluid.optimizer.Adam(lr).minimize(avg_cost)
    return ["data", "label"], avg_cost, acc
