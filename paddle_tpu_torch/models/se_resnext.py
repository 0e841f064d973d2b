"""SE-ResNeXt (reference benchmark/fluid/models/se_resnext.py): grouped
3x3 convolutions (cardinality) + squeeze-and-excitation channel gating.

The port of ``paddle_tpu/models/se_resnext.py``: the same calls build the
reference's program byte for byte."""
from __future__ import annotations

import paddle_tpu_torch as fluid

L = fluid.layers


def conv_bn(input, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = L.conv2d(input, num_filters, filter_size, stride=stride,
                    padding=(filter_size - 1) // 2, groups=groups,
                    bias_attr=False)
    return L.batch_norm(conv, act=act)


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = L.pool2d(input, pool_type="avg", global_pooling=True)
    pool = L.reshape(pool, [-1, num_channels])
    squeeze = L.fc(pool, max(num_channels // reduction_ratio, 4), act="relu")
    excitation = L.fc(squeeze, num_channels, act="sigmoid")
    # channel gate broadcast over H, W
    gate = L.reshape(excitation, [-1, num_channels, 1, 1])
    return L.elementwise_mul(input, gate)


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio):
    conv0 = conv_bn(input, num_filters, 1, act="relu")
    conv1 = conv_bn(conv0, num_filters, 3, stride=stride,
                    groups=cardinality, act="relu")
    conv2 = conv_bn(conv1, num_filters * 2, 1)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    if input.shape[1] != num_filters * 2 or stride != 1:
        shortcut = conv_bn(input, num_filters * 2, 1, stride=stride)
    else:
        shortcut = input
    return L.relu(L.elementwise_add(shortcut, scaled))


def se_resnext(input, class_dim, depth=50, cardinality=32,
               reduction_ratio=16):
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    filters = [128, 256, 512, 1024]
    conv = conv_bn(input, 64, 7, stride=2, act="relu")
    conv = L.pool2d(conv, 3, "max", 2, pool_padding=1)
    for block, n in enumerate(cfg):
        for i in range(n):
            conv = bottleneck_block(
                conv, filters[block], 2 if i == 0 and block != 0 else 1,
                cardinality, reduction_ratio)
    pool = L.pool2d(conv, pool_type="avg", global_pooling=True)
    flat = L.reshape(pool, [-1, pool.shape[1]])
    drop = L.dropout(flat, dropout_prob=0.5)
    return L.fc(drop, class_dim, act="softmax")


def build(class_dim=1000, image_shape=(3, 224, 224), depth=50, lr=0.1,
          cardinality=32, with_optimizer=True):
    img = L.data("data", list(image_shape))
    label = L.data("label", [1], dtype="int64")
    predict = se_resnext(img, class_dim, depth, cardinality)
    cost = L.cross_entropy(predict, label)
    avg_cost = L.mean(cost)
    acc = L.accuracy(predict, label)
    if with_optimizer:
        fluid.optimizer.Momentum(lr, momentum=0.9).minimize(avg_cost)
    return ["data", "label"], avg_cost, acc
