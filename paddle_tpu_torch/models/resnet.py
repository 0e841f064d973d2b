"""ResNet-50 (reference: benchmark/fluid/models/resnet.py).

bf16-friendly: pass dtype="bfloat16" to keep conv/matmul inputs in
bfloat16 (the tensor cores' input type) while BN statistics stay float32
(ops/nn_ops.py promotes).

The port of ``paddle_tpu/models/resnet.py``: the same calls build the
reference's program byte for byte."""
from __future__ import annotations

import paddle_tpu_torch as fluid


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  layout="NCHW"):
    conv = fluid.layers.conv2d(input, ch_out, filter_size, stride, padding,
                               act=None, bias_attr=False, data_layout=layout)
    return fluid.layers.batch_norm(conv, act=act, data_layout=layout)


def shortcut(input, ch_out, stride, layout="NCHW"):
    ch_in = input.shape[-1] if layout == "NHWC" else input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             layout=layout)
    return input


def bottleneck_block(input, num_filters, stride, layout="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 1, 1, 0, layout=layout)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, 1, layout=layout)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, 1, 0, act=None,
                          layout=layout)
    short = shortcut(input, num_filters * 4, stride, layout)
    return fluid.layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, num_filters, stride, layout="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, 1, layout=layout)
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1, 1, act=None,
                          layout=layout)
    short = shortcut(input, num_filters, stride, layout)
    return fluid.layers.elementwise_add(short, conv1, act="relu")


def resnet(input, class_dim, depth=50, layout="NCHW"):
    cfg = {
        18: ([2, 2, 2, 2], basic_block),
        34: ([3, 4, 6, 3], basic_block),
        50: ([3, 4, 6, 3], bottleneck_block),
        101: ([3, 4, 23, 3], bottleneck_block),
        152: ([3, 8, 36, 3], bottleneck_block),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, 3, layout=layout)
    pool1 = fluid.layers.pool2d(conv1, 3, "max", 2, 1, data_layout=layout)
    res = pool1
    for stage, count in enumerate(stages):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            res = block_func(res, 64 * (2 ** stage), stride, layout)
    pool2 = fluid.layers.pool2d(res, 7, "avg", global_pooling=True,
                                data_layout=layout)
    out = fluid.layers.fc(pool2, class_dim, act="softmax")
    return out


def build(class_dim=1000, image_shape=(3, 224, 224), depth=50, lr=0.1,
          dtype="float32", with_optimizer=True, layout="NCHW"):
    """layout="NHWC" transposes the NCHW feed once at graph entry and runs
    every conv/bn/pool channels-last, the layout cuDNN's tensor-core
    kernels take; the feed contract stays NCHW."""
    input = fluid.layers.data("data", list(image_shape), dtype=dtype)
    label = fluid.layers.data("label", [1], dtype="int64")
    if layout == "NHWC":
        input = fluid.layers.transpose(input, [0, 2, 3, 1])
    predict = resnet(input, class_dim, depth, layout)
    cost = fluid.layers.cross_entropy(predict, label)
    avg_cost = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(predict, label)
    if with_optimizer:
        opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
        opt.minimize(avg_cost)
    return ["data", "label"], avg_cost, acc
