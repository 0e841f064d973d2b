"""Composite network helpers: the part of ``paddle_tpu/nets.py`` whose
ops the port registers (``simple_img_conv_pool``, ``img_conv_group``,
``sequence_conv_pool``, ``glu``, ``scaled_dot_product_attention``), copied
unchanged: compositions over the layer DSL, no new ops."""
from __future__ import annotations

from . import layers

__all__ = [
    "simple_img_conv_pool",
    "img_conv_group",
    "sequence_conv_pool",
    "glu",
    "scaled_dot_product_attention",
]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input, num_filters, filter_size, stride=conv_stride,
        padding=conv_padding, dilation=conv_dilation, groups=conv_groups,
        param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.pool2d(conv_out, pool_size, pool_type, pool_stride,
                         pool_padding, global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """Stacked conv (+optional BN/dropout) blocks followed by one pool —
    the VGG building block."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def expand(v):
        return v if isinstance(v, (list, tuple)) \
            else [v] * len(conv_num_filter)

    conv_padding = expand(conv_padding)
    conv_filter_size = expand(conv_filter_size)
    param_attr = expand(param_attr) if isinstance(param_attr, (list, tuple)) \
        else [param_attr] * len(conv_num_filter)
    conv_with_batchnorm = expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            tmp, conv_num_filter[i], conv_filter_size[i],
            padding=conv_padding[i], param_attr=param_attr[i],
            act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size, pool_type, pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input, num_filters, filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(conv_out, pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    from .layers.ops import sigmoid
    return layers.elementwise_mul(a, sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [B, T, D] tensors
    (reference nets.py:333); returns [B, Tq, Dv]."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    d_key = int(keys.shape[-1]) // num_heads

    def split_heads(x):
        if num_heads == 1:
            return x
        b, t, d = x.shape
        r = layers.reshape(x, [b, t, num_heads, d // num_heads])
        return layers.transpose(r, [0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        b, h, t, d = x.shape
        return layers.reshape(layers.transpose(x, [0, 2, 1, 3]),
                              [b, t, h * d])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    scaled_q = layers.scale(q, scale=d_key ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    return combine_heads(ctx)
