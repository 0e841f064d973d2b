"""Layer DSL: functions that append ops to the current program block.

The part of ``paddle_tpu/layers/nn.py`` that the Transformer, the
stacked LSTM, DeepFM, machine translation (training and beam search),
the convolutional models and the fc/SGD drive call, copied unchanged
(and ``square``, ``sigmoid``, ``tanh``, ``log`` and ``relu``, which the
reference generates in ``layers/ops.py``): the same calls build the
same program, byte for byte (``Program.serialize``).
Padded sequences carry their ``<name>@LEN`` companion as in the
reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.program import Variable
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def seq_len_var(x: Variable) -> Optional[Variable]:
    """Companion length var of a padded sequence batch, if declared."""
    b = x.block
    while b is not None:
        if x.name in b.seq_len_map:
            return b.var_or_none(b.seq_len_map[x.name])
        b = b.parent_block
    return x.block.var_or_none(x.name + "@LEN")


def seq_len2_var(x: Variable) -> Optional[Variable]:
    """Inner (level-2) [B, S] lengths companion of a padded-nested batch."""
    b = x.block
    while b is not None:
        if x.name in getattr(b, "seq_len2_map", {}):
            return b.var_or_none(b.seq_len2_map[x.name])
        b = b.parent_block
    return x.block.var_or_none(x.name + "@LEN2")


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected (reference nn.py fc): mul + (sum) + bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        in_features = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(pattr, [in_features, size], dtype)
        out_shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(dtype, shape=out_shape)
        helper.append_op(
            "mul", {"X": [inp], "Y": [w]}, {"Out": [tmp]},
            {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype, shape=mul_results[0].shape)
        helper.append_op("sum", {"X": mul_results}, {"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    out = helper.append_activation(pre_act)
    first = inputs[0]
    if num_flatten_dims >= 2:
        _propagate_lod(out, first)
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """Embedding lookup (reference nn.py:272).  ``is_sparse`` makes the
    gradient a SelectedRows row-slice pair (no dense [V, D] grad is ever
    materialised); ``is_distributed`` marks the table for the pserver
    transpiler's sharded-table path."""
    if is_distributed and not is_sparse:
        raise ValueError(
            "embedding(is_distributed=True) requires is_sparse=True: the "
            "sharded-table gradient travels as a SelectedRows row slice "
            "(reference nn.py:272 remote-prefetch path)")
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, size, dtype)
    out_shape = tuple(input.shape[:-1] if input.shape[-1] == 1 else input.shape) + (size[1],)
    out = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    # negative padding_idx counts from the end (reference nn.py:292:
    # kNoPadding if None else idx if idx >= 0 else size[0] + idx)
    if padding_idx is None:
        padding_idx = -1  # kNoPadding sentinel
    elif padding_idx < 0:
        padding_idx = size[0] + padding_idx
    helper.append_op(
        "lookup_table", {"W": [w], "Ids": [input]}, {"Out": [out]},
        {"is_sparse": is_sparse, "is_distributed": is_distributed,
         "padding_idx": padding_idx},
    )
    _propagate_lod(out, input)
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_layout="NCHW"):
    """2-D convolution (reference nn.py conv2d): the filter is OIHW
    whatever ``data_layout``, drawn from Normal(0, sqrt(2 / (kh kw
    C))); the bias rides the channel dim (1 for NCHW, 3 for NHWC)."""
    helper = LayerHelper("conv2d", bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    fs, st, pd, dl = (_pair(filter_size), _pair(stride), _pair(padding),
                      _pair(dilation))
    nhwc = data_layout == "NHWC"
    C = input.shape[-1] if nhwc else input.shape[1]
    w_shape = [num_filters, C // groups, fs[0], fs[1]]
    std = (2.0 / (fs[0] * fs[1] * C)) ** 0.5
    w = helper.create_parameter(
        param_attr, w_shape, dtype,
        default_initializer=NormalInitializer(0.0, std))
    hin, win = (input.shape[1:3] if nhwc else input.shape[2:4])
    H = (hin + 2 * pd[0] - (dl[0] * (fs[0] - 1) + 1)) // st[0] + 1
    W = (win + 2 * pd[1] - (dl[1] * (fs[1] - 1) + 1)) // st[1] + 1
    out_shape = ((input.shape[0], H, W, num_filters) if nhwc
                 else (input.shape[0], num_filters, H, W))
    pre_bias = helper.create_variable_for_type_inference(dtype,
                                                         shape=out_shape)
    helper.append_op(
        "conv2d", {"Input": [input], "Filter": [w]}, {"Output": [pre_bias]},
        {"strides": st, "paddings": pd, "dilations": dl, "groups": groups,
         "data_layout": data_layout})
    if nhwc:
        pre_act = helper.append_bias_op(pre_bias, dim_start=3, dim_end=4)
    else:
        pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_layout="NCHW"):
    """2-D max or avg pooling (reference nn.py pool2d); ``ceil_mode`` is
    accepted and ignored, as the reference's layer does."""
    helper = LayerHelper("pool2d", name=name)
    ks, st, pd = _pair(pool_size), _pair(pool_stride), _pair(pool_padding)
    nhwc = data_layout == "NHWC"
    hin, win = (input.shape[1:3] if nhwc else input.shape[2:4])
    if global_pooling:
        H = W = 1
    else:
        H = (hin + 2 * pd[0] - ks[0]) // st[0] + 1
        W = (win + 2 * pd[1] - ks[1]) // st[1] + 1
    ch = input.shape[-1] if nhwc else input.shape[1]
    shape = ((input.shape[0], H, W, ch) if nhwc
             else (input.shape[0], ch, H, W))
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(
        "pool2d", {"X": [input]}, {"Out": [out]},
        {"pooling_type": pool_type, "ksize": ks, "strides": st,
         "paddings": pd, "global_pooling": global_pooling,
         "exclusive": exclusive, "data_layout": data_layout})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               in_place=False):
    """Batch normalization (reference nn.py batch_norm): float32 scale
    and bias parameters, and the running mean and variance as
    persistable globals (``moving_mean_name`` or ``<name>.mean``,
    ``<name>.variance``) that MeanOut and VarianceOut write back."""
    helper = LayerHelper("batch_norm", act=act, name=name)
    dtype = input.dtype
    C = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        param_attr, [C], "float32",
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [C], "float32", is_bias=True)
    mean = helper.create_or_get_global_variable(
        [C], "float32", moving_mean_name or helper.name + ".mean",
        persistable=True)
    variance = helper.create_or_get_global_variable(
        [C], "float32", moving_variance_name or helper.name + ".variance",
        persistable=True)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_variable_for_type_inference("float32",
                                                           shape=(C,))
    saved_var = helper.create_variable_for_type_inference("float32",
                                                          shape=(C,))
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    helper.append_op(
        "batch_norm",
        {"X": [input], "Scale": [scale], "Bias": [bias],
         "Mean": [mean], "Variance": [variance]},
        {"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
         "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, norm_shape, "float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, "float32", is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    mean = helper.create_variable_for_type_inference(
        "float32", shape=input.shape[:begin_norm_axis])
    var = helper.create_variable_for_type_inference(
        "float32", shape=input.shape[:begin_norm_axis])
    helper.append_op(
        "layer_norm", inputs, {"Y": [out], "Mean": [mean], "Variance": [var]},
        {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    mask = helper.create_variable_for_type_inference(
        x.dtype, shape=x.shape, stop_gradient=True)
    helper.append_op(
        "dropout", {"X": [x]}, {"Out": [out], "Mask": [mask]},
        {"dropout_prob": dropout_prob, "is_test": is_test,
         "seed": seed or 0, "dropout_implementation": dropout_implementation},
    )
    return out


def softmax(input, axis=-1, use_cudnn=False, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, shape=input.shape)
    helper.append_op("softmax", {"X": [input]}, {"Out": [out]}, {"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out_shape = tuple(input.shape[:-1]) + (1,)
    out = helper.create_variable_for_type_inference(input.dtype, shape=out_shape)
    helper.append_op(
        "cross_entropy", {"X": [input], "Label": [label]}, {"Y": [out]},
        {"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    sm = helper.create_variable_for_type_inference(logits.dtype, shape=logits.shape)
    loss_shape = tuple(logits.shape[:-1]) + (1,)
    loss = helper.create_variable_for_type_inference(logits.dtype, shape=loss_shape)
    helper.append_op(
        "softmax_with_cross_entropy",
        {"Logits": [logits], "Label": [label]},
        {"Softmax": [sm], "Loss": [loss]},
        {"soft_label": soft_label, "ignore_index": ignore_index},
    )
    if return_softmax:
        return loss, sm
    return loss


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype, shape=input.shape)
    helper.append_op("square_error_cost", {"X": [input], "Y": [label]}, {"Out": [out]})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        "sigmoid_cross_entropy_with_logits",
        {"X": [x], "Label": [label]}, {"Out": [out]})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (reference layers/metric_op.py accuracy)."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(
        input.dtype, shape=tuple(input.shape[:-1]) + (k,))
    topk_idx = helper.create_variable_for_type_inference(
        "int64", shape=tuple(input.shape[:-1]) + (k,), stop_gradient=True)
    helper.append_op("top_k", {"X": [input]},
                     {"Out": [topk_out], "Indices": [topk_idx]}, {"k": k})
    acc = helper.create_variable_for_type_inference("float32", shape=(), stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        "int32", shape=(), stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        "int32", shape=(), stop_gradient=True)
    helper.append_op(
        "accuracy",
        {"Out": [topk_out], "Indices": [topk_idx], "Label": [label]},
        {"Accuracy": [acc], "Correct": [correct], "Total": [total]},
    )
    return acc


def _unary(op_type, x, helper_name=None, attrs=None, out_shape=None, out_dtype=None):
    helper = LayerHelper(helper_name or op_type)
    out = helper.create_variable_for_type_inference(
        out_dtype or x.dtype, shape=out_shape if out_shape is not None else x.shape)
    helper.append_op(op_type, {"X": [x]}, {"Out": [out]}, attrs or {})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    new_shape = list(shape)
    known = [s for s in new_shape if s > 0]
    resolved = []
    for i, s in enumerate(new_shape):
        resolved.append(x.shape[i] if s == 0 else s)
    if -1 in resolved:
        total = int(np.prod([s for s in x.shape if s != -1]))
        # keep -1 symbolic when the input batch is symbolic
        pass
    helper = LayerHelper("reshape", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=tuple(resolved))
    helper.append_op("reshape", {"X": [x]}, {"Out": [out]}, {"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    out_shape = tuple(x.shape[p] for p in perm)
    return _unary("transpose", x, attrs={"axis": list(perm)}, out_shape=out_shape)


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shp = list(input[0].shape)
    shp[axis] = sum(int(v.shape[axis]) for v in input)
    out = helper.create_variable_for_type_inference(input[0].dtype, shape=tuple(shp))
    helper.append_op("concat", {"X": input}, {"Out": [out]}, {"axis": axis})
    return out


def square(x, name=None, **attrs):
    """square activation (the reference's generated ``layers/ops.py``
    wrapper)."""
    helper = LayerHelper("square", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("square", {"X": [x]}, {"Out": [out]}, attrs)
    return out


def _activation(op_type, x, name=None, **attrs):
    """A unary activation layer (the reference's generated
    ``layers/ops.py`` wrapper)."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(op_type, {"X": [x]}, {"Out": [out]}, attrs)
    return out


def sigmoid(x, name=None, **attrs):
    """sigmoid activation (activation_op.cc functor)."""
    return _activation("sigmoid", x, name, **attrs)


def tanh(x, name=None, **attrs):
    """tanh activation (activation_op.cc functor)."""
    return _activation("tanh", x, name, **attrs)


def log(x, name=None, **attrs):
    """log activation (activation_op.cc functor)."""
    return _activation("log", x, name, **attrs)


def relu(x, name=None, **attrs):
    """relu activation (activation_op.cc functor)."""
    return _activation("relu", x, name, **attrs)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shp = list(input.shape)
    for ax, st, en in zip(axes, starts, ends):
        dim = shp[ax]
        if dim == -1:
            continue
        st2 = max(st + dim, 0) if st < 0 else min(st, dim)
        en2 = max(en + dim, 0) if en < 0 else min(en, dim)
        shp[ax] = max(en2 - st2, 0)
    out = helper.create_variable_for_type_inference(input.dtype, shape=tuple(shp))
    helper.append_op(
        "slice", {"Input": [input]}, {"Out": [out]},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def squeeze(input, axes, name=None):
    shp = [s for i, s in enumerate(input.shape) if i not in axes]
    return _unary("squeeze", input, attrs={"axes": list(axes)}, out_shape=tuple(shp))


def unsqueeze(input, axes, name=None):
    shp = list(input.shape)
    for ax in sorted(axes):
        shp.insert(ax, 1)
    return _unary("unsqueeze", input, attrs={"axes": list(axes)}, out_shape=tuple(shp))


def expand(x, expand_times, name=None):
    shp = tuple(s * t if s != -1 else -1 for s, t in zip(x.shape, expand_times))
    return _unary("expand", x, attrs={"expand_times": list(expand_times)}, out_shape=shp)


def gather(input, index):
    helper = LayerHelper("gather")
    shp = tuple(index.shape) + tuple(input.shape[1:])
    out = helper.create_variable_for_type_inference(input.dtype, shape=shp)
    helper.append_op("gather", {"X": [input], "Index": [index]}, {"Out": [out]})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = xs[:-2] if len(xs) > 2 else (ys[:-2] if len(ys) > 2 else [])
    out_shape = tuple(batch) + (xs[-2] if len(xs) > 1 else 1, ys[-1])
    if len(xs) == 1:
        out_shape = (ys[-1],)
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(
        "matmul", {"X": [x], "Y": [y]}, {"Out": [out]},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": alpha},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out_shape = tuple(x.shape[:x_num_col_dims]) + tuple(y.shape[y_num_col_dims:])
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(
        "mul", {"X": [x], "Y": [y]}, {"Out": [out]},
        {"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def _tile_rows(x, times):
    """[B, ...] -> [B*times, ...] repeating each row (beam fan-out;
    shared by models/machine_translation.py and contrib/decoder.py)."""
    expanded = expand(unsqueeze(x, [1]),
                      [1, times] + [1] * (len(x.shape) - 1))
    return reshape(expanded, [-1] + list(x.shape[1:]))


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shp = tuple(input.shape[:-1]) + (k,)
    vals = helper.create_variable_for_type_inference(input.dtype, shape=shp)
    idx = helper.create_variable_for_type_inference("int64", shape=shp, stop_gradient=True)
    helper.append_op("top_k", {"X": [input]}, {"Out": [vals], "Indices": [idx]}, {"k": k})
    return vals, idx


def cast(x, dtype):
    return _unary("cast", x, attrs={"out_dtype": dtype}, out_dtype=dtype)


def _binary(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    shp = x.shape if len(x.shape) >= len(y.shape) else y.shape
    out = helper.create_variable_for_type_inference(x.dtype, shape=shp)
    helper.append_op(op_type, {"X": [x], "Y": [y]}, {"Out": [out]}, {"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_min", x, y, axis, act, name)


def _reduce_shape(x, dim, keep_dim):
    if dim is None:
        return () if not keep_dim else tuple(1 for _ in x.shape)
    dims = [d % len(x.shape) for d in (dim if isinstance(dim, (list, tuple)) else [dim])]
    if keep_dim:
        return tuple(1 if i in dims else s for i, s in enumerate(x.shape))
    return tuple(s for i, s in enumerate(x.shape) if i not in dims)


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=_reduce_shape(input, dim, keep_dim))
    attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
    if dim is not None:
        attrs["dim"] = list(dim) if isinstance(dim, (list, tuple)) else [dim]
    helper.append_op(op_type, {"X": [input]}, {"Out": [out]}, attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def mean(x, name=None):
    return _unary("mean", x, out_shape=())


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        "scale", {"X": [x]}, {"Out": [out]},
        {"scale": scale, "bias": bias, "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 seq_len=None):
    """LSTM over a padded sequence batch (reference nn.py dynamic_lstm).

    ``input``: [B, T, 4H] pre-projected gates (x·Wx + b, make with
    fc(num_flatten_dims=2)); ``size`` = 4H.  Returns (hidden [B,T,H],
    cell [B,T,H]).  Lengths come from ``seq_len`` or the companion
    ``<name>@LEN`` var of ``input``.
    """
    helper = LayerHelper("lstm", name=name)
    H = size // 4
    w = helper.create_parameter(param_attr, [H, 4 * H], dtype)
    b = helper.create_parameter(bias_attr, [4 * H], dtype, is_bias=True)
    biased = elementwise_add(input, b, axis=2)
    B, T = input.shape[0], input.shape[1]
    hidden = helper.create_variable_for_type_inference(dtype, shape=(B, T, H))
    cell = helper.create_variable_for_type_inference(dtype, shape=(B, T, H))
    last_h = helper.create_variable_for_type_inference(dtype, shape=(B, H))
    last_c = helper.create_variable_for_type_inference(dtype, shape=(B, H))
    ins = {"Input": [biased], "Weight": [w]}
    sl = seq_len or seq_len_var(input)
    if sl is not None:
        ins["SeqLen"] = [sl]
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    helper.append_op(
        "lstm", ins,
        {"Hidden": [hidden], "Cell": [cell], "LastH": [last_h], "LastC": [last_c]},
        {"is_reverse": is_reverse},
    )
    if sl is not None:
        _alias_len(hidden, sl)
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, h_0=None, name=None, seq_len=None,
                dtype="float32"):
    """GRU over a padded batch; ``input``: [B,T,3H], ``size`` = H."""
    helper = LayerHelper("gru", name=name)
    H = size
    w = helper.create_parameter(param_attr, [H, 3 * H], dtype)
    b = helper.create_parameter(bias_attr, [3 * H], dtype, is_bias=True)
    biased = elementwise_add(input, b, axis=2)
    B, T = input.shape[0], input.shape[1]
    hidden = helper.create_variable_for_type_inference(dtype, shape=(B, T, H))
    last_h = helper.create_variable_for_type_inference(dtype, shape=(B, H))
    ins = {"Input": [biased], "Weight": [w]}
    sl = seq_len or seq_len_var(input)
    if sl is not None:
        ins["SeqLen"] = [sl]
    if h_0 is not None:
        ins["H0"] = [h_0]
    helper.append_op(
        "gru", ins, {"Hidden": [hidden], "LastH": [last_h]},
        {"is_reverse": is_reverse},
    )
    if sl is not None:
        _alias_len(hidden, sl)
    return hidden


def _alias_len(var, seq_len):
    """Register seq_len as var's companion length var."""
    var.block.seq_len_map[var.name] = seq_len.name


def _propagate_lod(out, x):
    """Carry BOTH length companions and the lod_level through a
    shape-preserving layer (embedding/fc/elementwise...): without this,
    a nested ids -> embedding -> sequence_pool pipeline would silently
    fall back to the level-1 path with outer lengths applied to the
    sentence axis."""
    sl = seq_len_var(x)
    if sl is not None:
        _alias_len(out, sl)
    if getattr(x, "lod_level", 0) == 2:
        sl2 = seq_len2_var(x)
        if sl2 is not None:
            out.block.seq_len2_map[out.name] = sl2.name
            out.lod_level = 2


def _seq_op(op_type, input, attrs=None, out_shape=None, pool=False, name=None):
    """Sequence-op layer shim.  Nested (lod_level 2) inputs route their
    inner [B, S] lengths through the op's "SeqLen2" slot (the port's
    sequence_pool raises for it until nested batches are ported); pooling
    then REMOVES the inner level, so the result is a level-1 sequence
    whose companion is the OUTER lengths."""
    helper = LayerHelper(op_type, name=name)
    sl = seq_len_var(input)
    sl2 = seq_len2_var(input)
    nested = getattr(input, "lod_level", 0) == 2 and sl2 is not None
    if nested and pool and out_shape is None:
        out_shape = tuple(input.shape[:2]) + tuple(input.shape[3:])
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=out_shape if out_shape is not None else input.shape)
    ins = {"X": [input]}
    if sl is not None and not nested:
        ins["SeqLen"] = [sl]
    if sl2 is not None:
        ins["SeqLen2"] = [sl2]
    helper.append_op(op_type, ins, {"Out": [out]}, attrs or {})
    if nested:
        out.lod_level = 1 if pool else 2
        if sl is not None:
            _alias_len(out, sl)       # outer lengths survive either way
        if not pool and sl2 is not None:
            out.block.seq_len2_map[out.name] = sl2.name
    elif not pool and sl is not None:
        _alias_len(out, sl)
    return out


def sequence_pool(input, pool_type, name=None):
    if getattr(input, "lod_level", 0) == 2:
        return _seq_op("sequence_pool", input,
                       {"pooltype": pool_type.upper()}, pool=True, name=name)
    out_shape = (input.shape[0],) + tuple(input.shape[2:])
    return _seq_op("sequence_pool", input, {"pooltype": pool_type.upper()},
                   out_shape=out_shape, pool=True, name=name)


def sequence_last_step(input):
    out_shape = (None if getattr(input, "lod_level", 0) == 2
                 else (input.shape[0],) + tuple(input.shape[2:]))
    return _seq_op("sequence_last_step", input, out_shape=out_shape, pool=True)


def _cmp_layer(op_type, x, y, cond=None, name=None):
    """Shared comparison wrapper (``less_than``; ``cond=`` writes into
    an existing bool var)."""
    helper = LayerHelper(op_type, name=name)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool",
                                                         shape=x.shape)
    helper.append_op(op_type, {"X": [x], "Y": [y]}, {"Out": [cond]})
    return cond


__all__ = [
    "accuracy",
    "batch_norm",
    "cast",
    "concat",
    "conv2d",
    "cross_entropy",
    "dynamic_gru",
    "dynamic_lstm",
    "dropout",
    "elementwise_add",
    "elementwise_div",
    "elementwise_min",
    "elementwise_mul",
    "elementwise_sub",
    "embedding",
    "expand",
    "fc",
    "gather",
    "layer_norm",
    "log",
    "matmul",
    "mean",
    "mul",
    "pool2d",
    "reduce_sum",
    "relu",
    "reshape",
    "scale",
    "seq_len2_var",
    "seq_len_var",
    "sequence_last_step",
    "sequence_pool",
    "sigmoid",
    "sigmoid_cross_entropy_with_logits",
    "slice",
    "softmax",
    "softmax_with_cross_entropy",
    "square",
    "square_error_cost",
    "squeeze",
    "tanh",
    "topk",
    "transpose",
    "unsqueeze",
]
