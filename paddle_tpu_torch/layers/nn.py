"""Layer DSL: functions that append ops to the current program block.

The part of ``paddle_tpu/layers/nn.py`` that the Transformer, the
stacked LSTM, DeepFM, machine translation (training and beam search),
the convolutional models, the book models, the training rewrites and
the fc/SGD drive call (with the ``sequence_*`` layers, their nested
branches, ``sums``, the CTC and CRF layers, the reductions, ``split``,
``stack``, ``one_hot``, ``clip`` and ``l2_normalize``), copied
unchanged: the same calls build the same program, byte for byte
(``Program.serialize``).  The activations are ``layers/ops.py``'s.
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


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else len(input.shape) + dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        sizes = [input.shape[dim] // num] * num
    else:
        sections = list(num_or_sections)
        num = len(sections)
        sizes = sections
    outs = []
    for s in sizes:
        shp = list(input.shape)
        shp[dim] = s
        outs.append(helper.create_variable_for_type_inference(input.dtype, shape=tuple(shp)))
    helper.append_op(
        "split", {"X": [input]}, {"Out": outs},
        {"axis": dim, "sections": sections, "num": 0 if sections else num},
    )
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    shp = list(xs[0].shape)
    shp.insert(axis if axis >= 0 else len(shp) + axis + 1, len(xs))
    out = helper.create_variable_for_type_inference(xs[0].dtype, shape=tuple(shp))
    helper.append_op("stack", {"X": xs}, {"Y": [out]}, {"axis": axis})
    return out


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


def argmax(x, axis=-1):
    shp = tuple(s for i, s in enumerate(x.shape) if i != (axis % len(x.shape)))
    return _unary("arg_max", x, attrs={"axis": axis}, out_shape=shp, out_dtype="int64")


def one_hot(input, depth):
    shp = tuple(input.shape[:-1] if input.shape[-1] == 1 else input.shape) + (depth,)
    return _unary("one_hot", input, attrs={"depth": depth}, out_shape=shp,
                  out_dtype="float32")


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


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_pow", x, y, axis, act, name)


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


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


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


def clip(x, min, max, name=None):
    return _unary("clip", x, attrs={"min": min, "max": max})


def clip_by_norm(x, max_norm, name=None):
    return _unary("clip_by_norm", x, attrs={"max_norm": max_norm})



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
    inner [B, S] lengths through the op's "SeqLen2" slot (the op flattens
    to [B*S, W, ...] internally, ops/sequence_ops.py _nestable); pooling
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


def sequence_softmax(input, name=None):
    return _seq_op("sequence_softmax", input, name=name)


def sequence_reverse(x, name=None):
    return _seq_op("sequence_reverse", x, name=name)


def sequence_first_step(input):
    out_shape = (None if getattr(input, "lod_level", 0) == 2
                 else (input.shape[0],) + tuple(input.shape[2:]))
    return _seq_op("sequence_first_step", input, out_shape=out_shape, pool=True)


def sequence_last_step(input):
    out_shape = (None if getattr(input, "lod_level", 0) == 2
                 else (input.shape[0],) + tuple(input.shape[2:]))
    return _seq_op("sequence_last_step", input, out_shape=out_shape, pool=True)


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out_shape = (x.shape[0], y.shape[1]) + tuple(x.shape[1:])
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op("sequence_expand", {"X": [x], "Y": [y]}, {"Out": [out]})
    sl = seq_len_var(y)
    if sl is not None:
        _alias_len(out, sl)
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    T = sum(v.shape[1] for v in input)
    out_shape = (input[0].shape[0], T) + tuple(input[0].shape[2:])
    out = helper.create_variable_for_type_inference(input[0].dtype, shape=out_shape)
    helper.append_op("sequence_concat", {"X": input}, {"Out": [out]})
    return out


def _seq_op_with_len(op_type, input, ins_extra, attrs, out_shape, out_dtype,
                     len_slot="OutLen", name=None):
    """Sequence op emitting (Out, new length vector); the out var gets the
    new lengths aliased as its @LEN companion."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        out_dtype or input.dtype, shape=out_shape or input.shape)
    new_len = helper.create_variable_for_type_inference(
        "int64", shape=(input.shape[0],), stop_gradient=True)
    ins = {"X": [input], **ins_extra}
    sl = seq_len_var(input)
    if sl is not None:
        ins.setdefault("SeqLen", [sl])
    helper.append_op(op_type, ins, {"Out": [out], len_slot: [new_len]},
                     attrs or {})
    _alias_len(out, new_len)
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, param_attr=None, bias_attr=None, act=None,
                  name=None):
    """Context-window convolution (reference nn.py sequence_conv)."""
    helper = LayerHelper("sequence_conv", bias_attr=bias_attr, act=act,
                         name=name)
    D = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [filter_size * D, num_filters],
                                input.dtype)
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=(input.shape[0], input.shape[1], num_filters))
    ins = {"X": [input], "Filter": [w]}
    sl = seq_len_var(input)
    if sl is not None:
        ins["SeqLen"] = [sl]
    helper.append_op("sequence_conv", ins, {"Out": [out]},
                     {"contextLength": filter_size,
                      "contextStart": -(filter_size // 2),
                      "contextStride": filter_stride})
    pre_act = helper.append_bias_op(out, dim_start=2)
    final = helper.append_activation(pre_act)
    if sl is not None:
        _alias_len(final, sl)  # the RETURNED var carries the lengths
    return final


def sequence_slice(input, offset, length, name=None):
    return _seq_op_with_len("sequence_slice", input,
                            {"Offset": [offset], "Length": [length]}, {},
                            input.shape, input.dtype, name=name)


def sequence_erase(input, tokens, name=None):
    return _seq_op_with_len("sequence_erase", input, {},
                            {"tokens": list(tokens)}, input.shape,
                            input.dtype, name=name)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    lead = (input.shape[0], input.shape[1])
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=lead + (win_size,))
    ins = {"X": [input]}
    sl = seq_len_var(input)
    if sl is not None:
        ins["SeqLen"] = [sl]
    helper.append_op("sequence_enumerate", ins, {"Out": [out]},
                     {"win_size": win_size, "pad_value": pad_value})
    if sl is not None:
        _alias_len(out, sl)
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(
        x.dtype, shape=(x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    ins = {"X": [x], "Y": [y]}
    sl = seq_len_var(y)
    if sl is not None:
        ins["SeqLen"] = [sl]
    helper.append_op("sequence_expand_as", ins, {"Out": [out]})
    if sl is not None:
        _alias_len(out, sl)
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """Returns (padded, lengths) like the reference (nn.py sequence_pad)."""
    helper = LayerHelper("sequence_pad", name=name)
    T = maxlen or x.shape[1]
    out = helper.create_variable_for_type_inference(
        x.dtype, shape=(x.shape[0], T) + tuple(x.shape[2:]))
    lens = helper.create_variable_for_type_inference(
        "int64", shape=(x.shape[0],), stop_gradient=True)
    ins = {"X": [x], "PadValue": [pad_value]}
    sl = seq_len_var(x)
    if sl is not None:
        ins["SeqLen"] = [sl]
    helper.append_op("sequence_pad", ins, {"Out": [out], "Length": [lens]},
                     {"padded_length": maxlen or -1})
    return out, lens


def sequence_unpad(x, length, name=None):
    return _seq_op_with_len("sequence_unpad", x, {"Length": [length]}, {},
                            x.shape, x.dtype, name=name)


def sequence_reshape(input, new_dim, name=None):
    D = int(input.shape[-1])
    T = int(input.shape[1]) * D // new_dim
    return _seq_op_with_len("sequence_reshape", input, {},
                            {"new_dim": new_dim},
                            (input.shape[0], T, new_dim), input.dtype,
                            name=name)


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead convolution (reference nn.py row_conv)."""
    helper = LayerHelper("row_conv", name=name)
    D = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [future_context_size, D],
                                input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    ins = {"X": [input], "Filter": [w]}
    sl = seq_len_var(input)
    if sl is not None:
        ins["SeqLen"] = [sl]
    helper.append_op("row_conv", ins, {"Out": [out]}, {})
    if sl is not None:
        _alias_len(out, sl)
    return out


# ---------------------------------------------------------------------------
# structured losses: CTC + linear-chain CRF (ops/ctc_crf_ops.py)
# ---------------------------------------------------------------------------

def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None, name=None):
    """CTC loss (reference nn.py warpctc); returns [B,1] losses."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference(
        "float32", shape=(input.shape[0], 1))
    ins = {"Logits": [input], "Label": [label]}
    il = input_length if input_length is not None else seq_len_var(input)
    ll = label_length if label_length is not None else seq_len_var(label)
    if il is not None:
        ins["LogitsLength"] = [il]
    if ll is not None:
        ins["LabelLength"] = [ll]
    helper.append_op("warpctc", ins, {"Loss": [loss]},
                     {"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Greedy CTC decode: per-step argmax then ctc_align cleanup; returns
    (decoded ids [B,T], lengths [B])."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    am = helper.create_variable_for_type_inference(
        "int64", shape=tuple(input.shape[:2]), stop_gradient=True)
    helper.append_op("arg_max", {"X": [input]}, {"Out": [am]}, {"axis": -1})
    out = helper.create_variable_for_type_inference(
        "int64", shape=tuple(input.shape[:2]), stop_gradient=True)
    out_len = helper.create_variable_for_type_inference(
        "int64", shape=(input.shape[0],), stop_gradient=True)
    ins = {"Input": [am]}
    il = input_length if input_length is not None else seq_len_var(input)
    if il is not None:
        ins["InputLength"] = [il]
    helper.append_op("ctc_align", ins,
                     {"Output": [out], "OutputLength": [out_len]},
                     {"blank": blank, "merge_repeated": True})
    _alias_len(out, out_len)
    return out, out_len


def linear_chain_crf(input, label, param_attr=None, length=None, name=None):
    """Linear-chain CRF log-likelihood (reference nn.py linear_chain_crf);
    creates the [C+2, C] transition parameter."""
    helper = LayerHelper("linear_chain_crf", name=name)
    C = int(input.shape[-1])
    trans = helper.create_parameter(param_attr, [C + 2, C], "float32")
    ll = helper.create_variable_for_type_inference(
        "float32", shape=(input.shape[0], 1))
    ins = {"Emission": [input], "Transition": [trans], "Label": [label]}
    ln = length if length is not None else seq_len_var(input)
    if ln is not None:
        ins["Length"] = [ln]
    helper.append_op("linear_chain_crf", ins, {"LogLikelihood": [ll]}, {})
    return ll


def crf_decoding(input, param_attr, length=None, name=None):
    """Viterbi decode sharing the CRF transition parameter by name."""
    helper = LayerHelper("crf_decoding", name=name)
    trans_name = param_attr.name if hasattr(param_attr, "name") else str(param_attr)
    trans = input.block.program.global_block.var(trans_name)
    path = helper.create_variable_for_type_inference(
        "int64", shape=tuple(input.shape[:2]), stop_gradient=True)
    ins = {"Emission": [input], "Transition": [trans]}
    ln = length if length is not None else seq_len_var(input)
    if ln is not None:
        ins["Length"] = [ln]
    helper.append_op("crf_decoding", ins, {"ViterbiPath": [path]}, {})
    return path


def sums(input, out=None):
    helper = LayerHelper("sum")
    out = out or helper.create_variable_for_type_inference(
        input[0].dtype, shape=input[0].shape)
    helper.append_op("sum", {"X": input}, {"Out": [out]})
    if seq_len_var(input[0]) is not None:
        _alias_len(out, seq_len_var(input[0]))
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    norm = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        "norm", {"X": [x]}, {"Out": [out], "Norm": [norm]},
        {"axis": axis, "epsilon": epsilon},
    )
    return out


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
    "argmax",
    "batch_norm",
    "cast",
    "clip",
    "clip_by_norm",
    "concat",
    "conv2d",
    "crf_decoding",
    "cross_entropy",
    "ctc_greedy_decoder",
    "dropout",
    "dynamic_gru",
    "dynamic_lstm",
    "elementwise_add",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_mul",
    "elementwise_pow",
    "elementwise_sub",
    "embedding",
    "expand",
    "fc",
    "gather",
    "l2_normalize",
    "layer_norm",
    "linear_chain_crf",
    "matmul",
    "mean",
    "mul",
    "one_hot",
    "pool2d",
    "reduce_max",
    "reduce_mean",
    "reduce_min",
    "reduce_prod",
    "reduce_sum",
    "reshape",
    "row_conv",
    "scale",
    "seq_len2_var",
    "seq_len_var",
    "sequence_concat",
    "sequence_conv",
    "sequence_enumerate",
    "sequence_erase",
    "sequence_expand",
    "sequence_expand_as",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_pad",
    "sequence_pool",
    "sequence_reshape",
    "sequence_reverse",
    "sequence_slice",
    "sequence_softmax",
    "sequence_unpad",
    "sigmoid_cross_entropy_with_logits",
    "slice",
    "softmax",
    "softmax_with_cross_entropy",
    "split",
    "square_error_cost",
    "squeeze",
    "stack",
    "sums",
    "topk",
    "transpose",
    "unsqueeze",
    "warpctc",
]
