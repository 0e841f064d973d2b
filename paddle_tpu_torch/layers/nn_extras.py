"""Layer DSL tail: the part of ``paddle_tpu/layers/nn_extras.py`` that
is ported (``cos_sim``, the sequence layers ``sequence_scatter``,
``sequence_mask``, ``lod_reset`` and ``im2sequence``, the comparison
and logical layers, and ``pad``, ``shape``, ``scatter``, ``maxout``,
the finiteness checks, ``sum``, ``Print``, ``cumsum``, the step
counter and ``append_LARS``), copied unchanged so the same calls build
the same program.  ``layers/__init__`` re-exports it, as the
reference's does.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _alias_len, _cmp_layer, _pair, _seq_op_with_len, seq_len_var

__all__ = [
    "Print",
    "append_LARS",
    "autoincreased_step_counter",
    "cos_sim",
    "cumsum",
    "equal",
    "greater_than",
    "has_inf",
    "has_nan",
    "im2sequence",
    "isfinite",
    "less_equal",
    "lod_reset",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "maxout",
    "not_equal",
    "pad",
    "scatter",
    "sequence_mask",
    "sequence_scatter",
    "shape",
    "sum",
]


def _simple(op_type, ins, attrs=None, out_shape=None, out_dtype=None,
            out_slot="Out", extra_outs=(), name=None, ref=None):
    """Append one op whose main output mirrors the first input."""
    helper = LayerHelper(op_type, name=name)
    ref = ref if ref is not None else next(iter(ins.values()))[0]
    out = helper.create_variable_for_type_inference(
        out_dtype or ref.dtype, shape=out_shape or ref.shape)
    outs = {out_slot: [out]}
    for slot, shape, dtype in extra_outs:
        outs[slot] = [helper.create_variable_for_type_inference(
            dtype or ref.dtype, shape=shape or ref.shape)]
    helper.append_op(op_type, ins, outs, attrs or {})
    return out


def cos_sim(X, Y, name=None):
    return _simple("cos_sim", {"X": [X], "Y": [Y]},
                   out_shape=(X.shape[0], 1),
                   extra_outs=[("XNorm", (X.shape[0], 1), None),
                               ("YNorm", (Y.shape[0], 1), None)], name=name)


def sequence_scatter(input, index, updates, name=None):
    ins = {"X": [input], "Ids": [index], "Updates": [updates]}
    sl = seq_len_var(index)
    if sl is not None:
        ins["SeqLen"] = [sl]
    return _simple("sequence_scatter", ins, name=name)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        raise ValueError(
            "sequence_mask needs a static maxlen (a dynamic "
            "max-length would make the output shape data-dependent)")
    return _simple("sequence_mask", {"X": [x]},
                   {"maxlen": int(maxlen), "out_dtype": dtype},
                   out_shape=tuple(x.shape) + (int(maxlen),),
                   out_dtype=dtype, out_slot="Y", name=name)


def lod_reset(x, y=None, target_lod=None):
    """Reference nn.py lod_reset on the padded contract: data unchanged,
    the @LEN companion becomes y's lengths / the target lengths."""
    helper = LayerHelper("lod_reset")
    ins = {"X": [x]}
    attrs = {}
    if y is not None:
        sl = seq_len_var(y)
        if sl is not None:
            ins["TargetLenTensor"] = [sl]
        else:
            ins["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = list(target_lod)
    else:
        raise ValueError("lod_reset needs y or target_lod")
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    new_len = helper.create_variable_for_type_inference(
        "int64", shape=(x.shape[0],), stop_gradient=True)
    helper.append_op("lod_reset", ins, {"Out": [out], "OutLen": [new_len]},
                     attrs)
    _alias_len(out, new_len)
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    fs, st = _pair(filter_size), _pair(stride)
    pd = list(padding) if isinstance(padding, (list, tuple)) \
        else [padding] * 4
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    n, c, h, w = input.shape
    oh = (h + pd[0] + pd[2] - fs[0]) // st[0] + 1
    ow = (w + pd[1] + pd[3] - fs[1]) // st[1] + 1
    return _seq_op_with_len(
        "im2sequence", input, {}, {"kernels": list(fs), "strides": list(st),
                                   "paddings": pd},
        (n, oh * ow, c * fs[0] * fs[1]), input.dtype)


# -- comparison and logical layers (reference layers/control_flow.py
# equal and the logical family of layers/ops) --------------------------

def equal(x, y, cond=None, name=None):
    """Elementwise x == y (reference control_flow.py equal)."""
    return _cmp_layer("equal", x, y, cond, name)


def not_equal(x, y, cond=None, name=None):
    return _cmp_layer("not_equal", x, y, cond, name)


def less_equal(x, y, cond=None, name=None):
    return _cmp_layer("less_equal", x, y, cond, name)


def greater_than(x, y, cond=None, name=None):
    return _cmp_layer("greater_than", x, y, cond, name)


def logical_and(x, y, out=None, name=None):
    return _cmp_layer("logical_and", x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _cmp_layer("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _cmp_layer("logical_xor", x, y, out, name)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference("bool",
                                                        shape=x.shape)
    helper.append_op("logical_not", {"X": [x]}, {"Out": [out]})
    return out



# -- the training rewrites' layers (reference nn_extras.py) -----------

def pad(x, paddings, pad_value=0.0, name=None):
    shape = tuple(s + paddings[2 * i] + paddings[2 * i + 1]
                  for i, s in enumerate(x.shape))
    return _simple("pad", {"X": [x]},
                   {"paddings": list(paddings), "pad_value": pad_value},
                   out_shape=shape, name=name)


def shape(input, name=None):
    return _simple("shape", {"Input": [input]},
                   out_shape=(len(input.shape),), out_dtype="int64",
                   name=name)


def scatter(input, index, updates, name=None, overwrite=True):
    return _simple("scatter",
                   {"X": [input], "Ids": [index], "Updates": [updates]},
                   {"overwrite": overwrite}, name=name)


def maxout(x, groups, name=None):
    n, c, h, w = x.shape
    return _simple("maxout", {"X": [x]}, {"groups": groups},
                   out_shape=(n, c // groups, h, w), name=name)


def isfinite(x, name=None):
    """Scalar bool: every element finite (isfinite_op.cc)."""
    helper = LayerHelper("isfinite", name=name)
    out = helper.create_variable_for_type_inference(
        "bool", shape=(), stop_gradient=True)
    helper.append_op("isfinite", {"X": [x]}, {"Out": [out]})
    return out


def has_inf(x, name=None):
    """Scalar bool: any element infinite (overflow-guard family)."""
    helper = LayerHelper("has_inf", name=name)
    out = helper.create_variable_for_type_inference(
        "bool", shape=(), stop_gradient=True)
    helper.append_op("has_inf", {"X": [x]}, {"Out": [out]})
    return out


def has_nan(x, name=None):
    helper = LayerHelper("has_nan", name=name)
    out = helper.create_variable_for_type_inference(
        "bool", shape=(), stop_gradient=True)
    helper.append_op("has_nan", {"X": [x]}, {"Out": [out]})
    return out


def sum(x, name=None):  # noqa: A001 — reference layer name
    """Sum a LIST of same-shaped tensors (sum_op.cc; the reference
    fluid.layers.sum — delegates to sums(), which also propagates the
    sequence-length alias).  For one tensor's reduction use
    ``reduce_sum``."""
    from .nn import sums

    return sums(list(x) if isinstance(x, (list, tuple)) else [x])


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Debug-print a tensor each execution and pass it through
    (reference control_flow.py Print / print_op.cc; lowers to
    jax.debug.print — the formatting knobs are accepted for API parity,
    the printed payload is the runtime array)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op("print", {"In": [input]}, {"Out": [out]},
                     {"message": message or "",
                      "first_n": first_n, "summarize": summarize,
                      "print_phase": print_phase})
    if seq_len_var(input) is not None:  # identity op: keep the length
        _alias_len(out, seq_len_var(input))
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 step counter incremented once per run
    (reference layers/nn.py autoincreased_step_counter — the global-step
    the LR schedulers consume)."""
    from .learning_rate_scheduler import _step_counter

    return _step_counter(counter_name or "@STEP_COUNTER@",
                         begin=begin, step=step)


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise Adaptive Rate Scaling: per-param LR =
    lr * ||param|| / (||grad|| + weight_decay * ||param||)
    (reference layers/nn.py append_LARS)."""
    from .nn import elementwise_add, elementwise_div, elementwise_mul
    from .nn import scale as _scale

    def _norm(v):
        helper = LayerHelper("l2_norm")
        out = helper.create_variable_for_type_inference(v.dtype, shape=())
        helper.append_op("squared_l2_norm", {"X": [v]}, {"Out": [out]})
        return sqrt_layer(out)

    def sqrt_layer(v):
        helper = LayerHelper("sqrt")
        out = helper.create_variable_for_type_inference(v.dtype,
                                                        shape=v.shape)
        helper.append_op("sqrt", {"X": [v]}, {"Out": [out]})
        return out

    decayed = []
    for param, grad in params_grads:
        p_norm = _norm(param)
        g_norm = _norm(grad)
        denom = elementwise_add(g_norm,
                                _scale(p_norm, scale=float(weight_decay)))
        ratio = elementwise_div(p_norm, denom)
        decayed.append(elementwise_mul(ratio, learning_rate, axis=0))
    return decayed


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    """Cumulative sum along ``axis`` (cum_op.cc)."""
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("cumsum", {"X": [x]}, {"Out": [out]},
                     {"axis": axis, "exclusive": exclusive,
                      "reverse": reverse})
    return out
