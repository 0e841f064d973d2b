"""Layer DSL tail: the part of ``paddle_tpu/layers/nn_extras.py`` that
is ported (``cos_sim``, the sequence layers ``sequence_scatter``,
``sequence_mask``, ``lod_reset`` and ``im2sequence``, and the
comparison and logical layers), copied unchanged so the same calls
build the same program.  ``layers/__init__`` re-exports it, as the
reference's does.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _alias_len, _cmp_layer, _pair, _seq_op_with_len, seq_len_var

__all__ = [
    "cos_sim",
    "equal",
    "greater_than",
    "im2sequence",
    "less_equal",
    "lod_reset",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "not_equal",
    "sequence_mask",
    "sequence_scatter",
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

