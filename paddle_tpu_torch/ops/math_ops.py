"""Math op rules: elementwise (with axis-broadcast), relu, sigmoid,
tanh, gelu, log, square, pow, softmax, reductions, ``mul``, ``matmul``,
``scale``, ``sum``, ``cast``, ``mean``, the comparisons and the logical
ops.

The port of the part of ``paddle_tpu/ops/math_ops.py`` that the
Transformer's, the stacked LSTM's, DeepFM's and machine translation's
training programs, machine translation's beam search and the fc/SGD
drive use.  Each rule is plain PyTorch; ``mul`` is a torch matrix
product, as the reference left its matmuls to XLA.  Scalars from attrs
enter as float32 values of the tensor's dtype, as the reference's
``jnp.asarray(v, x.dtype)`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register, register_grad
from ..core.selected_rows import SelectedRows
from ._util import torch_dtype


def broadcast_y(x, y, axis: int):
    """The reference's axis-broadcast (elementwise_op_function.h): Y
    aligns with X's dims starting at ``axis``; -1 aligns trailing dims."""
    if x.shape == y.shape:
        return y
    if axis == -1 or axis is None:
        return y  # trailing alignment == numpy broadcasting
    new_shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        new_shape[axis + i] = s
    return y.reshape(new_shape)


def promote(x, y):
    """x and y in their common dtype, as jnp promotes the operands of a
    product (``torch.promote_types`` agrees for float types); autograd
    casts each gradient back to its operand's own dtype."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _ew(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [fn(x, broadcast_y(x, y, attrs.get("axis", -1)))]}
    return lower


register("elementwise_add")(_ew(torch.add))
register("elementwise_sub")(_ew(torch.sub))
register("elementwise_mul")(_ew(torch.mul))
register("elementwise_div")(_ew(torch.div))
register("elementwise_min")(_ew(torch.minimum))


class _Relu(torch.autograd.Function):
    """``torch.relu`` with the reference's gradient (``jax.nn.relu``'s):
    the cotangent where x > 0, else 0.  torch's own passes it where its
    output is NaN, so a NaN input would send NaN gradients on where the
    reference sends 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x > 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))


def relu(x):
    """relu (the reference's forward and gradient, :class:`_Relu`)."""
    return _Relu.apply(x)


@register("relu")
def _relu(ctx, ins, attrs):
    return {"Out": [relu(ins["X"][0])]}


@register("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": [torch.sigmoid(ins["X"][0])]}


@register("tanh")
def _tanh(ctx, ins, attrs):
    return {"Out": [torch.tanh(ins["X"][0])]}


@register("log")
def _log(ctx, ins, attrs):
    """Natural log.  A subnormal input counts as zero (-inf out), as in
    the reference, whose XLA treats subnormals as zero: ``log(softmax)``
    then gives -inf in both packages where a probability underflows."""
    x = ins["X"][0]
    if x.is_floating_point():
        x = torch.where(x.abs() < torch.finfo(x.dtype).tiny,
                        torch.zeros((), dtype=x.dtype, device=x.device), x)
    return {"Out": [torch.log(x)]}


@register("gelu")
def _gelu(ctx, ins, attrs):
    """``jax.nn.gelu``: the tanh approximation unless ``approximate`` is
    False (torch's own default is the erf form)."""
    approx = "tanh" if attrs.get("approximate", True) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approx)]}


@register("square")
def _square(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0])]}


@register("pow")
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


@register("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


def _reduce(fn):
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x)
            if keep:
                out = out.reshape([1] * x.dim())
            return {"Out": [out]}
        dim = attrs.get("dim", [0])
        axes = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        return {"Out": [fn(x, dim=axes, keepdim=keep)]}
    return lower


register("reduce_sum")(_reduce(torch.sum))


@register("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}


def flatten_to_2d(x, num_col_dims: int):
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    return x.reshape(lead, -1)


@register("mul")
def _mul(ctx, ins, attrs):
    """mul_op.cc: X flattened to 2-D at ``x_num_col_dims``, Y at
    ``y_num_col_dims``; the FC core."""
    x, y = ins["X"][0], ins["Y"][0]
    x, y = promote(x, y)
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    out = torch.matmul(flatten_to_2d(x, xnc), flatten_to_2d(y, ync))
    return {"Out": [out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))]}


@register("matmul")
def _matmul(ctx, ins, attrs):
    """matmul_op.cc: ``transpose_X``/``transpose_Y`` swap the last two
    axes (of an operand with at least two), leading axes broadcast as a
    batch, and the product is scaled by ``alpha``."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(*promote(x, y))
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if not x.is_floating_point():
        scale, bias = int(scale), int(bias)
    else:  # rounded to x's dtype first, as the reference's jnp.asarray
        scale, bias = (torch.tensor(c, dtype=x.dtype).item()
                       for c in (scale, bias))
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register("sum")
def _sum(ctx, ins, attrs):
    """Elementwise sum.  Over ``SelectedRows`` gradients (a table looked
    up more than once with ``is_sparse``) the sum is the rows and values
    concatenated at the first input's height, duplicates merged later by
    the consumer; a mix of sparse and dense inputs goes dense."""
    xs = ins["X"]
    sparse = [x for x in xs if isinstance(x, SelectedRows)]
    if sparse:
        if len(sparse) == len(xs):
            return {"Out": [SelectedRows(
                torch.cat([s.rows for s in sparse]),
                torch.cat([s.values for s in sparse]), sparse[0].height)]}
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register("cast", no_grad_slots=())
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


# compare_op.cc / logical_op.cc: bool results, Y axis-broadcast
for _name, _fn in (("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("equal", torch.eq), ("not_equal", torch.ne),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    register(_name, no_grad_slots=("X", "Y"))(_ew(_fn))


@register("logical_not", no_grad_slots=("X",))
def _logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register_grad("cast")
def _cast_grad(ctx, ins, attrs):
    g = ins["Out@GRAD"][0]
    x = ins["X"][0]
    return {"X@GRAD": [g.to(x.dtype)]}


__all__ = ["broadcast_y", "flatten_to_2d", "promote"]
