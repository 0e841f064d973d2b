"""Math op rules: elementwise (with axis-broadcast), the activations,
reductions, ``mul``, ``matmul``, ``scale``, ``sum``, ``cast``,
``mean``, ``clip``/``clip_by_norm``, the finiteness checks,
``cumsum``, the comparisons and the logical ops, and the two helpers of
``GradientClipByGlobalNorm``: every rule of
``paddle_tpu/ops/math_ops.py`` but ``maxout``, whose registered rule is
``misc_ops``'s.

Each rule is plain PyTorch; ``mul`` is a torch matrix product, as the
reference left its matmuls to XLA.  Scalars from attrs enter as values
of the tensor's dtype, as the reference's ``jnp.asarray(v, x.dtype)``
and jnp's weak-typed Python scalars do.

Gradients are the reference's (``jax.vjp`` of its rule), which differ
from torch's own at a few points; there the rule is written so that
autograd gives jax's:

- ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, so at either bound
  the gradient is 0.5 (``relu6``, ``brelu``, ``hard_sigmoid``,
  ``clip``, ``soft_relu``); :func:`clip` composes the same way, where
  ``torch.clamp`` would give 1;
- ``abs`` passes the cotangent where x >= 0 and its negation elsewhere
  (1 at 0, torch's 0): :class:`_Abs`;
- ``leaky_relu``/``elu`` select with ``x >= 0`` (1 at 0, torch's
  alpha), so they are the reference's ``where``;
- ``relu`` (:class:`_Relu`): 0 where x <= 0 or NaN.

A ``SelectedRows`` operand (a sparse table's gradient) is taken where
the reference takes it: ``elementwise_mul``/``_div`` by a 0-d Y,
``clip``, ``clip_by_norm`` and ``__global_norm_sq__`` (those three
merge duplicate rows first) and ``sum``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register, register_grad
from ..core.selected_rows import SelectedRows, merge_rows, run_shared
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


def _const(v, like):
    """A 0-d tensor of ``like``'s dtype and device holding ``v`` (a fill,
    no host copy): jnp's weak-typed Python scalar."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, its gradient split
    0.5/0.5 at either bound as jax's ``maximum``/``minimum`` split ties
    (``torch.clamp`` would pass it all); a None bound is open."""
    if lo is not None:
        x = torch.maximum(x, _const(lo, x))
    if hi is not None:
        x = torch.minimum(x, _const(hi, x))
    return x


def _ew(fn, sparse_scalar_ok=False, name=None):
    """An elementwise rule; ``name`` is jnp's name of the function, which
    the refusal of a SelectedRows operand gives, as the reference's."""
    name = name or fn.__name__

    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        if isinstance(x, SelectedRows):
            # only f with f(0, y) == 0 (mul/div) may skip the absent zero
            # rows; anything else would silently diverge from dense semantics
            if sparse_scalar_ok and torch.is_tensor(y) and y.dim() == 0:
                return {"Out": [SelectedRows(x.rows, fn(x.values, y), x.height,
                                             merged=x.merged)]}
            raise NotImplementedError(
                f"elementwise op {name!r} over a SelectedRows operand")
        return {"Out": [fn(x, broadcast_y(x, y, attrs.get("axis", -1)))]}
    return lower


def _floor_divide(x, y):
    """``jnp.floor_divide``: its gradient is 0 (a rounding), so the
    result carries none (torch's ``floor_divide`` has no derivative)."""
    return torch.floor_divide(x.detach(), y.detach())


register("elementwise_add")(_ew(torch.add))
register("elementwise_sub")(_ew(torch.sub, name="subtract"))
register("elementwise_mul")(_ew(torch.mul, True, "multiply"))
register("elementwise_div")(_ew(torch.div, True, "divide"))
register("elementwise_max")(_ew(torch.maximum))
register("elementwise_min")(_ew(torch.minimum))
register("elementwise_pow")(_ew(torch.pow, name="power"))
register("elementwise_mod")(_ew(torch.remainder, name="mod"))
register("elementwise_floordiv")(_ew(_floor_divide, name="floor_divide"))


# ---------------------------------------------------------------------------
# activations (activation_op.cc functor zoo), in the reference's order
# ---------------------------------------------------------------------------

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


class _Abs(torch.autograd.Function):
    """``torch.abs`` with jax's gradient: the cotangent where x >= 0 and
    its negation elsewhere (a NaN x included); torch's own is 0 at 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _act(fn, needs_attrs=False):
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        return {"Out": [fn(x, attrs) if needs_attrs else fn(x)]}
    return lower


def _log(x):
    """Natural log.  A subnormal input counts as zero (-inf out), as in
    the reference, whose XLA treats subnormals as zero: ``log(softmax)``
    then gives -inf in both packages where a probability underflows."""
    if x.is_floating_point():
        x = torch.where(x.abs() < torch.finfo(x.dtype).tiny,
                        torch.zeros((), dtype=x.dtype, device=x.device), x)
    return torch.log(x)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``softplus``
    switches to x past its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _softshrink(x, a):
    lam = a["lambda"]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam, zero))


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


register("relu")(_act(relu))
register("sigmoid")(_act(torch.sigmoid))
register("logsigmoid")(_act(F.logsigmoid))
register("tanh")(_act(torch.tanh))
register("tanh_shrink")(_act(lambda x: x - torch.tanh(x)))
register("exp")(_act(torch.exp))
register("log")(_act(_log))
register("square")(_act(torch.square))
register("sqrt")(_act(torch.sqrt))
register("rsqrt")(_act(torch.rsqrt))
register("abs")(_act(_Abs.apply))
register("ceil")(_act(torch.ceil))
register("floor")(_act(torch.floor))
register("round")(_act(torch.round))       # half to even, as jnp.round
register("reciprocal")(_act(torch.reciprocal))
register("sin")(_act(torch.sin))
register("cos")(_act(torch.cos))
register("softplus")(_act(_softplus))
register("softsign")(_act(lambda x: x / (torch.abs(x) + 1)))
register("softshrink")(_act(_softshrink, needs_attrs=True))
register("relu6")(_act(lambda x: clip(x, 0.0, 6.0)))
register("leaky_relu")(_act(
    lambda x, a: torch.where(x >= 0, x, a.get("alpha", 0.02) * x),
    needs_attrs=True))
register("elu")(_act(
    lambda x, a: torch.where(x >= 0, x,
                             a.get("alpha", 1.0) * (torch.exp(x) - 1)),
    needs_attrs=True))


@register("gelu")
def _gelu(ctx, ins, attrs):
    """``jax.nn.gelu``: the tanh approximation unless ``approximate`` is
    False (torch's own default is the erf form)."""
    approx = "tanh" if attrs.get("approximate", True) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approx)]}


register("swish")(_act(
    lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x), needs_attrs=True))
register("hard_sigmoid")(_act(
    lambda x, a: clip(a.get("slope", 0.2) * x + a.get("offset", 0.5),
                      0.0, 1.0), needs_attrs=True))
register("brelu")(_act(
    lambda x, a: clip(x, a.get("t_min", 0.0), a.get("t_max", 24.0)),
    needs_attrs=True))
register("pow")(_act(lambda x, a: torch.pow(x, a.get("factor", 1.0)),
                     needs_attrs=True))
register("stanh")(_act(
    lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(a.get("scale_a", 0.67)
                                                       * x),
    needs_attrs=True))
register("hard_shrink")(_act(
    lambda x, a: _where0(torch.abs(x) > a.get("threshold", 0.5), x),
    needs_attrs=True))
register("thresholded_relu")(_act(
    lambda x, a: _where0(x > a.get("threshold", 1.0), x), needs_attrs=True))


@register("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


# ---------------------------------------------------------------------------
# reductions (reduce_op.h: dim / keep_dim / reduce_all attrs)
# ---------------------------------------------------------------------------

def _prod(x, dim=None, keepdim=False):
    """``jnp.prod`` over several axes (``torch.prod`` takes one)."""
    if dim is None:
        return torch.prod(x)
    for d in sorted((a % x.dim() for a in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


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


# amax/amin split the gradient evenly between tied maxima, as jax's
# reduce_max does (torch.max(dim) would give it to one)
register("reduce_sum")(_reduce(torch.sum))
register("reduce_mean")(_reduce(torch.mean))
register("reduce_max")(_reduce(torch.amax))
register("reduce_min")(_reduce(torch.amin))
register("reduce_prod")(_reduce(_prod))


@register("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

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


def _memo(ctx):
    """The run's memo (``LowerContext.run_memo``); None without a
    context."""
    return getattr(ctx, "run_memo", None)


@register("sum")
def _sum(ctx, ins, attrs):
    """Elementwise sum.  Over ``SelectedRows`` gradients (a table looked
    up more than once with ``is_sparse``, or a gradient and its sparse
    decay) the sum is the rows and values concatenated at the first
    input's height, duplicates merged later by the consumer; a mix of
    sparse and dense inputs goes dense."""
    xs = ins["X"]
    sparse = [x for x in xs if isinstance(x, SelectedRows)]
    if sparse:
        if len(sparse) == len(xs):
            # made once a run for the same row vectors: the tables one id
            # batch looks up then keep one row vector through a decay's
            # sum, and their fused updates share one sort
            rows = [s.rows for s in sparse]
            return {"Out": [SelectedRows(
                run_shared(_memo(ctx), "sum_rows", rows,
                           lambda: torch.cat(rows)),
                torch.cat([s.values for s in sparse]), sparse[0].height)]}
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register("cast", no_grad_slots=())
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(torch_dtype(attrs["out_dtype"]))]}


@register_grad("cast")
def _cast_grad(ctx, ins, attrs):
    g = ins["Out@GRAD"][0]
    x = ins["X"][0]
    return {"X@GRAD": [g.to(x.dtype)]}


@register("clip")
def _clip(ctx, ins, attrs):
    x = ins["X"][0]
    lo, hi = attrs.get("min"), attrs.get("max")
    if isinstance(x, SelectedRows):
        m = merge_rows(x, _memo(ctx))  # merge first: duplicates clip as
        return {"Out": [SelectedRows(  # the dense gradient does
            m.rows, clip(m.values, lo, hi), m.height, merged=True)]}
    return {"Out": [clip(x, lo, hi)]}


def _norm_factor(v, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(v)))
    factor = torch.where(norm > max_norm,
                         max_norm / torch.maximum(norm, _const(1e-12, norm)),
                         _const(1.0, norm))
    return factor.to(v.dtype)


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    if isinstance(x, SelectedRows):
        m = merge_rows(x, _memo(ctx))
        return {"Out": [SelectedRows(
            m.rows, m.values * _norm_factor(m.values, max_norm), m.height,
            merged=True)]}
    return {"Out": [x * _norm_factor(x, max_norm)]}


@register("isfinite")
def _isfinite(ctx, ins, attrs):
    """isfinite_op: every element of every input finite, one bool."""
    ok = None
    for x in ins["X"]:
        a = torch.all(torch.isfinite(x))
        ok = a if ok is None else torch.logical_and(ok, a)
    return {"Out": [ok]}


@register("has_inf")
def _has_inf(ctx, ins, attrs):
    return {"Out": [torch.any(torch.isinf(ins["X"][0]))]}


@register("has_nan")
def _has_nan(ctx, ins, attrs):
    return {"Out": [torch.any(torch.isnan(ins["X"][0]))]}


@register("soft_relu")
def _soft_relu(ctx, ins, attrs):
    """activation_op.cc SoftReluFunctor: log(1 + exp(clip(x, -t, t)))."""
    t = attrs.get("threshold", 40.0)
    return {"Out": [torch.log1p(torch.exp(clip(ins["X"][0], -t, t)))]}


@register("sign")
def _sign(ctx, ins, attrs):
    return {"Out": [torch.sign(ins["X"][0])]}


@register("cumsum")
def _cumsum(ctx, ins, attrs):
    """cum_op.cc along ``axis``, in the reference's form: ``exclusive``
    subtracts x, ``reverse`` sums from the end (and subtracts x again
    when exclusive)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
        if attrs.get("exclusive", False):
            out = out - x
    return {"Out": [out]}


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


# helpers for GradientClipByGlobalNorm (clip.py)
@register("__global_norm_sq__", no_grad_slots=("X",))
def _global_norm_sq(ctx, ins, attrs):
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        x = merge_rows(x, _memo(ctx)).values  # duplicates sum first
    return {"Out": [torch.sum(torch.square(x.to(torch.float32)))]}


@register("__global_norm_factor__", no_grad_slots=("X",))
def _global_norm_factor(ctx, ins, attrs):
    total_sq = ins["X"][0]
    clip_norm = attrs["clip_norm"]
    norm = torch.sqrt(total_sq)
    return {"Out": [clip_norm / torch.maximum(norm, _const(clip_norm, norm))]}


__all__ = ["broadcast_y", "clip", "flatten_to_2d", "promote", "relu"]
