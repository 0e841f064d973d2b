"""Tensor manipulation / creation op rules.

The port of the part of ``paddle_tpu/ops/tensor_ops.py`` that the
Transformer's, the stacked LSTM's and DeepFM's training programs and
machine translation's beam search use: reshape, transpose,
squeeze/unsqueeze, slice, concat, ``expand`` and ``gather`` (forward
rules), ``lookup_table`` (its
gradient dense, or a ``SelectedRows`` with ``is_sparse``), arg_max, top_k,
assign, assign_value, fill_constant, fill_constant_batch_size_like,
increment, the random initializers
and dropout.  Random
ops draw from ``torch.Generator`` objects the context hands out
(``core/registry.py``); they give other bits than the reference's
threefry keys, so a comparison starts both from copied values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register, register_grad
from ..core.selected_rows import SelectedRows, take_rows
from ..core.types import np_dtype
from ._util import torch_dtype


@register("reshape")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = list(attrs["shape"])
    # reference semantics: 0 means copy input dim; -1 infers
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return {"Out": [x.reshape(shape)]}


@register("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register("squeeze")
def _squeeze(ctx, ins, attrs):
    axes = attrs.get("axes", [])
    x = ins["X"][0]
    return {"Out": [x.squeeze(tuple(axes)) if axes else x.squeeze()]}


@register("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    for ax in sorted(attrs["axes"]):
        x = x.unsqueeze(ax)
    return {"Out": [x]}


def _ids(ids):
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids


@register("lookup_table", no_grad_slots=("Ids",))
def _lookup_table(ctx, ins, attrs):
    """Embedding gather (lookup_table_op.cc) with ``jnp.take``'s rule:
    ids in [-H, 0) wrap, other out-of-range ids give a NaN row (a float
    table) or the clamped edge row (an integer one), with no device
    assert.  Ids may carry a trailing [..., 1] dim; padding_idx rows
    produce zeros.  With ``FLAGS_sparse_fused_kernel`` on, sparse
    lookups sharing their ids are gathered by K9 instead
    (``core/lowering.py``)."""
    w, ids = ins["W"][0], _ids(ins["Ids"][0])
    out = take_rows(w, ids)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_grad("lookup_table")
def _lookup_table_grad(ctx, ins, attrs):
    """W-grad of the gather.  With ``is_sparse`` it is a SelectedRows
    {flattened ids, cotangent rows} pair and the [height, D] gradient is
    never built; otherwise the cotangent rows are added into a zero
    table as the reference's ``.at[rows].add`` does: ids in [-H, 0)
    wrap and other out-of-range rows are dropped."""
    ids = _ids(ins["Ids"][0])
    gout = ins["Out@GRAD"][0]
    w = ins["W"][0]
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        gout = gout * (ids != pad).unsqueeze(-1).to(gout.dtype)
    rows = ids.reshape(-1)
    vals = gout.reshape((-1,) + tuple(gout.shape[ids.dim():])).to(w.dtype)
    sr = SelectedRows(rows, vals, w.shape[0])
    if attrs.get("is_sparse", False):
        return {"W@GRAD": [sr]}
    return {"W@GRAD": [sr.to_dense()]}


@register("slice")
def _slice(ctx, ins, attrs):
    """``x[starts:ends]`` along each of ``axes``; negative bounds count
    from the end and every bound is clamped to the axis."""
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(st, en)
    return {"Out": [x[tuple(idx)]]}


@register("expand")
def _expand(ctx, ins, attrs):
    """``jnp.tile``: each axis repeated ``expand_times`` times."""
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register("gather", no_grad_slots=("Index",))
def _gather(ctx, ins, attrs):
    """``jnp.take(x, index, axis)``: the rows (along ``axis``) that the
    integer ``Index`` names, in its shape."""
    x, index = ins["X"][0], ins["Index"][0]
    axis = attrs.get("axis", 0) % x.dim()
    out = torch.index_select(x, axis, index.reshape(-1).long())
    return {"Out": [out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                                + tuple(x.shape[axis + 1:]))]}


@register_grad("gather")
def _gather_grad(ctx, ins, attrs):
    """X-grad of the gather (``jnp.take``'s vjp): the cotangent's slices
    added into a zero X at their indices.  ``index_put_(accumulate=True)``
    sums the duplicates of an index in their order on every device and
    the same in every run (on the card ``index_add_`` would add with
    atomics in no fixed order)."""
    x, g = ins["X"][0], ins["Out@GRAD"][0]
    axis = attrs.get("axis", 0) % x.dim()
    idx = ins["Index"][0].reshape(-1).long()
    g = g.reshape(tuple(x.shape[:axis]) + (idx.numel(),)
                  + tuple(x.shape[axis + 1:])).movedim(axis, 0).to(x.dtype)
    dx = torch.zeros((x.shape[axis],) + tuple(g.shape[1:]), dtype=x.dtype,
                     device=x.device)
    dx.index_put_((idx,), g, accumulate=True)
    return {"X@GRAD": [dx.movedim(0, axis)]}


@register_grad("expand")
def _expand_grad(ctx, ins, attrs):
    """X-grad of the tile: the cotangent summed over the copies of each
    axis (``jnp.tile``'s vjp)."""
    x, g = ins["X"][0], ins["Out@GRAD"][0]
    times = tuple(attrs["expand_times"])
    n = max(x.dim(), len(times))
    reps = (1,) * (n - len(times)) + times
    shape = (1,) * (n - x.dim()) + tuple(x.shape)
    g = g.reshape([v for r, d in zip(reps, shape) for v in (r, d)])
    return {"X@GRAD": [g.sum(dim=tuple(range(0, 2 * n, 2)))
                       .reshape(x.shape).to(x.dtype)]}


@register("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register("assign")
def _assign(ctx, ins, attrs):
    """A copy: the sparse optimizers update tables in place, so an
    assigned value must not alias its source."""
    return {"Out": [ins["X"][0].clone()]}


@register("arg_max", no_grad_slots=("X",))
def _arg_max(ctx, ins, attrs):
    """The first index of each maximum along ``axis``, int64 (the CTC
    greedy decoder's per-step argmax)."""
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register("top_k", no_grad_slots=("X",))
def _top_k(ctx, ins, attrs):
    """The k largest values along the last axis and their int64 indices.
    A stable descending sort puts the lower index first among equal
    values, as ``lax.top_k`` does (``torch.topk`` promises no order)."""
    k = attrs["k"]
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k].to(torch.int64)]}


@register("assign_value")
def _assign_value(ctx, ins, attrs):
    """The op's literal, converted and copied to the device once per
    executor (keyed by the attr list itself, kept alive in the key);
    each run gets its own copy, which a persistable may update in
    place."""
    values = attrs["values"]
    dtype = attrs.get("dtype", "float32")
    key = ("assign_value", id(values), dtype, tuple(attrs["shape"]))
    hit = ctx.consts.get(key)
    if hit is None or hit[0] is not values:
        arr = np.asarray(values, dtype=np_dtype(dtype))
        t = torch.from_numpy(arr.reshape(attrs["shape"])).to(ctx.device)
        hit = ctx.consts[key] = (values, t)
    return {"Out": [hit[1].clone()]}


@register("increment")
def _increment(ctx, ins, attrs):
    x = ins["X"][0]
    step = attrs.get("step", 1.0)
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}


@register("fill_constant")
def _fill_constant(ctx, ins, attrs):
    dt = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(tuple(attrs["shape"]), attrs["value"],
                               dtype=dt, device=ctx.device)]}


@register("fill_constant_batch_size_like", no_grad_slots=("Input",))
def _fill_cbsl(ctx, ins, attrs):
    """``value`` in ``shape``, whose ``output_dim_idx`` axis takes the
    size of Input's ``input_dim_idx`` axis."""
    ref = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    dt = torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(tuple(shape), attrs["value"], dtype=dt,
                               device=ref.device)]}


def _generator(ctx, attrs) -> torch.Generator:
    seed = attrs.get("seed", 0)
    name = attrs.get("seed_name")
    if name:
        # initializer ops: keyed by var name → order-independent
        return ctx.named_prng(name, seed)
    if seed:
        return ctx.seeded_prng(seed)
    return ctx.prng()


@register("uniform_random", stateful=True)
def _uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(tuple(attrs["shape"]), generator=_generator(ctx, attrs),
                   device=ctx.device, dtype=torch.float32)
    out = u * (hi - lo) + lo
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register("gaussian_random", stateful=True)
def _gaussian_random(ctx, ins, attrs):
    x = torch.randn(tuple(attrs["shape"]), generator=_generator(ctx, attrs),
                    device=ctx.device, dtype=torch.float32)
    out = x * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register("dropout", stateful=True)
def _dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or not ctx.training
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        if impl == "upscale_in_train":
            return {"Out": [x], "Mask": [torch.ones_like(x)]}
        return {"Out": [x * (1.0 - p)], "Mask": [torch.ones_like(x)]}
    u = torch.rand(x.shape, generator=_generator(ctx, attrs),
                   device=x.device, dtype=torch.float32)
    keep = u < (1.0 - p)
    if impl == "upscale_in_train":
        mask = keep.to(x.dtype) * (1.0 / max(1.0 - p, 1e-8))
    else:
        mask = keep.to(x.dtype)
    return {"Out": [x * mask], "Mask": [mask]}


@register_grad("dropout")
def _dropout_grad(ctx, ins, attrs):
    return {"X@GRAD": [ins["Out@GRAD"][0] * ins["Mask"][0]]}
