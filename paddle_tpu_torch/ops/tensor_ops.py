"""Tensor manipulation / creation op rules.

The port of the part of ``paddle_tpu/ops/tensor_ops.py`` that the
Transformer's and the stacked LSTM's training programs use: reshape,
transpose, squeeze/unsqueeze, the dense ``lookup_table``, top_k,
assign_value, fill_constant, increment, the random initializers and
dropout.  Random
ops draw from ``torch.Generator`` objects the context hands out
(``core/registry.py``); they give other bits than the reference's
threefry keys, so a comparison starts both from copied values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register, register_grad
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
    """Embedding gather (lookup_table_op.cc): Ids may carry a trailing
    [..., 1] dim; padding_idx rows produce zeros.  The sparse
    (SelectedRows) gradient is not ported yet."""
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "lookup_table(is_sparse=True): the SelectedRows gradient is "
            "not ported yet; build the embedding with is_sparse=False")
    w, ids = ins["W"][0], _ids(ins["Ids"][0]).long()
    out = w[ids]
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_grad("lookup_table")
def _lookup_table_grad(ctx, ins, attrs):
    """W-grad of the dense gather: the cotangent rows added into a zero
    table at the looked-up ids (the reference's ``.at[rows].add``)."""
    ids = _ids(ins["Ids"][0]).long()
    gout = ins["Out@GRAD"][0]
    w = ins["W"][0]
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad != -1:
        gout = gout * (ids != pad).unsqueeze(-1).to(gout.dtype)
    rows = ids.reshape(-1)
    vals = gout.reshape((-1,) + tuple(gout.shape[ids.dim():])).to(w.dtype)
    return {"W@GRAD": [torch.zeros_like(w).index_add_(0, rows, vals)]}


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
