"""Tensor manipulation / creation op rules: every rule of
``paddle_tpu/ops/tensor_ops.py``.

reshape(2), transpose(2), squeeze/unsqueeze, concat, split(_byref),
stack, slice, expand, pad, gather, scatter, ``lookup_table`` (its
gradient dense, or a ``SelectedRows`` with ``is_sparse``),
``sparse_decay`` (a regularizer's decay of a ``SelectedRows``
gradient), ``extract_rows``, one_hot, shape, assign, assign_value,
increment, the fills, ``range``, ``where``, arg_max/arg_min, top_k,
``print``, the random initializers and dropout.  Random ops draw from
``torch.Generator`` objects the context hands out
(``core/registry.py``); they give other bits than the reference's
threefry keys, so a comparison starts both from copied values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register, register_grad
from ..core.selected_rows import (SelectedRows, gather_rows, merge_rows,
                                  take_rows)
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


register("reshape2")(_reshape)  # alias; reference reshape2 also outputs XShape


@register("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


register("transpose2")(_transpose)


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


@register("scatter", no_grad_slots=("Ids",))
def _scatter(ctx, ins, attrs):
    """``x.at[ids].set(updates)`` (``overwrite``) or ``.add``: rows of X
    replaced by, or added to, the rows of Updates."""
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    idx = (ids.long(),)
    return {"Out": [x.index_put(idx, updates.to(x.dtype),
                                accumulate=not attrs.get("overwrite",
                                                         True))]}


@register("sparse_decay", no_grad_slots=("Param", "Grad"))
def _sparse_decay(ctx, ins, attrs):
    """A regularizer's decay of a SelectedRows gradient: only the
    touched rows decay (reference regularizer.py SelectedRows branch:
    extract_rows + row gather + scale).  Rows are merged first so
    duplicated lookups decay once, as the dense gradient's rows do; the
    tables one id batch looks up share the merge's sort (the run's
    memo, ``merge_rows``)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m = merge_rows(g, getattr(ctx, "run_memo", None))
    pr = gather_rows(p, m.rows).to(m.dtype)
    coeff = attrs.get("coeff", 0.0)
    vals = coeff * (torch.sign(pr) if attrs.get("mode", "l2") == "l1"
                    else pr)
    return {"Out": [SelectedRows(m.rows, vals, m.height, merged=True)]}


@register("extract_rows", no_grad_slots=("X",))
def _extract_rows(ctx, ins, attrs):
    """extract_rows_op.cc: the row-id vector of a SelectedRows value,
    as [N, 1]."""
    x = ins["X"][0]
    if not isinstance(x, SelectedRows):
        raise TypeError("extract_rows expects a SelectedRows input")
    return {"Out": [x.rows.reshape(-1, 1)]}


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


@register("split")
def _split(ctx, ins, attrs):
    """split_op.cc: X cut along ``axis`` into ``sections`` (their sizes)
    or ``num`` equal parts."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        sizes = list(sections)
    else:
        num = attrs.get("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: axis {axis} of size {x.shape[axis]} "
                             f"does not divide into {num} equal parts")
        sizes = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, sizes, dim=axis))}


register("split_byref")(_split)  # split_byref_op.cc: same math, by-ref out


@register("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register("pad")
def _pad(ctx, ins, attrs):
    """``jnp.pad`` with a constant: ``paddings`` is the flat [before0,
    after0, before1, after1, ...] list."""
    x = ins["X"][0]
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.dim())):   # F.pad lists the last axis first
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": [torch.nn.functional.pad(
        x, flat, value=attrs.get("pad_value", 0.0))]}


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


@register("arg_min", no_grad_slots=("X",))
def _arg_min(ctx, ins, attrs):
    """The first index of each minimum along ``axis``, int64."""
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))]}


@register("one_hot", no_grad_slots=("X",))
def _one_hot(ctx, ins, attrs):
    """``jax.nn.one_hot``: a trailing [..., 1] dim is dropped; an id
    outside [0, depth) gives a zero row."""
    x = _ids(ins["X"][0])
    depth = attrs["depth"]
    hot = x.unsqueeze(-1) == torch.arange(depth, device=x.device)
    return {"Out": [hot.to(torch_dtype(attrs.get("dtype", "float32")))]}


@register("shape", no_grad_slots=("Input",))
def _shape(ctx, ins, attrs):
    """The input's shape as an int32 vector."""
    x = ins["Input"][0]
    return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register("fill")
def _fill(ctx, ins, attrs):
    """fill_op.cc: Out holds the literal ``value`` list (row-major) in
    ``shape``."""
    data = np.asarray(attrs["value"], np_dtype(attrs.get("dtype", "float32")))
    return {"Out": [torch.from_numpy(data.reshape(attrs["shape"]))
                    .to(ctx.device)]}


@register("range", no_grad_slots=("Start", "End", "Step"))
def _range(ctx, ins, attrs):
    """``arange(start, end, step)`` from attrs; tensor bounds would give
    a data-dependent shape, which the reference refuses too."""
    if "Start" in ins:
        raise NotImplementedError("dynamic range not supported under XLA; "
                                  "use attrs")
    return {"Out": [torch.arange(attrs["start"], attrs["end"], attrs["step"],
                                 dtype=torch_dtype(attrs.get("dtype",
                                                             "int64")),
                                 device=ctx.device)]}


@register("where", no_grad_slots=("Condition",))
def _where(ctx, ins, attrs):
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


@register("print")
def _print(ctx, ins, attrs):
    """print_op: the tensor printed on the host each time the op runs,
    after ``message``, and passed through (a copy)."""
    x = ins["In"][0]
    print(attrs.get("message", "") + " {}".format(x.detach().cpu().numpy()),
          flush=True)
    return {"Out": [x.clone()]}


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


@register("truncated_gaussian_random", stateful=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    """A normal truncated to [-2, 2] standard deviations, drawn as
    ``jax.random.truncated_normal`` draws it (inverse erf of a uniform
    between erf(-2/sqrt2) and erf(2/sqrt2), clipped inside the bounds),
    then scaled by ``std`` and shifted by ``mean``."""
    gen = _generator(ctx, attrs)
    shape = tuple(attrs["shape"])
    root2 = torch.tensor(2.0, dtype=torch.float32).sqrt()
    lower = torch.tensor(-2.0, dtype=torch.float32)
    upper = torch.tensor(2.0, dtype=torch.float32)
    a, b = torch.erf(lower / root2), torch.erf(upper / root2)
    u = torch.rand(shape, generator=gen, device=ctx.device,
                   dtype=torch.float32)
    u = (u * (b - a) + a).to(ctx.device)
    x = root2.to(ctx.device) * torch.erfinv(u)
    inf = torch.tensor(float("inf"))
    x = torch.clamp(x, torch.nextafter(lower, inf).item(),
                    torch.nextafter(upper, -inf).item())
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
