"""Sequence op rules over the padded [B, T, ...] + lengths contract.

The port of ``paddle_tpu/ops/sequence_ops.py``: a variable-length batch
is a padded dense tensor with an explicit ``SeqLen`` length vector, so
the sequence ops are masked reductions, gathers and shifts.  Lengths
stay tensors on the op's device: no rule reads them back to the host.
The nested (level-2) form runs seven ops over the flattened
``[B*S, W, ...]`` view (``_nestable``, at the end of the file).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register
from ._util import torch_dtype


def _mask(x, seq_len):
    """[B, T] validity mask broadcastable to x [B, T, ...]."""
    B, T = x.shape[0], x.shape[1]
    m = torch.arange(T, device=x.device)[None, :] < seq_len[:, None]
    return m.reshape((B, T) + (1,) * (x.dim() - 2))


def left_compact(ids, keep):
    """Stable left-compaction of the kept [B, T] entries: kept values
    move to the front in their order; returns them and the new per-row
    count (shared by sequence_erase and ctc_align)."""
    T = ids.shape[1]
    key = (~keep).long() * T + torch.arange(T, device=ids.device)[None, :]
    order = torch.argsort(key, dim=1, stable=True)
    compacted = torch.gather(ids, 1, order)
    new_len = keep.sum(dim=1).to(torch.int64)
    return compacted, new_len


def _along_time(x, idx):
    """x[b, idx[b, t], ...] for an index tensor [B, T'] (the reference's
    ``take_along_axis`` on axis 1)."""
    tail = tuple(x.shape[2:])
    full = idx.long().reshape(idx.shape + (1,) * len(tail)).expand(
        tuple(idx.shape) + tail)
    return torch.gather(x, 1, full)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register("sequence_pool", no_grad_slots=("SeqLen",))
def _sequence_pool(ctx, ins, attrs):
    """SUM, AVERAGE, SQRT, MAX, LAST or FIRST over each row's live
    steps.  MAX takes ``torch.amax``, whose gradient splits evenly
    between tied maxima as ``jnp.max``'s does; a length-0 row pools to
    0 under every type (in the nested form the padding sentences are
    such rows)."""
    x = ins["X"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    tail = (1,) * (x.dim() - 2)
    if seq_len is None:
        m = torch.ones(x.shape[:2] + tail, dtype=x.dtype, device=x.device)
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    else:
        m = _mask(x, seq_len).to(x.dtype)
        lens = seq_len
    if ptype == "SUM":
        out = (x * m).sum(dim=1)
    elif ptype == "AVERAGE":
        denom = lens.reshape((-1,) + tail).to(x.dtype)
        out = (x * m).sum(dim=1) / torch.clamp(denom, min=1)
    elif ptype == "SQRT":
        denom = torch.sqrt(lens.reshape((-1,) + tail).to(x.dtype))
        out = (x * m).sum(dim=1) / torch.clamp(denom, min=1)
    elif ptype == "MAX":
        neg = torch.full((), torch.finfo(torch.float32).min, dtype=x.dtype,
                         device=x.device)
        out = torch.amax(torch.where(m > 0, x, neg), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp(lens - 1, min=0)
        out = _along_time(x, idx.reshape(-1, 1)).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    if ptype in ("MAX", "LAST", "FIRST") and seq_len is not None:
        alive = (lens > 0).reshape((-1,) + tail)
        out = torch.where(alive, out, _zero(x))
    return {"Out": [out]}


@register("sequence_softmax", no_grad_slots=("SeqLen",))
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's live steps (axis 1) in float32, dead
    steps 0, cast back to x's dtype."""
    x = ins["X"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    if seq_len is None:
        return {"Out": [torch.softmax(x, dim=1)]}
    m = _mask(x, seq_len)
    neg = torch.tensor(-1e9, dtype=torch.float32, device=x.device)
    logits = torch.where(m, x.float(), neg)
    out = torch.softmax(logits, dim=1) * m.float()
    return {"Out": [out.to(x.dtype)]}


@register("sequence_expand", no_grad_slots=("SeqLen",))
def _sequence_expand(ctx, ins, attrs):
    """[B, D] (or [B, 1, D]) broadcast over Y's time axis."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() == y.dim():
        shape = tuple(y.shape[:2]) + tuple(x.shape[2:])
        return {"Out": [x.expand(shape).contiguous()]}
    shape = (x.shape[0], y.shape[1]) + tuple(x.shape[1:])
    return {"Out": [x[:, None].expand(shape).contiguous()]}


@register("sequence_reverse", no_grad_slots=("SeqLen",))
def _sequence_reverse(ctx, ins, attrs):
    """Each row's live prefix reversed in place; the padding stays."""
    x = ins["X"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    if seq_len is None:
        return {"Out": [torch.flip(x, [1])]}
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = torch.where(t < seq_len[:, None], seq_len[:, None] - 1 - t, t)
    return {"Out": [_along_time(x, idx)]}


@register("sequence_concat", no_grad_slots=("SeqLen",))
def _sequence_concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=1)]}


@register("sequence_first_step", no_grad_slots=("SeqLen",))
def _sequence_first_step(ctx, ins, attrs):
    return {"Out": [ins["X"][0][:, 0]]}


@register("sequence_last_step", no_grad_slots=("SeqLen",))
def _sequence_last_step(ctx, ins, attrs):
    """Each row's last live step: ``sequence_pool`` with LAST."""
    return _sequence_pool(ctx, ins, {"pooltype": "LAST"})


@register("sequence_conv", no_grad_slots=("SeqLen",))
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over [B, T, D]: each position sees
    ``contextLength`` steps from ``contextStart``; context out of range
    or past the length is zero.  Filter: [contextLength * D, out_dim]."""
    x = ins["X"][0]
    w = ins["Filter"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    cl = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    cs = int(attrs.get("contextStart", attrs.get("context_start", -(cl // 2))))
    if int(attrs.get("contextStride", 1)) != 1:
        raise NotImplementedError(
            "sequence_conv: contextStride != 1 is unsupported (as in the "
            "reference, sequence_conv_op.cc enforces stride == 1)")
    T = x.shape[1]
    xm = x if seq_len is None else x * _mask(x, seq_len).to(x.dtype)
    t = torch.arange(T, device=x.device)
    cols = []
    for i in range(cl):
        off = cs + i
        shifted = torch.roll(xm, -off, dims=1)
        valid = (t + off >= 0) & (t + off < T)
        cols.append(torch.where(valid[None, :, None], shifted, _zero(xm)))
    ctx_mat = torch.cat(cols, dim=-1)                  # [B, T, cl * D]
    out = torch.einsum("btd,de->bte", ctx_mat, w.to(ctx_mat.dtype))
    if seq_len is not None:
        out = out * _mask(out, seq_len).to(out.dtype)
    return {"Out": [out]}


@register("sequence_slice", no_grad_slots=("Offset", "Length", "SeqLen"))
def _sequence_slice(ctx, ins, attrs):
    """Each row's [offset, offset + length) left-aligned into the padded
    layout."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).long()
    length = ins["Length"][0].reshape(-1).long()
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = torch.clamp(t + off[:, None], 0, T - 1)
    out = _along_time(x, src)
    keep = (t < length[:, None]).reshape(
        (x.shape[0], T) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(keep, out, _zero(out))],
            "OutLen": [length.to(torch.int64)]}


def _ids_2d(x):
    """Id sequences [B, T] or [B, T, 1]: the [B, T] view and whether the
    trailing 1 was there."""
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    return (x.reshape(x.shape[0], x.shape[1]) if squeeze else x), squeeze


@register("sequence_erase", no_grad_slots=("SeqLen",))
def _sequence_erase(ctx, ins, attrs):
    """Drop the listed tokens and left-compact: compacted ids and new
    lengths."""
    x = ins["X"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    ids, squeeze = _ids_2d(x)
    B, T = ids.shape
    t = torch.arange(T, device=ids.device)[None, :]
    valid = t < (seq_len[:, None] if seq_len is not None else T)
    tokens = list(attrs.get("tokens", []))
    if tokens:
        erase = torch.isin(ids, torch.tensor(tokens, dtype=ids.dtype,
                                             device=ids.device))
    else:
        erase = torch.zeros_like(valid)
    compacted, new_len = left_compact(ids, valid & ~erase)
    out = torch.where(t < new_len[:, None], compacted, _zero(compacted))
    if squeeze:
        out = out[..., None]
    return {"Out": [out], "OutLen": [new_len]}


@register("sequence_enumerate", no_grad_slots=("SeqLen",))
def _sequence_enumerate(ctx, ins, attrs):
    """Windows of ``win_size`` ids at each position, [B, T] ->
    [B, T, win]; ids past the row's end read ``pad_value``."""
    x = ins["X"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    ids, _ = _ids_2d(x)
    B, T = ids.shape
    win = int(attrs["win_size"])
    pad = torch.tensor(attrs.get("pad_value", 0), dtype=ids.dtype,
                       device=ids.device)
    lens = (seq_len[:, None] if seq_len is not None
            else torch.full((B, 1), T, device=ids.device))
    t = torch.arange(T, device=ids.device)[None, :]
    outs = [torch.where((t + i) < lens, torch.roll(ids, -i, dims=1), pad)
            for i in range(win)]
    return {"Out": [torch.stack(outs, dim=-1)]}


@register("sequence_expand_as", no_grad_slots=("SeqLen",))
def _sequence_expand_as(ctx, ins, attrs):
    """One row vector a sequence broadcast over Y's time axis, masked by
    Y's lengths."""
    x, y = ins["X"][0], ins["Y"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    out = x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))
    if seq_len is not None:
        out = out * _mask(out, seq_len).to(out.dtype)
    return {"Out": [out.contiguous()]}


@register("sequence_pad", no_grad_slots=("PadValue", "SeqLen"))
def _sequence_pad(ctx, ins, attrs):
    """The tail rewritten to ``PadValue`` up to ``padded_length``, and
    each row's length."""
    x = ins["X"][0]
    pad_value = (ins["PadValue"][0].reshape(()) if ins.get("PadValue")
                 else torch.tensor(0.0, device=x.device))
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    padded_len = int(attrs.get("padded_length", -1))
    T = x.shape[1]
    if padded_len > 0 and padded_len != T:
        if padded_len > T:
            widths = [0, 0] * (x.dim() - 2) + [0, padded_len - T]
            x = F.pad(x, widths)
        else:
            x = x[:, :padded_len]
    lens = (seq_len if seq_len is not None
            else torch.full((x.shape[0],), T, dtype=torch.int64,
                            device=x.device))
    out = torch.where(_mask(x, lens), x, pad_value.to(x.dtype))
    return {"Out": [out], "Length": [lens.to(torch.int64)]}


@register("sequence_unpad", no_grad_slots=("Length",))
def _sequence_unpad(ctx, ins, attrs):
    """The inverse of sequence_pad: the tail zeroed, the lengths passed
    on."""
    x = ins["X"][0]
    lens = ins["Length"][0].reshape(-1)
    return {"Out": [torch.where(_mask(x, lens), x, _zero(x))],
            "OutLen": [lens.to(torch.int64)]}


@register("sequence_reshape", no_grad_slots=("SeqLen",))
def _sequence_reshape(ctx, ins, attrs):
    """Step width D -> ``new_dim``, merging or splitting steps; lengths
    scale by D / new_dim in integers."""
    x = ins["X"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    new_dim = int(attrs["new_dim"])
    B, T, D = x.shape[0], x.shape[1], x.shape[-1]
    total = T * D
    assert total % new_dim == 0, (T, D, new_dim)
    outs = {"Out": [x.reshape(B, total // new_dim, new_dim)]}
    if seq_len is not None:
        outs["OutLen"] = [torch.div(seq_len * D, new_dim,
                                    rounding_mode="floor").to(torch.int64)]
    return outs


@register("row_conv", no_grad_slots=("SeqLen",))
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (DeepSpeech2): out[b, t] =
    sum_i x[b, t + i] * w[i], i in [0, future_context), per feature."""
    x = ins["X"][0]                    # [B, T, D]
    w = ins["Filter"][0]               # [k, D]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    T = x.shape[1]
    xm = x if seq_len is None else x * _mask(x, seq_len).to(x.dtype)
    out = torch.zeros_like(xm)
    t = torch.arange(T, device=x.device)
    for i in range(w.shape[0]):
        shifted = torch.roll(xm, -i, dims=1)
        ok = (t + i) < T
        out = out + torch.where(ok[None, :, None], shifted,
                                _zero(xm)) * w[i][None, None, :]
    if seq_len is not None:
        out = out * _mask(out, seq_len).to(out.dtype)
    return {"Out": [out]}


@register("sequence_mask", no_grad_slots=("X",))
def _sequence_mask(ctx, ins, attrs):
    """X holds lengths; Y[..., j] = j < X[...], at a static maxlen."""
    x = ins["X"][0]
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError(
            "sequence_mask requires a static maxlen (a dynamic max-length "
            "would make the output shape data-dependent)")
    dt = torch_dtype(attrs.get("out_dtype", "int64"))
    mask = torch.arange(maxlen, device=x.device)[None, :] < x.reshape(-1, 1)
    return {"Y": [mask.reshape(tuple(x.shape) + (maxlen,)).to(dt)]}


@register("im2sequence", no_grad_slots=("SeqLen",))
def _im2sequence(ctx, ins, attrs):
    """NCHW image -> [B, oh * ow, C * kh * kw] patch sequence (features
    in (C, kh, kw) order, as ``F.unfold`` gives them) and a constant
    length a sample; paddings (up, left, down, right)."""
    x = ins["X"][0]
    kh, kw = attrs["kernels"]
    st = attrs.get("strides", [1, 1])
    pd = attrs.get("paddings", [0, 0, 0, 0])
    n = x.shape[0]
    xp = F.pad(x, (pd[1], pd[3], pd[0], pd[2]))
    patches = F.unfold(xp, (kh, kw), stride=tuple(st))   # [N, C*kh*kw, L]
    seq = patches.transpose(1, 2)
    lens = torch.full((n,), seq.shape[1], dtype=torch.int64, device=x.device)
    return {"Out": [seq], "OutLen": [lens]}


@register("sequence_scatter", no_grad_slots=("Ids", "SeqLen"))
def _sequence_scatter(ctx, ins, attrs):
    """out = X; out[i, ids[i, j]] += updates[i, j] over the live j
    (duplicate ids add up)."""
    x = ins["X"][0]
    ids = ins["Ids"][0].long()
    upd = ins["Updates"][0]
    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    B, T = ids.shape[0], ids.shape[1]
    if seq_len is not None:
        valid = torch.arange(T, device=x.device)[None, :] < seq_len[:, None]
    else:
        valid = torch.ones((B, T), dtype=torch.bool, device=x.device)
    upd = torch.where(valid.reshape(valid.shape + (1,) * (upd.dim() - 2)),
                      upd, _zero(upd)).to(x.dtype)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
    return {"Out": [x.index_put((rows, ids), upd, accumulate=True)]}


@register("lod_reset", no_grad_slots=("Y", "TargetLenTensor"))
def _lod_reset(ctx, ins, attrs):
    """Data passes through; the new lengths are Y's lengths, or the
    ``target_lod`` offsets turned into lengths (the layer wires OutLen
    as Out's ``@LEN``)."""
    x = ins["X"][0]
    if ins.get("TargetLenTensor"):
        new_len = ins["TargetLenTensor"][0]
    elif ins.get("Y"):
        new_len = ins["Y"][0]
    else:
        tl = attrs.get("target_lod", [])
        new_len = torch.tensor([tl[i + 1] - tl[i] for i in range(len(tl) - 1)],
                               dtype=torch.int64, device=x.device)
    return {"Out": [x], "OutLen": [new_len.to(torch.int64)]}


# ---------------------------------------------------------------------------
# nested (lod_level 2) batches: [B, S, W, ...] + inner lengths [B, S]
# ---------------------------------------------------------------------------
# A padded-nested batch [B, S, W, ...] with inner lengths [B, S] is the
# level-1 batch [B*S, W, ...] with lengths [B*S].  The ops that work on
# the innermost level take the optional "SeqLen2" slot and run their
# level-1 rule over the flattened view; pooling removes the inner level
# (out [B, S, ...]; the layer makes the outer lengths its companion).
# Sentence slots past a sample's outer length have length 0 and pool to
# zeros, masked downstream by the outer lengths.

_NESTED_INNER_OPS = ("sequence_pool", "sequence_softmax", "sequence_reverse",
                     "sequence_first_step", "sequence_last_step",
                     "sequence_pad", "sequence_unpad")


def _nestable(fn):
    def wrapped(ctx, ins, attrs):
        if not ins.get("SeqLen2"):
            return fn(ctx, ins, attrs)
        x = ins["X"][0]
        B, S = x.shape[0], x.shape[1]
        sub = {k: v for k, v in ins.items() if k != "SeqLen2"}
        sub["X"] = [x.reshape((B * S,) + tuple(x.shape[2:]))]
        sub["SeqLen"] = [ins["SeqLen2"][0].reshape(-1)]
        out = fn(ctx, sub, attrs)
        o = out["Out"][0]
        out["Out"] = [o.reshape((B, S) + tuple(o.shape[1:]))]
        for slot in ("Length", "OutLen"):
            if slot in out:
                out[slot] = [out[slot][0].reshape(B, S)]
        return out
    return wrapped


def _enable_nested():
    from ..core.registry import _REGISTRY

    for t in _NESTED_INNER_OPS:
        opdef = _REGISTRY[t]
        opdef.lower = _nestable(opdef.lower)
        opdef.no_grad_slots.add("SeqLen2")


_enable_nested()
