"""Sequence op rules over the padded [B, T, ...] + lengths contract.

The port of ``sequence_pool`` and ``sequence_last_step`` from
``paddle_tpu/ops/sequence_ops.py``:
a variable-length batch is a padded dense tensor with an explicit
``SeqLen`` length vector, so pooling is a masked reduction.  The nested
(level-2, ``SeqLen2``) form is not ported yet and raises.
"""
from __future__ import annotations

import torch

from ..core.registry import register


def _mask(x, seq_len):
    """[B, T] validity mask broadcastable to x [B, T, ...]."""
    B, T = x.shape[0], x.shape[1]
    m = torch.arange(T, device=x.device)[None, :] < seq_len[:, None]
    return m.reshape((B, T) + (1,) * (x.dim() - 2))


@register("sequence_pool", no_grad_slots=("SeqLen",))
def _sequence_pool(ctx, ins, attrs):
    """SUM, AVERAGE, SQRT, MAX, LAST or FIRST over each row's live
    steps.  MAX takes ``torch.amax``, whose gradient splits evenly
    between tied maxima as ``jnp.max``'s does; a length-0 row pools to
    0 under every type."""
    if ins.get("SeqLen2"):
        raise NotImplementedError(
            "sequence_pool over a nested (lod_level 2) batch is not ported "
            "yet")
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
        idx = torch.clamp(lens - 1, min=0).long()
        out = torch.gather(x, 1, idx.reshape((-1, 1) + tail).expand(
            (-1, 1) + tuple(x.shape[2:]))).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    if ptype in ("MAX", "LAST", "FIRST") and seq_len is not None:
        # length-0 rows pool to 0, like the masked-sum family
        alive = (lens > 0).reshape((-1,) + tail)
        out = torch.where(alive, out, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return {"Out": [out]}


@register("sequence_last_step", no_grad_slots=("SeqLen",))
def _sequence_last_step(ctx, ins, attrs):
    """Each row's last live step: ``sequence_pool`` with LAST."""
    return _sequence_pool(ctx, ins, {"pooltype": "LAST"})
