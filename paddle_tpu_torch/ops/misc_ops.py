"""Miscellaneous op rules: the part of ``paddle_tpu/ops/misc_ops.py``
that the book models use (``cos_sim``, the recommender's tower
similarity), ``squared_l2_norm`` (``layers.append_LARS``) and
``maxout``."""
from __future__ import annotations

import torch

from ..core.registry import register


@register("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Row-wise cosine similarity of X and Y [B, D] (Y may have batch 1
    and broadcast); Out [B, 1], XNorm and YNorm the rows' norms."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(dim=-1, keepdim=True))
    dot = (x * y).sum(dim=-1, keepdim=True)
    return {"Out": [dot / (xn * yn + 1e-12)], "XNorm": [xn], "YNorm": [yn]}


@register("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    """sum(x * x) as a [1] tensor."""
    x = ins["X"][0]
    return {"Out": [torch.sum(x * x).reshape(1)]}


@register("maxout")
def _maxout(ctx, ins, attrs):
    """maxout_op.cc: NCHW channels split into ``groups``-wide groups,
    the max within each (``amax``: tied maxima share the gradient, as
    jax's max does)."""
    x = ins["X"][0]
    g = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // g, g, h, w), dim=2)]}
