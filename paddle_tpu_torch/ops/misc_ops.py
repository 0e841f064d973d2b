"""Miscellaneous op rules: the part of ``paddle_tpu/ops/misc_ops.py``
that the book models use (``cos_sim``, the recommender's tower
similarity)."""
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
