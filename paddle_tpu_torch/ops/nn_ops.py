"""Neural-net op rules: layer_norm and the losses.

The port of the part of ``paddle_tpu/ops/nn_ops.py`` that the
Transformer's training program and the fc/SGD drive use.  Statistics
are taken in at least float32, as the reference's ``_stat_dtype``.
"""
from __future__ import annotations

import torch

from ..core.registry import register


def _stat_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """layer_norm_op.cc: normalize over dims [begin_norm_axis:], affine
    with flattened Scale/Bias."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    bshape = [1] * bna + list(x.shape[bna:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    lead = tuple(x.shape[:bna])
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


def _squeeze_label(label):
    if label.dim() >= 2 and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


@register("softmax_with_cross_entropy", no_grad_slots=("Label",))
def _softmax_xent(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    lf = logits.to(_stat_dtype(logits))
    log_softmax = lf - torch.logsumexp(lf, dim=-1, keepdim=True)
    if attrs.get("soft_label", False):
        loss = -(label * log_softmax).sum(dim=-1, keepdim=True)
    else:
        li = _squeeze_label(label).long()
        picked = log_softmax.gather(-1, li.unsqueeze(-1))
        if attrs.get("ignore_index", -100) != -100:
            picked = picked * (li.unsqueeze(-1)
                               != attrs["ignore_index"]).to(picked.dtype)
        loss = -picked
    return {"Softmax": [log_softmax.exp().to(logits.dtype)],
            "Loss": [loss.to(logits.dtype)]}


@register("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.square(x - y)]}
