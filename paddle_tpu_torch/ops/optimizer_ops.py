"""Optimizer op rules: dense ``sgd`` and ``adam``.

The port of the dense paths of ``paddle_tpu/ops/optimizer_ops.py``.
ParamOut names the same variable as Param (and so for the moments);
the executor writes the new values back into the scope's tensors in
place.  Hyper-parameters become float32 scalars of the accumulator's
dtype before any arithmetic, as the reference's ``jnp.asarray(v, dt)``,
so ``1 - beta1`` rounds the same way.  A SelectedRows (sparse)
gradient is not ported yet.
"""
from __future__ import annotations

import torch

from ..core.registry import register


def _lr(ins, dtype):
    return ins["LearningRate"][0].reshape(()).to(dtype)


def _scalar(ctx, v, like):
    """A 0-d tensor of ``like``'s dtype and device, made once per
    executor (``ctx.consts``)."""
    key = ("scalar", float(v), like.dtype, like.device)
    t = ctx.consts.get(key)
    if t is None:
        t = ctx.consts[key] = torch.tensor(v, dtype=like.dtype,
                                           device=like.device)
    return t


@register("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [p - _lr(ins, p.dtype) * g.to(p.dtype)]}


@register("adam")
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = _scalar(ctx, attrs.get("beta1", 0.9), m1)
    beta2 = _scalar(ctx, attrs.get("beta2", 0.999), m2)
    eps = _scalar(ctx, attrs.get("epsilon", 1e-8), m1)
    gf = g.to(m1.dtype)
    m1n = beta1 * m1 + (1 - beta1) * gf
    m2n = beta2 * m2 + (1 - beta2) * gf * gf
    lr = (_lr(ins, m1.dtype) * torch.sqrt(1 - b2p.reshape(()))
          / (1 - b1p.reshape(())))
    step = lr * m1n / (torch.sqrt(m2n) + eps)
    return {
        "ParamOut": [(p.to(m1.dtype) - step).to(p.dtype)],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        "Beta1PowOut": [b1p * beta1],
        "Beta2PowOut": [b2p * beta2],
    }
