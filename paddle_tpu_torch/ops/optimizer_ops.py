"""Optimizer op rules: ``sgd``, ``momentum``, ``adam`` and ``adagrad``,
dense and sparse.

The port of those rules of ``paddle_tpu/ops/optimizer_ops.py``.
ParamOut names the same variable as Param (and so for the moments);
the executor writes the new values back into the scope's tensors.
Hyper-parameters become 0-d tensors of the accumulator's dtype before
any arithmetic, as the reference's ``jnp.asarray(v, dt)``, so
``1 - beta1`` rounds the same way.

A ``SelectedRows`` gradient (``lookup_table(is_sparse=True)``) gets the
reference's lazy update: only the looked-up rows change.  ``sgd`` adds
the rows (duplicates accumulate, which is exact for SGD).  The
accumulator rules take the first of three paths, in the reference's
order:

1. fused, with ``FLAGS_sparse_fused_kernel`` on: one K10 launch per
   table (``kernels/sparse.py``), which updates the tables IN PLACE;
2. masked-dense, for tables of at most
   ``FLAGS_sparse_dense_update_max_elems`` elements: one scatter builds
   the dense gradient and the touched mask, and the whole table takes
   the step where the mask is set;
3. sorted: ``merge_rows``, then the step on the gathered unique rows,
   scattered back.
"""
from __future__ import annotations

import torch

from ..core.registry import register
from ..core.selected_rows import (
    SelectedRows, canonical_rows, dense_grad_and_mask, gather_rows,
    merge_rows, prefer_dense_update, scatter_set_rows)
from ..kernels import sparse as sparse_kernels


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


def _is_sparse(g) -> bool:
    return isinstance(g, SelectedRows)


@register("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins, p.dtype)
    if _is_sparse(g):
        # sgd_op.h:47-52: add into the looked-up rows only; rows out of
        # range are dropped
        idx, valid = canonical_rows(g.rows, p.shape[0])
        upd = -lr * g.values.to(p.dtype)
        mask = valid.reshape((-1,) + (1,) * (upd.dim() - 1))
        upd = torch.where(mask, upd, torch.zeros_like(upd))
        return {"ParamOut": [p.index_add(0, idx, upd)]}
    return {"ParamOut": [p - lr * g.to(p.dtype)]}


@register("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = _scalar(ctx, attrs.get("mu", 0.9), v)
    nesterov = attrs.get("use_nesterov", False)
    lr = _lr(ins, v.dtype)
    if _is_sparse(g):
        if sparse_kernels.enabled_for(ctx):
            fused = sparse_kernels.fused_momentum(
                p, v, g, lr, attrs.get("mu", 0.9), nesterov, ctx.run_memo)
            if fused is not None:
                p_new, v_new = fused
                return {"ParamOut": [p_new], "VelocityOut": [v_new]}
        if prefer_dense_update(g):
            gd, t = dense_grad_and_mask(g, v.dtype)
            v_new = torch.where(t, mu * v + gd, v)
            pf = p.to(v.dtype)
            if nesterov:
                p_new = torch.where(t, pf - (gd + mu * v_new) * lr, pf)
            else:
                p_new = torch.where(t, pf - lr * v_new, pf)
            return {"ParamOut": [p_new.to(p.dtype)], "VelocityOut": [v_new]}
        m = merge_rows(g)
        rows, gf = m.rows, m.values.to(v.dtype)
        vr = gather_rows(v, rows)
        pr = gather_rows(p, rows).to(v.dtype)
        v_new_r = mu * vr + gf
        if nesterov:
            p_new_r = pr - (gf + mu * v_new_r) * lr
        else:
            p_new_r = pr - lr * v_new_r
        return {"ParamOut": [scatter_set_rows(p, rows, p_new_r)],
                "VelocityOut": [scatter_set_rows(v, rows, v_new_r)]}
    g = g.to(v.dtype)
    v_new = mu * v + g
    if nesterov:
        p_new = p - (g + mu * v_new).to(p.dtype) * lr.to(p.dtype)
    else:
        p_new = p - (lr * v_new).to(p.dtype)
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register("adam")
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = _scalar(ctx, attrs.get("beta1", 0.9), m1)
    beta2 = _scalar(ctx, attrs.get("beta2", 0.999), m2)
    eps = _scalar(ctx, attrs.get("epsilon", 1e-8), m1)
    lr = (_lr(ins, m1.dtype) * torch.sqrt(1 - b2p.reshape(()))
          / (1 - b1p.reshape(())))
    pows = {"Beta1PowOut": [b1p * beta1], "Beta2PowOut": [b2p * beta2]}
    if _is_sparse(g):
        # lazy adam (adam_op.h SelectedRows path): moments and param of
        # the touched rows only
        if sparse_kernels.enabled_for(ctx):
            fused = sparse_kernels.fused_adam(
                p, m1, m2, g, lr, attrs.get("beta1", 0.9),
                attrs.get("beta2", 0.999), attrs.get("epsilon", 1e-8),
                ctx.run_memo)
            if fused is not None:
                p_new, m1n, m2n = fused
                return {"ParamOut": [p_new], "Moment1Out": [m1n],
                        "Moment2Out": [m2n], **pows}
        if prefer_dense_update(g):
            gd, t = dense_grad_and_mask(g, m1.dtype)
            m1n = torch.where(t, beta1 * m1 + (1 - beta1) * gd, m1)
            m2n = torch.where(t, beta2 * m2 + (1 - beta2) * gd * gd, m2)
            step = lr * m1n / (torch.sqrt(m2n) + eps)
            pf = p.to(m1.dtype)
            return {"ParamOut": [torch.where(t, pf - step, pf).to(p.dtype)],
                    "Moment1Out": [m1n], "Moment2Out": [m2n], **pows}
        m = merge_rows(g)
        rows, gf = m.rows, m.values.to(m1.dtype)
        m1r, m2r = gather_rows(m1, rows), gather_rows(m2, rows)
        pr = gather_rows(p, rows).to(m1.dtype)
        m1n = beta1 * m1r + (1 - beta1) * gf
        m2n = beta2 * m2r + (1 - beta2) * gf * gf
        step = lr * m1n / (torch.sqrt(m2n) + eps)
        return {"ParamOut": [scatter_set_rows(p, rows, pr - step)],
                "Moment1Out": [scatter_set_rows(m1, rows, m1n)],
                "Moment2Out": [scatter_set_rows(m2, rows, m2n)], **pows}
    gf = g.to(m1.dtype)
    m1n = beta1 * m1 + (1 - beta1) * gf
    m2n = beta2 * m2 + (1 - beta2) * gf * gf
    step = lr * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": [(p.to(m1.dtype) - step).to(p.dtype)],
            "Moment1Out": [m1n], "Moment2Out": [m2n], **pows}


@register("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = _scalar(ctx, attrs.get("epsilon", 1e-6), mom)
    lr = _lr(ins, mom.dtype)
    if _is_sparse(g):
        if sparse_kernels.enabled_for(ctx):
            fused = sparse_kernels.fused_adagrad(
                p, mom, g, lr, attrs.get("epsilon", 1e-6), ctx.run_memo)
            if fused is not None:
                p_new, mom_new = fused
                return {"ParamOut": [p_new], "MomentOut": [mom_new]}
        if prefer_dense_update(g):
            gd, t = dense_grad_and_mask(g, mom.dtype)
            mom_new = torch.where(t, mom + gd * gd, mom)
            pf = p.to(mom.dtype)
            step = lr * gd / (torch.sqrt(mom_new) + eps)
            return {"ParamOut": [torch.where(t, pf - step, pf).to(p.dtype)],
                    "MomentOut": [mom_new]}
        m = merge_rows(g)
        rows, gf = m.rows, m.values.to(mom.dtype)
        momr = gather_rows(mom, rows)
        pr = gather_rows(p, rows).to(mom.dtype)
        mom_new_r = momr + gf * gf
        p_new_r = pr - lr * gf / (torch.sqrt(mom_new_r) + eps)
        return {"ParamOut": [scatter_set_rows(p, rows, p_new_r)],
                "MomentOut": [scatter_set_rows(mom, rows, mom_new_r)]}
    gf = g.to(mom.dtype)
    mom_new = mom + gf * gf
    p_new = p - (lr * gf / (torch.sqrt(mom_new) + eps)).to(p.dtype)
    return {"ParamOut": [p_new], "MomentOut": [mom_new]}
