"""Optimizer op rules: every rule of ``paddle_tpu/ops/optimizer_ops.py``.

``sgd``, ``momentum``, ``adam`` and ``adagrad`` take dense and sparse
gradients; ``decayed_adagrad``, ``adamax``, ``adadelta``, ``rmsprop``
(centered too), ``ftrl``, ``lars_momentum``, ``proximal_gd`` and
``proximal_adagrad`` take dense ones and refuse a ``SelectedRows``
(:func:`_dense_only`), as the reference does; ``average_accumulates``
keeps ``ModelAverage``'s sliding-window sums.
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


def _dense_only(g, op):
    if isinstance(g, SelectedRows):
        raise NotImplementedError(
            f"optimizer op {op!r} has no sparse (SelectedRows) update path; "
            "use sgd/momentum/adam/adagrad for is_sparse embeddings")
    return g


@register("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, mom = ins["Param"][0], ins["Moment"][0]
    g = _dense_only(ins["Grad"][0], "decayed_adagrad")
    decay = _scalar(ctx, attrs.get("decay", 0.95), mom)
    eps = _scalar(ctx, attrs.get("epsilon", 1e-6), mom)
    gf = g.to(mom.dtype)
    mom_new = decay * mom + (1 - decay) * gf * gf
    p_new = p - (_lr(ins, mom.dtype) * gf
                 / (torch.sqrt(mom_new) + eps)).to(p.dtype)
    return {"ParamOut": [p_new], "MomentOut": [mom_new]}


@register("adamax")
def _adamax(ctx, ins, attrs):
    p = ins["Param"][0]
    g = _dense_only(ins["Grad"][0], "adamax")
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    beta1 = _scalar(ctx, attrs.get("beta1", 0.9), m)
    beta2 = _scalar(ctx, attrs.get("beta2", 0.999), m)
    eps = _scalar(ctx, attrs.get("epsilon", 1e-8), m)
    gf = g.to(m.dtype)
    m_new = beta1 * m + (1 - beta1) * gf
    inf_new = torch.maximum(beta2 * inf, torch.abs(gf))
    lr = _lr(ins, m.dtype) / (1 - b1p.reshape(()))
    p_new = p - (lr * m_new / (inf_new + eps)).to(p.dtype)
    return {"ParamOut": [p_new], "MomentOut": [m_new],
            "InfNormOut": [inf_new], "Beta1PowOut": [b1p * beta1]}


@register("adadelta")
def _adadelta(ctx, ins, attrs):
    p = ins["Param"][0]
    g = _dense_only(ins["Grad"][0], "adadelta")
    avg_sq_g, avg_sq_u = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = _scalar(ctx, attrs.get("rho", 0.95), avg_sq_g)
    eps = _scalar(ctx, attrs.get("epsilon", 1e-6), avg_sq_g)
    gf = g.to(avg_sq_g.dtype)
    asg_new = rho * avg_sq_g + (1 - rho) * gf * gf
    update = -torch.sqrt((avg_sq_u + eps) / (asg_new + eps)) * gf
    asu_new = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": [(p.to(gf.dtype) + update).to(p.dtype)],
            "AvgSquaredGradOut": [asg_new], "AvgSquaredUpdateOut": [asu_new]}


@register("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p = ins["Param"][0]
    g = _dense_only(ins["Grad"][0], "rmsprop")
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = _scalar(ctx, attrs.get("decay", 0.95), ms)
    eps = _scalar(ctx, attrs.get("epsilon", 1e-6), ms)
    momentum = _scalar(ctx, attrs.get("momentum", 0.0), ms)
    gf = g.to(ms.dtype)
    ms_new = rho * ms + (1 - rho) * gf * gf
    out = {"MeanSquareOut": [ms_new]}
    if attrs.get("centered", False):
        mg = ins["MeanGrad"][0]
        mg_new = rho * mg + (1 - rho) * gf
        denom = ms_new - mg_new * mg_new + eps
        out["MeanGradOut"] = [mg_new]
    else:
        denom = ms_new + eps
    mom_new = momentum * mom + _lr(ins, ms.dtype) * gf * torch.rsqrt(denom)
    out.update(ParamOut=[(p.to(gf.dtype) - mom_new).to(p.dtype)],
               MomentOut=[mom_new])
    return out


@register("ftrl")
def _ftrl(ctx, ins, attrs):
    p = ins["Param"][0]
    g = _dense_only(ins["Grad"][0], "ftrl")
    sq_acc, lin_acc = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = _scalar(ctx, attrs.get("l1", 0.0), sq_acc)
    l2 = _scalar(ctx, attrs.get("l2", 0.0), sq_acc)
    lr_power = _scalar(ctx, attrs.get("lr_power", -0.5), sq_acc)
    lr = _lr(ins, sq_acc.dtype)
    gf = g.to(sq_acc.dtype)
    new_sq = sq_acc + gf * gf
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq_acc, -lr_power)) / lr
    lin_new = lin_acc + gf - sigma * p.to(sq_acc.dtype)
    x = torch.minimum(torch.maximum(lin_new, -l1), l1) - lin_new
    y = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    return {"ParamOut": [(x / y).to(p.dtype)], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_new]}


@register("lars_momentum")
def _lars_momentum(ctx, ins, attrs):
    p, v = ins["Param"][0], ins["Velocity"][0]
    g = _dense_only(ins["Grad"][0], "lars_momentum")
    mu = _scalar(ctx, attrs.get("mu", 0.9), v)
    lars_coeff = attrs.get("lars_coeff", 1e-3)
    lars_wd = attrs.get("lars_weight_decay", 5e-4)
    lr = _lr(ins, v.dtype)
    gf = g.to(v.dtype)
    pf = p.to(v.dtype)
    p_norm = torch.sqrt(torch.sum(pf * pf))
    g_norm = torch.sqrt(torch.sum(gf * gf))
    local_lr = lr * lars_coeff * p_norm / (g_norm + lars_wd * p_norm + 1e-12)
    v_new = mu * v + local_lr * (gf + lars_wd * pf)
    return {"ParamOut": [(pf - v_new).to(p.dtype)], "VelocityOut": [v_new]}


@register("average_accumulates",
          no_grad_slots=("param", "in_sum_1", "in_sum_2", "in_sum_3",
                         "in_num_accumulates", "in_old_num_accumulates",
                         "in_num_updates"))
def _average_accumulates(ctx, ins, attrs):
    """average_accumulates_op.h: sliding-window parameter sums for
    ModelAverage.  sum_1 accumulates every step; every 16384 updates it
    rolls into sum_2 (precision); when the window closes (num_accumulates
    >= min(max_window, num_updates*window_rate)) everything rolls into
    sum_3 and the window restarts.  All on the device: the window's
    decisions are tensors, not host branches."""
    k_max = 16384
    param = ins["param"][0]
    s1, s2, s3 = ins["in_sum_1"][0], ins["in_sum_2"][0], ins["in_sum_3"][0]
    num_acc = ins["in_num_accumulates"][0].reshape(()).to(torch.int64)
    old_acc = ins["in_old_num_accumulates"][0].reshape(()).to(torch.int64)
    num_upd = ins["in_num_updates"][0].reshape(()).to(torch.int64)
    window = float(attrs.get("average_window", 0.0))
    max_w = int(attrs.get("max_average_window", 2 ** 62))
    min_w = int(attrs.get("min_average_window", 10000))
    zero = torch.zeros((), dtype=s1.dtype, device=s1.device)

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + param.to(s1.dtype)

    roll_precision = (num_upd % k_max) == 0
    s2 = torch.where(roll_precision, s2 + s1, s2)
    s1 = torch.where(roll_precision, zero, s1)

    close = (num_acc >= min_w) & (num_acc >= torch.clamp(
        (num_upd.to(torch.float32) * window).to(torch.int64), max=max_w))
    s3 = torch.where(close, s1 + s2 + s3 * 0, s3)
    s1 = torch.where(close, zero, s1)
    s2 = torch.where(close, zero, s2)
    old_acc = torch.where(close, num_acc, old_acc)
    num_acc = torch.where(close, torch.zeros_like(num_acc), num_acc)

    return {"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
            "out_num_accumulates": [num_acc.reshape(1)],
            "out_old_num_accumulates": [old_acc.reshape(1)],
            "out_num_updates": [num_upd.reshape(1)]}


def _prox(prox_param, lr, l1, l2):
    """Proximal step (proximal_gd_op.cc): soft-threshold by lr*l1 then
    shrink by 1/(1+lr*l2)."""
    return (torch.sign(prox_param)
            * torch.clamp(torch.abs(prox_param) - lr * l1, min=0.0)
            / (1.0 + lr * l2))


@register("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    p = ins["Param"][0]
    g = _dense_only(ins["Grad"][0], "proximal_gd")
    lr = _lr(ins, torch.float32)
    prox = p.to(torch.float32) - lr * g.to(torch.float32)
    return {"ParamOut": [_prox(prox, lr, attrs.get("l1", 0.0),
                               attrs.get("l2", 0.0)).to(p.dtype)]}


@register("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    p, mom = ins["Param"][0], ins["Moment"][0]
    g = _dense_only(ins["Grad"][0], "proximal_adagrad")
    lr = _lr(ins, torch.float32)
    gf = g.to(mom.dtype)
    mom_out = mom + gf * gf
    eff_lr = lr / torch.sqrt(mom_out + 1e-12)
    prox = p.to(torch.float32) - eff_lr * gf
    return {"ParamOut": [_prox(prox, eff_lr, attrs.get("l1", 0.0),
                               attrs.get("l2", 0.0)).to(p.dtype)],
            "MomentOut": [mom_out]}
