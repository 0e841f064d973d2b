"""CTC and linear-chain CRF: the structured sequence losses.

The port of ``paddle_tpu/ops/ctc_crf_ops.py`` (``warpctc``,
``ctc_align``, ``linear_chain_crf``, ``crf_decoding``).  Each dynamic
program over time, a ``lax.scan`` in the reference, is a Python loop
over T in torch ops; a row whose length has ended keeps its state
through ``torch.where``.  The gradients come from autograd through that
loop, as the reference's come from ``jax.vjp`` through its scan: no
grad rule re-runs a forward.  Log-space sentinels are ``NEG = -1e30``,
not -inf, so ``logaddexp``/``logsumexp`` never meet all -inf and give
NaN gradients.  Batched over padded sequences with per-row lengths;
no rule reads a length back to the host.
"""
from __future__ import annotations

import torch

from ..core.registry import register
from .sequence_ops import left_compact

NEG = -1e30


def _lengths(ins, slot, B, T, device):
    """Per-row lengths [B] as int64 from ``slot``, or T for every row."""
    if ins.get(slot):
        return ins[slot][0].reshape(-1).long()
    return torch.full((B,), T, dtype=torch.int64, device=device)


def _shift_right(a, k, fill):
    """a[:, s - k] for s >= k, ``fill`` before (the reference's
    ``jnp.pad(a[:, :-k], ((0, 0), (k, 0)))``)."""
    head = torch.full((a.shape[0], k), fill, dtype=a.dtype, device=a.device)
    return torch.cat([head, a[:, :-k]], dim=1)


@register("warpctc", no_grad_slots=("Label", "LogitsLength", "LabelLength"))
def _warpctc(ctx, ins, attrs):
    """CTC loss.  Logits [B, T, C] (``LogitsLength`` [B]), Label [B, L]
    (``LabelLength`` [B]), attr ``blank``; the per-sequence negative
    log-likelihood [B, 1], divided by the logit length with
    ``norm_by_times``."""
    logits = ins["Logits"][0]
    label = ins["Label"][0]
    if label.dim() == 3:
        label = label[..., 0]
    B, T, C = logits.shape
    L = label.shape[1]
    dev = logits.device
    blank = int(attrs.get("blank", 0))
    logit_len = _lengths(ins, "LogitsLength", B, T, dev)
    label_len = _lengths(ins, "LabelLength", B, L, dev)

    logp = torch.log_softmax(logits.float(), dim=-1)      # [B, T, C]
    S = 2 * L + 1
    # extended label: blank, l0, blank, l1, ..., blank
    ext = torch.full((B, S), blank, dtype=label.dtype, device=dev)
    ext[:, 1::2] = label
    s_idx = torch.arange(S, device=dev)[None, :]
    is_label = (s_idx % 2) == 1
    # the skip s-2 -> s is allowed into a label that differs from ext[s-2]
    can_skip = is_label & (ext != _shift_right(ext, 2, blank))
    valid_s = s_idx < (2 * label_len[:, None] + 1)
    ext_idx = ext.long()
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)

    def emit(t):
        return torch.gather(logp[:, t], 1, ext_idx)

    e0 = emit(0)
    a0 = torch.cat([e0[:, :1],
                    torch.where(label_len > 0, e0[:, 1], neg)[:, None],
                    neg.expand(B, S - 2)], dim=1)
    alpha = torch.where(valid_s, a0, neg)
    for t in range(1, T):
        sh1 = _shift_right(alpha, 1, NEG)
        sh2 = torch.where(can_skip, _shift_right(alpha, 2, NEG), neg)
        prev = torch.logaddexp(torch.logaddexp(alpha, sh1), sh2)
        new = torch.where(valid_s, prev + emit(t), neg)
        alpha = torch.where((t < logit_len)[:, None], new, alpha)
    # the end: the last blank (2 * label_len) or the last label before it
    last = torch.gather(alpha, 1, 2 * label_len[:, None])[:, 0]
    seclast = torch.gather(
        alpha, 1, torch.clamp(2 * label_len[:, None] - 1, min=0))[:, 0]
    seclast = torch.where(label_len > 0, seclast, neg)
    loss = -torch.logaddexp(last, seclast)
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(logit_len.float(), min=1)
    return {"Loss": [loss[:, None].to(logits.dtype)]}


@register("ctc_align", no_grad_slots=("Input", "InputLength"))
def _ctc_align(ctx, ins, attrs):
    """Greedy CTC decode cleanup: merge repeats, drop blanks and
    left-compact.  Input [B, T] argmax ids; the compacted ids (``blank``
    past the end) and their lengths."""
    x = ins["Input"][0]
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    ids = x[..., 0] if squeeze else x
    B, T = ids.shape
    blank = int(attrs.get("blank", 0))
    lens = _lengths(ins, "InputLength", B, T, ids.device)
    t = torch.arange(T, device=ids.device)[None, :]
    keep = (t < lens[:, None]) & (ids != blank) & (
        ids != _shift_right(ids, 1, blank))
    compacted, new_len = left_compact(ids, keep)
    out = torch.where(t < new_len[:, None], compacted,
                      torch.tensor(blank, dtype=ids.dtype, device=ids.device))
    if squeeze:
        out = out[..., None]
    return {"Output": [out], "OutputLength": [new_len]}


# ---------------------------------------------------------------------------
# linear-chain CRF
# ---------------------------------------------------------------------------
# Transition layout (linear_chain_crf_op.cc): [C+2, C]; row 0 start ->
# tag, row 1 tag -> stop, rows 2 + c from tag c to each tag.

def _crf_parts(transition):
    t = transition.float()
    return t[0], t[1], t[2:]


@register("linear_chain_crf", no_grad_slots=("Label", "Length"))
def _linear_chain_crf(ctx, ins, attrs):
    """Each sequence's log-likelihood of its gold path: the gold score
    less the log partition, both masked by the row's length.  Emission
    [B, T, C], Label [B, T], Transition [C+2, C]; out [B, 1]."""
    emission = ins["Emission"][0].float()
    label = ins["Label"][0]
    if label.dim() == 3:
        label = label[..., 0]
    B, T, C = emission.shape
    lens = _lengths(ins, "Length", B, T, emission.device)
    start, stop, trans = _crf_parts(ins["Transition"][0])
    lab = label.long()

    # the gold path's score
    e_scores = torch.gather(emission, 2, lab[..., None])[..., 0]
    t_idx = torch.arange(T, device=emission.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=emission.device)
    gold = torch.where(t_idx < lens[:, None], e_scores, zero).sum(dim=1)
    pair = trans[lab[:, :-1], lab[:, 1:]]
    gold = gold + torch.where(t_idx[:, 1:] < lens[:, None], pair,
                              zero).sum(dim=1)
    gold = gold + start[lab[:, 0]]
    last = torch.gather(lab, 1, torch.clamp(lens - 1, min=0)[:, None])[:, 0]
    gold = gold + stop[last]

    # the log partition by the forward recursion
    alpha = start[None, :] + emission[:, 0]
    for t in range(1, T):
        scores = (alpha[:, :, None] + trans[None, :, :]
                  + emission[:, t][:, None, :])
        new = torch.logsumexp(scores, dim=1)
        alpha = torch.where((t < lens)[:, None], new, alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=1)
    return {"LogLikelihood": [(gold - logz)[:, None]]}


@register("crf_decoding", no_grad_slots=("Emission", "Transition", "Label",
                                         "Length"))
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode: max-product forward with argmax back-pointers (the
    first index of a maximum, as ``jnp.argmax``), then the backtrack; a
    frozen step carries identity pointers and the padded tail emits 0."""
    emission = ins["Emission"][0].float()
    B, T, C = emission.shape
    dev = emission.device
    lens = _lengths(ins, "Length", B, T, dev)
    start, stop, trans = _crf_parts(ins["Transition"][0])
    ident = torch.arange(C, device=dev)[None, :].expand(B, C)

    alpha = start[None, :] + emission[:, 0]
    ptrs = []                                   # ptrs[t - 1]: step t's
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None, :, :]   # [B, from, to]
        best = torch.amax(scores, dim=1) + emission[:, t]
        ptr = torch.argmax(scores, dim=1)
        active = (t < lens)[:, None]
        alpha = torch.where(active, best, alpha)
        ptrs.append(torch.where(active, ptr, ident))
    path = [None] * T
    path[T - 1] = torch.argmax(alpha + stop[None, :], dim=1)
    for t in range(T - 1, 0, -1):
        path[t - 1] = torch.gather(ptrs[t - 1], 1, path[t][:, None])[:, 0]
    path = torch.stack(path, dim=1)
    t_idx = torch.arange(T, device=dev)[None, :]
    out = torch.where(t_idx < lens[:, None], path, torch.zeros_like(path))
    return {"ViterbiPath": [out.to(torch.int64)]}
