"""TensorArray and beam-search op rules: the dynamic-decode toolkit.

The port of ``paddle_tpu/ops/array_ops.py`` (``array_write``,
``array_read``, ``beam_search``, ``beam_search_decode``; the LoD
rank-table ops of the same file are not ported yet).

A TensorArray is a preallocated ``[max_len, ...]`` tensor plus an int64
``@ALEN`` length, as in the reference.  ``array_write`` writes out of
place: the ``While`` layer snapshots every loop carry into an ``@INIT``
var before the loop, and a write into the carry's own storage would
change that snapshot under it.  Indices stay tensors on the device
(``index_select``/``index_copy``), so no rule reads a value back to the
host.

Beam search works on the padded ``[batch*beam, ...]`` layout, with
finished beams kept by an extra stay-finished candidate slot.  Its
ranking is a stable descending sort, which puts the lower index first
among equal scores exactly as the reference's ``lax.top_k`` does
(``torch.topk`` promises no order, and its order differs between the
CPU and the card); ties are common here (every stay-finished slot of a
live beam, and a whole ``-inf`` seed row, score ``-inf``).
"""
from __future__ import annotations

import torch

from ..core.registry import register


def _index(i) -> torch.Tensor:
    """A step index ``[1]``/``[]`` as a one-element int64 index."""
    return i.reshape(1).long()


@register("array_write", no_grad_slots=("I", "ArrayLen"))
def _array_write(ctx, ins, attrs):
    """array[i] = x; length = max(length, i+1)
    (tensor_array_read_write_op.cc WriteToArray)."""
    arr, x = ins["Array"][0], ins["X"][0]
    i = _index(ins["I"][0])
    length = ins["ArrayLen"][0]
    out = arr.index_copy(0, i, x.to(arr.dtype).unsqueeze(0))
    new_len = torch.maximum(length.reshape(1), (i + 1).to(length.dtype))
    return {"Out": [out], "LenOut": [new_len.reshape(length.shape)]}


@register("array_read", no_grad_slots=("I",))
def _array_read(ctx, ins, attrs):
    """out = array[i] (ReadFromArray)."""
    arr = ins["Array"][0]
    return {"Out": [arr.index_select(0, _index(ins["I"][0]))[0]]}


@register("beam_search",
          no_grad_slots=("PreIds", "PreScores", "Ids", "Scores"))
def _beam_search(ctx, ins, attrs):
    """One beam-search step (beam_search_op.cc, LoD-free layout).

    Inputs (BW = batch * beam_size): PreIds [BW, 1] int64, PreScores
    [BW, 1], Ids [BW, K] int64 candidates, Scores [BW, K] their
    accumulated scores.  A finished beam (PreIds == end_id) contributes
    one stay-finished candidate (end_id at its frozen score) instead of
    its K expansions.  Outputs: SelectedIds [BW, 1], SelectedScores
    [BW, 1], ParentIdx [BW] int64 (the global source-beam index)."""
    beam = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    pre_ids = ins["PreIds"][0].reshape(-1)
    pre_scores = ins["PreScores"][0].reshape(-1)
    ids = ins["Ids"][0]
    scores = ins["Scores"][0]
    bw, k = scores.shape
    assert bw % beam == 0, f"batch*beam {bw} not divisible by beam {beam}"
    b = bw // beam
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype,
                         device=scores.device)

    finished = pre_ids == end_id
    live_scores = torch.where(finished[:, None], neg_inf, scores)
    stay = torch.where(finished, pre_scores.to(scores.dtype), neg_inf)
    cand_scores = torch.cat([live_scores, stay[:, None]], dim=1)   # [BW,K+1]
    cand_ids = torch.cat([ids, torch.full((bw, 1), end_id, dtype=ids.dtype,
                                          device=ids.device)], dim=1)

    grouped = cand_scores.reshape(b, beam * (k + 1))
    vals, order = torch.sort(grouped, dim=1, descending=True, stable=True)
    top_scores, top_idx = vals[:, :beam], order[:, :beam]          # [B,beam]
    parent = (top_idx // (k + 1)
              + (torch.arange(b, device=top_idx.device) * beam)[:, None])
    sel_ids = torch.take_along_dim(cand_ids.reshape(b, -1), top_idx, dim=1)
    return {
        "SelectedIds": [sel_ids.reshape(bw, 1).long()],
        "SelectedScores": [top_scores.reshape(bw, 1)],
        "ParentIdx": [parent.reshape(bw).long()],
    }


@register("beam_search_decode",
          no_grad_slots=("Ids", "Parents", "Scores", "ArrayLen"))
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack stacked per-step selections into the reference's
    level-2 result, padded (beam_search_decode_op.cc).

    Ids, Parents: [T_max, BW] (TensorArray data); optional Scores
    [T_max, BW]; ArrayLen: written steps.  Walks parent pointers from
    the last step back to step 0; steps at or past ArrayLen give end_id
    (score 0) and keep the pointer.  Outputs: SentenceIds [BW, T_max]
    int64, SentenceScores [BW, T_max] (only with Scores), SentenceLen
    [BW] int64 (up to and including the first end_id, T_max when none,
    capped at ArrayLen) and SourceLen [B] int64 (beam_size each)."""
    ids = ins["Ids"][0]
    parents = ins["Parents"][0].long()
    t_max, bw = ids.shape
    end_id = int(attrs["end_id"])
    beam_size = int(attrs.get("beam_size", 1))
    dev = ids.device
    length = (ins["ArrayLen"][0].reshape(()).long() if ins.get("ArrayLen")
              else torch.tensor(t_max, device=dev))
    scores = ins["Scores"][0] if ins.get("Scores") else None
    sc_arr = (scores if scores is not None
              else torch.zeros((t_max, bw), dtype=torch.float32, device=dev))
    end = torch.full((), end_id, dtype=ids.dtype, device=dev)
    zero = torch.zeros((), dtype=sc_arr.dtype, device=dev)

    cur = torch.arange(bw, device=dev)
    toks, scs = [None] * t_max, [None] * t_max
    for t in range(t_max - 1, -1, -1):
        active = length > t
        toks[t] = torch.where(active, ids[t][cur], end)
        scs[t] = torch.where(active, sc_arr[t][cur], zero)
        cur = torch.where(active, parents[t][cur], cur)
    sent_ids = torch.stack(toks, dim=1).long()                   # [BW, T]
    sent_scores = torch.stack(scs, dim=1)

    is_end = (sent_ids == end_id).to(torch.int32)
    has_end = is_end.amax(dim=1) > 0
    first_end = torch.argmax(is_end, dim=1)
    cand_len = torch.where(has_end, first_end + 1,
                           torch.full_like(first_end, t_max))
    cand_len = torch.minimum(cand_len, length)
    src_len = torch.full((bw // beam_size,), beam_size, dtype=torch.int64,
                         device=dev)
    out = {"SentenceIds": [sent_ids],
           "SentenceLen": [cand_len.long()],
           "SourceLen": [src_len]}
    if scores is not None:
        out["SentenceScores"] = [sent_scores]
    return out
