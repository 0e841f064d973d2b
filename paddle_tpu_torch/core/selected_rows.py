"""SelectedRows: row-slice gradients of ``lookup_table(is_sparse=True)``.

The port of ``paddle_tpu/core/selected_rows.py``.  A ``SelectedRows`` is
a {row-index vector, value rows} pair: ``rows`` is the flattened id
tensor of the lookup (length N, duplicates allowed) and ``values`` the
matching cotangent rows [N, ...].  The dense [height, ...] gradient is
never built on the update paths: the optimizers write the touched rows
of the table.  It is a plain class here (no pytree): it travels through
the interpreter's environment as one value.

Row ids follow the reference's indexing convention everywhere: an id in
[-height, 0) wraps to ``id + height``; an id outside [-height, height)
(the sentinel ``height`` among them) is dropped by the scatters and
reads as zero in :func:`gather_rows`.  Every helper keeps that on the
device with a clamped index and ``torch.where`` (no host sync, no
device assert).

``merge_rows`` keeps the reference's static length N: slot i holds the
i-th smallest unique row's sum, unused slots carry the sentinel row id
``height`` and zero values.
"""
from __future__ import annotations

import torch


class SelectedRows:
    """Sparse row-slice tensor: ``values[i]`` is a (sub)gradient for row
    ``rows[i]`` of a dense [height, ...] tensor.  Rows may repeat."""

    def __init__(self, rows, values, height: int, merged: bool = False):
        self.rows = rows
        self.values = values
        self.height = int(height)
        self.merged = bool(merged)  # rows already unique (merge_rows output)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def to(self, device) -> "SelectedRows":
        return SelectedRows(self.rows.to(device), self.values.to(device),
                            self.height, self.merged)

    def to_dense(self):
        """The dense gradient (duplicates accumulate, dropped ids add
        nothing)."""
        flat = self.values.reshape(self.values.shape[0], -1)
        dense = _scatter_add(self.rows, flat, self.height)
        return dense.reshape(self.shape)

    def __repr__(self):
        return (f"SelectedRows(n={self.rows.shape[0]}, height={self.height}, "
                f"row_shape={tuple(self.values.shape[1:])}, "
                f"dtype={self.dtype})")


def canonical_rows(rows, height: int):
    """(wrapped rows clamped into [0, height), in-range mask): ids in
    [-height, 0) wrap; the mask is False for ids outside
    [-height, height)."""
    wrapped = torch.where(rows < 0, rows + height, rows)
    valid = (rows >= -height) & (rows < height)
    return wrapped.clamp(0, height - 1), valid


def take_rows(table, ids):
    """``table[ids]`` with ``jnp.take``'s out-of-range rule: ids in
    [-H, 0) wrap; other out-of-range ids give a NaN row on a float table
    and the clamped edge row on an integer one.  Shape ``ids.shape +
    table.shape[1:]``."""
    flat = ids.reshape(-1)
    idx, valid = canonical_rows(flat, table.shape[0])
    out = table[idx]
    if table.is_floating_point():
        mask = valid.reshape((-1,) + (1,) * (table.dim() - 1))
        out = torch.where(mask, out, torch.full((), float("nan"),
                                                dtype=table.dtype,
                                                device=table.device))
    return out.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def _scatter_add(rows, flat, height: int):
    """zeros([height, C]) with ``flat`` [N, C] added at ``rows``;
    out-of-range rows add nothing.  The duplicates of a row are summed in
    their order in ``rows``, as ``merge_rows`` and K10 sum them, and the
    same in every run: on the CPU ``index_add_`` runs serially; on the
    card ``index_add_`` would add with atomics in no fixed order, so
    there it is ``index_put_(accumulate=True)``, which sorts the indices
    stably and sums each run in order."""
    idx, valid = canonical_rows(rows, height)
    src = torch.where(valid[:, None], flat, torch.zeros((), dtype=flat.dtype,
                                                        device=flat.device))
    out = torch.zeros((height, flat.shape[1]), dtype=flat.dtype,
                      device=flat.device)
    if out.device.type == "cpu":
        return out.index_add_(0, idx, src)
    return out.index_put_((idx,), src, accumulate=True)


def segment_starts(r):
    """For sorted ``r`` [N]: (first [N] bool, seg [N] unique-group id,
    pos [N] position within its run of equal ids)."""
    n = r.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=r.device)
    first[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    ar = torch.arange(n, device=r.device)
    start = torch.cummax(torch.where(first, ar, torch.zeros_like(ar)), 0)[0]
    return first, seg, ar - start


def segment_sum_in_order(v, seg, pos, out):
    """``out[seg[i]] += v[i]`` with each group summed left to right
    (``jax.ops.segment_sum``'s order): one pass per position within a
    run, each pass touching every group at most once, so no sum depends
    on the order of a scatter's atomics."""
    longest = int(pos.max()) + 1 if pos.numel() else 0
    for k in range(longest):
        sel = pos == k
        out.index_add_(0, seg[sel], v[sel])
    return out


def _merge_plan(rows, height: int):
    """The sort and segmentation of a row vector that
    :func:`merge_rows` sums its values by: (order, seg, pos, merged
    rows)."""
    n = rows.shape[0]
    r, order = torch.sort(rows, stable=True)
    first, seg, pos = segment_starts(r)
    out_rows = torch.full((n,), height, dtype=r.dtype, device=r.device)
    out_rows[seg] = r    # every member of a group writes the same id
    return order, seg, pos, out_rows


def run_shared(memo, key, tensors, make):
    """``make()``, made once a run for the same ``tensors``: with
    ``memo`` (a run's ``LowerContext.run_memo``) the result is kept
    under ``key`` and the tensors' memory (pointer, dtype, device, shape,
    strides) while none of them has been written since (their version
    counters, which views share); the tensors are kept alive with it so
    no other tensor takes their memory this run."""
    if memo is None:
        return make()
    full = (key,) + tuple((t.data_ptr(), t.dtype, t.device, tuple(t.shape),
                           tuple(t.stride())) for t in tensors)
    versions = tuple(t._version for t in tensors)
    hit = memo.get(full)
    if hit is not None and hit[1] == versions:
        return hit[2]
    out = make()
    memo[full] = (tuple(tensors), versions, out)
    return out


def merge_rows(sr: SelectedRows, memo=None) -> SelectedRows:
    """Sum duplicate rows (MergeAdd).  The result has the same length N;
    slot i holds the i-th unique row's sum, unused slots carry the
    sentinel row id ``height`` and zeros.  With ``memo`` (a run's
    ``LowerContext.run_memo``) the sort of one row vector is made once a
    run (:func:`run_shared`), and its merges share one merged row
    vector: the tables one id batch looks up merge behind one sort."""
    rows, vals = sr.rows, sr.values
    if rows.shape[0] == 0 or sr.merged:
        return sr
    order, seg, pos, out_rows = run_shared(
        memo, ("merge_rows", sr.height), [rows],
        lambda: _merge_plan(rows, sr.height))
    merged = segment_sum_in_order(vals[order], seg, pos,
                                  torch.zeros_like(vals))
    return SelectedRows(out_rows, merged, sr.height, merged=True)


def dense_grad_and_mask(sr: SelectedRows, dtype=None):
    """One scatter for the masked-dense lazy update: the (possibly
    duplicated) rows added into a dense [height, ...] gradient, with a
    touched-count column riding along in the same scatter; returns
    (dense grad, touched mask [height, 1, ...] bool)."""
    vals = sr.values if dtype is None else sr.values.to(dtype)
    flat = vals.reshape(vals.shape[0], -1)
    ones = torch.ones((flat.shape[0], 1), dtype=flat.dtype,
                      device=flat.device)
    buf = _scatter_add(sr.rows, torch.cat([flat, ones], 1), sr.height)
    gd = buf[:, :-1].reshape((sr.height,) + tuple(vals.shape[1:]))
    touched = (buf[:, -1:] > 0).reshape(
        (sr.height,) + (1,) * (vals.dim() - 1))
    return gd, touched


def prefer_dense_update(sr: SelectedRows) -> bool:
    """Size rule for the masked-dense lazy update: tables of at most
    ``FLAGS_sparse_dense_update_max_elems`` elements take it, larger ones
    the sorted ``merge_rows`` path."""
    from . import flags
    row_elems = 1
    for d in sr.values.shape[1:]:
        row_elems *= int(d)
    return (sr.height * row_elems
            <= flags.get_flags("sparse_dense_update_max_elems"))


def gather_rows(dense, rows):
    """``dense[rows]``; out-of-range (sentinel) rows read as zero."""
    idx, valid = canonical_rows(rows, dense.shape[0])
    out = dense[idx]
    mask = valid.reshape((-1,) + (1,) * (dense.dim() - 1))
    return torch.where(mask, out, torch.zeros((), dtype=dense.dtype,
                                              device=dense.device))


def scatter_set_rows(dense, rows, values):
    """A copy of ``dense`` with ``dense[rows] = values``; out-of-range
    (sentinel) rows are dropped.  They are sent to one spare row past
    the end, which is cut off."""
    h = dense.shape[0]
    idx, valid = canonical_rows(rows, h)
    idx = torch.where(valid, idx, torch.full_like(idx, h))
    buf = torch.cat([dense, dense.new_zeros((1,) + tuple(dense.shape[1:]))])
    buf.index_put_((idx,), values.to(dense.dtype))
    return buf[:h]


__all__ = ["SelectedRows", "canonical_rows", "dense_grad_and_mask",
           "gather_rows", "merge_rows", "prefer_dense_update", "run_shared",
           "scatter_set_rows", "segment_starts", "segment_sum_in_order",
           "take_rows"]
