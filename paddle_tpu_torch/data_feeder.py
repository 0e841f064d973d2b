"""DataFeeder: python minibatches → feed dict of dense arrays (a copy of
``paddle_tpu/data_feeder.py``).

Reference: ``python/paddle/fluid/data_feeder.py:83`` — converts lists of
per-example tuples into per-place LoDTensor batches.  Here a variable-length
(``lod_level=1``) feed becomes a padded ``[B, T, ...]`` array plus the
``<name>@LEN`` int32 lengths vector (the padded-sequence contract; see
layers/nn.py).  Padding T to a bucket boundary keeps the number of feed shapes small.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .core.program import Variable, default_main_program
from .core.types import np_dtype

# pad sequence length up to the next multiple (recompile-bucketing policy)
SEQ_LEN_BUCKET = 16


def _bucket(n: int, bucket: int = SEQ_LEN_BUCKET) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.program = program or default_main_program()
        self.feed_vars: List[Variable] = [
            v if isinstance(v, Variable) else self.program.global_block.var(v)
            for v in feed_list
        ]
        self.place = place

    def feed(self, iterable) -> dict:
        """iterable: list of per-example tuples aligned with feed_list."""
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            col = [row[i] for row in rows]
            if var.lod_level >= 2:
                data, outer, inner = self._pad_nested(col, var)
                out[var.name] = data
                out[var.name + "@LEN"] = outer
                out[var.name + "@LEN2"] = inner
            elif var.lod_level == 1:
                data, lens = self._pad(col, var)
                out[var.name] = data
                out[var.name + "@LEN"] = lens
            else:
                arr = np.asarray(col)
                arr = arr.astype(np_dtype(var.dtype), copy=False)
                want = var.shape
                if want is not None and len(want) == arr.ndim + 1 and want[-1] == 1:
                    arr = arr[..., None]  # reference-style trailing label dim
                out[var.name] = arr
        return out

    def _pad_nested(self, col, var: Variable):
        """Level-2 feed: each example is a list of sentences, each
        sentence a list/array of word rows.  Produces the nested padded
        contract ([B,S,W,...] + @LEN outer [B] + @LEN2 inner [B,S]) via
        the same function create_lod_tensor uses, so DataFeeder and the
        LoDTensor feed path stay bit-identical."""
        from .lod_tensor import _create_nested

        if var.lod_level > 2:
            raise NotImplementedError(
                "DataFeeder supports lod_level <= 2 (the nested padded "
                "contract; see lod_tensor.py)")
        outer = [len(ex) for ex in col]
        flat = [np.asarray(s) for ex in col for s in ex]
        inner = [len(s) for s in flat]
        # zero-word sentences are legal (they pool to 0 downstream); give
        # them the word-row feature shape so concatenation lines up.
        # When EVERY sentence in the batch is empty, derive the feature
        # shape from the declared var shape ([B, S, W, ...feat]) instead
        # of degrading to (0,)-shaped features
        feat = next((s.shape[1:] for s in flat if len(s)), None)
        if feat is None:
            shp = var.shape
            feat = (tuple(int(d) for d in shp[3:])
                    if shp is not None and len(shp) > 3 else ())
        flat = [s if len(s) else np.zeros((0,) + feat) for s in flat]
        lt = _create_nested(flat, [outer, inner])
        data = lt.data.astype(np_dtype(var.dtype), copy=False)
        want = var.shape
        if want is not None and len(want) == data.ndim + 1 and want[-1] == 1:
            data = data[..., None]  # reference-style trailing word dim
        return (data, lt.seq_lens.astype(np.int64),
                lt.inner_lens.astype(np.int64))

    def _pad(self, col, var: Variable):
        seqs = [np.asarray(s) for s in col]
        lens = np.asarray([len(s) for s in seqs], dtype=np.int32)
        T = _bucket(int(lens.max()) if len(lens) else 1)
        feat = seqs[0].shape[1:] if seqs[0].ndim > 1 else ()
        want_feat = tuple(var.shape[2:]) if var.shape is not None else feat
        if not feat and want_feat == (1,):
            feat = (1,)
            seqs = [s[:, None] for s in seqs]
        data = np.zeros((len(seqs), T) + feat, dtype=np_dtype(var.dtype))
        for j, s in enumerate(seqs):
            data[j, : len(s)] = s
        return data, lens
