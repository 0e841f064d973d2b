"""LoDTensor compatibility shim (reference python/paddle/fluid/
lod_tensor.py:23 create_lod_tensor, core LoDTensor): a copy of
``paddle_tpu/lod_tensor.py`` (numpy only).

The framework stores variable-length batches as padded ``[B, T, ...]``
arrays + a length vector (see layers/nn.py module docstring).  This shim
keeps the reference's feed-side API: a ``LoDTensor`` built from ragged
rows + ``recursive_seq_lens`` feeds straight into ``Executor.run`` —
the executor expands it to the padded array and the ``@LEN`` companion.

Level-2 (nested, reference lod_tensor.h:58 — paragraph -> sentence ->
word): ``recursive_seq_lens = [outer, inner]`` builds a padded
``[B, S, W, ...]`` array + OUTER lengths [B] (``@LEN``) + INNER lengths
[B, S] (``@LEN2``); ``layers.data(lod_level=2)`` declares the same
companions and the nested sequence ops consume them
(ops/sequence_ops.py _nestable).  Deeper nesting is rejected loudly."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["LoDTensor", "create_lod_tensor", "create_random_int_lodtensor"]


class LoDTensor:
    """Padded data + per-sequence lengths (level-1), or padded-nested
    data + outer/inner lengths (level-2)."""

    def __init__(self, data: np.ndarray, seq_lens: Sequence[int],
                 inner_lens=None):
        self._data = np.asarray(data)
        self._lens = np.asarray(seq_lens, np.int64)
        self._inner = (None if inner_lens is None
                       else np.asarray(inner_lens, np.int64))
        if self._data.shape[0] != len(self._lens):
            raise ValueError(
                f"padded batch {self._data.shape[0]} != "
                f"{len(self._lens)} sequences")
        if self._inner is not None and \
                self._inner.shape[:2] != self._data.shape[:2]:
            raise ValueError(
                f"inner lengths {self._inner.shape} do not match padded "
                f"nested batch {self._data.shape[:2]}")

    # reference API ------------------------------------------------------
    def recursive_sequence_lengths(self) -> List[List[int]]:
        if self._inner is None:
            return [list(int(v) for v in self._lens)]
        outer = [int(v) for v in self._lens]
        inner = [int(self._inner[b, s])
                 for b, n in enumerate(outer) for s in range(n)]
        return [outer, inner]

    def lod(self) -> List[List[int]]:
        levels = self.recursive_sequence_lengths()
        out = []
        for lens in levels:
            offsets = [0]
            for v in lens:
                offsets.append(offsets[-1] + int(v))
            out.append(offsets)
        return out

    def shape(self):
        return tuple(self._data.shape)

    # padded-contract accessors ------------------------------------------
    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def seq_lens(self) -> np.ndarray:
        return self._lens

    @property
    def inner_lens(self):
        return self._inner

    def __array__(self, dtype=None):
        return self._data.astype(dtype) if dtype else self._data


def create_lod_tensor(data, recursive_seq_lens, place=None) -> LoDTensor:
    """Build a LoDTensor from (a) a list of per-sequence row lists, (b) a
    packed ``[sum(lens), ...]`` array + lens, or (c) an existing
    LoDTensor (re-lod)."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(_unpad(data), recursive_seq_lens, place)
    if len(recursive_seq_lens) == 2:
        return _create_nested(data, recursive_seq_lens)
    if len(recursive_seq_lens) != 1:
        raise ValueError(
            "create_lod_tensor supports level-1 and level-2 (nested) "
            "sequences; deeper LoD has no in-scope reference workload "
            "(lod_tensor.h:58 examples are all depth <= 2)")
    lens = [int(v) for v in recursive_seq_lens[0]]
    if isinstance(data, list):
        rows = [np.asarray(seq) for seq in data]
        if [len(r) for r in rows] != lens:
            raise ValueError(
                f"sequence lengths {[len(r) for r in rows]} do not match "
                f"recursive_seq_lens {lens}")
        packed = np.concatenate(rows) if rows else np.zeros((0, 1))
    else:
        packed = np.asarray(data)
        if packed.shape[0] != sum(lens):
            raise ValueError(
                f"packed rows {packed.shape[0]} != sum(lens) {sum(lens)}")
    # trailing base dims survive; bucket T like DataFeeder._pad so
    # per-batch max-length jitter gives few distinct feed shapes
    from .data_feeder import _bucket

    B = len(lens)
    T = _bucket(max(lens)) if lens else 0
    padded = np.zeros((B, T) + packed.shape[1:], packed.dtype)
    off = 0
    for i, ln in enumerate(lens):
        padded[i, :ln] = packed[off:off + ln]
        off += ln
    return LoDTensor(padded, lens)


def _create_nested(data, recursive_seq_lens) -> LoDTensor:
    """Level-2: outer lens = sentences per sample, inner lens = words per
    sentence (flat, in sample-major order).  ``data`` is the packed
    [sum(inner), ...] word-row array (or nested lists)."""
    from .data_feeder import _bucket

    outer = [int(v) for v in recursive_seq_lens[0]]
    inner = [int(v) for v in recursive_seq_lens[1]]
    if sum(outer) != len(inner):
        raise ValueError(
            f"sum(outer)={sum(outer)} != number of inner sequences "
            f"{len(inner)}")
    if isinstance(data, list):
        packed = np.concatenate(
            [np.asarray(r) for r in data]) if data else np.zeros((0, 1))
    else:
        packed = np.asarray(data)
    if packed.shape[0] != sum(inner):
        raise ValueError(
            f"packed rows {packed.shape[0]} != sum(inner) {sum(inner)}")
    B = len(outer)
    S = _bucket(max(outer)) if outer else 0
    W = _bucket(max(inner)) if inner else 0
    padded = np.zeros((B, S, W) + packed.shape[1:], packed.dtype)
    inner_lens = np.zeros((B, S), np.int64)
    off = 0
    k = 0
    for b, n_sent in enumerate(outer):
        for sidx in range(n_sent):
            ln = inner[k]
            padded[b, sidx, :ln] = packed[off:off + ln]
            inner_lens[b, sidx] = ln
            off += ln
            k += 1
    return LoDTensor(padded, outer, inner_lens)


def _unpad(lt: LoDTensor) -> np.ndarray:
    if lt.inner_lens is not None:
        # nested: pack word rows sentence by sentence (skip all padding)
        rows = [lt.data[b, s, :int(lt.inner_lens[b, s])]
                for b, n in enumerate(lt.seq_lens) for s in range(int(n))]
        return (np.concatenate(rows) if rows
                else np.zeros((0,) + lt.data.shape[3:], lt.data.dtype))
    return np.concatenate([lt.data[i, :ln]
                           for i, ln in enumerate(lt.seq_lens)])


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1) -> LoDTensor:
    """Reference lod_tensor.py create_random_int_lodtensor."""
    lens = [int(v) for v in recursive_seq_lens[0]]
    data = np.random.randint(low, high + 1,
                             (sum(lens),) + tuple(base_shape)).astype(
                                 np.int64)
    return create_lod_tensor(data, recursive_seq_lens, place)
