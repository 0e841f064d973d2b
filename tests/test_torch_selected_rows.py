"""The port's ``SelectedRows`` helpers against the JAX reference's
(``paddle_tpu/core/selected_rows.py``), on the same numpy inputs from a
seed: ``merge_rows``, ``dense_grad_and_mask``, ``gather_rows``,
``scatter_set_rows`` and ``to_dense``, with duplicate ids, negative ids
that wrap, out-of-range ids and the ``merge_rows`` sentinel.

All exact: every helper is a gather, a scatter or a sum of each run of
duplicates taken left to right, in the same order on both sides (the
CPU scatter-add of the reference's ``segment_sum`` and the port's
pass per run position).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import selected_rows as JSR
from paddle_tpu_torch.core import selected_rows as TSR

H, D = 11, 3


def _case(seed, n=17, lo=0, hi=H, dtype=np.int64):
    rng = np.random.RandomState(seed)
    rows = rng.randint(lo, hi, n).astype(dtype)
    rows[1] = rows[0]                      # a guaranteed duplicate
    vals = rng.randn(n, D).astype(np.float32)
    return rows, vals


def _both(rows, vals, height=H, merged=False):
    return (JSR.SelectedRows(jnp.asarray(rows), jnp.asarray(vals), height,
                             merged),
            TSR.SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                             height, merged))


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_rows_matches_reference(seed, dtype):
    rows, vals = _case(seed, dtype=dtype)
    j, t = _both(rows, vals)
    jm, tm = JSR.merge_rows(j), TSR.merge_rows(t)
    assert tm.merged and tm.height == H
    assert tm.rows.dtype == torch.from_numpy(rows).dtype
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_array_equal(tm.values.numpy(), np.asarray(jm.values))
    n_unique = len(np.unique(rows))
    assert (tm.rows.numpy() == H).sum() == len(rows) - n_unique


def test_merge_rows_many_duplicates_in_order():
    """One id repeated 9 times among others: the run is summed left to
    right, bit for bit as the reference's segment_sum."""
    rng = np.random.RandomState(3)
    rows = np.array([4, 2, 4, 4, 9, 4, 4, 2, 4, 4, 4, 0, 4], np.int64)
    vals = (rng.randn(len(rows), D) * 10.0 ** rng.randint(-3, 4, (
        len(rows), 1))).astype(np.float32)
    j, t = _both(rows, vals)
    np.testing.assert_array_equal(TSR.merge_rows(t).values.numpy(),
                                  np.asarray(JSR.merge_rows(j).values))


def test_merge_rows_keeps_merged_and_empty():
    rows, vals = _case(4)
    _, t = _both(rows, vals, merged=True)
    assert TSR.merge_rows(t) is t
    _, e = _both(np.zeros(0, np.int64), np.zeros((0, D), np.float32))
    assert TSR.merge_rows(e) is e


@pytest.mark.parametrize("seed,lo,hi", [(0, 0, H), (5, -H - 3, H + 3)],
                         ids=["in_range", "out_of_range"])
def test_dense_grad_and_mask_matches_reference(seed, lo, hi):
    rows, vals = _case(seed, lo=lo, hi=hi)
    j, t = _both(rows, vals)
    jg, jt = JSR.dense_grad_and_mask(j)
    tg, tt = TSR.dense_grad_and_mask(t)
    assert tt.dtype == torch.bool and tuple(tt.shape) == (H, 1)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # to_dense: the same scatter without the mask
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))


def test_dense_grad_and_mask_one_dim_values():
    rng = np.random.RandomState(6)
    rows = np.array([3, 1, 3, 7, -1, 40], np.int64)
    vals = rng.randn(6).astype(np.float32)
    j, t = _both(rows, vals)
    jg, jt = JSR.dense_grad_and_mask(j, jnp.float32)
    tg, tt = TSR.dense_grad_and_mask(t, torch.float32)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_gather_and_scatter_set_rows_with_sentinels():
    """merge_rows output (sentinel rows) through gather_rows and
    scatter_set_rows: the sentinel reads as zero and is dropped."""
    rows, vals = _case(7, lo=-H, hi=H)
    j, t = _both(rows, vals)
    jm, tm = JSR.merge_rows(j), TSR.merge_rows(t)
    rng = np.random.RandomState(8)
    dense = rng.randn(H, D).astype(np.float32)
    jd, td = jnp.asarray(dense), torch.from_numpy(dense.copy())
    np.testing.assert_array_equal(TSR.gather_rows(td, tm.rows).numpy(),
                                  np.asarray(JSR.gather_rows(jd, jm.rows)))
    new = rng.randn(len(rows), D).astype(np.float32)
    got = TSR.scatter_set_rows(td, tm.rows, torch.from_numpy(new))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JSR.scatter_set_rows(jd, jm.rows, jnp.asarray(new))))
    np.testing.assert_array_equal(td.numpy(), dense)   # a copy, not in place


def test_gather_rows_out_of_range_reads_zero():
    dense = np.arange(H * D, dtype=np.float32).reshape(H, D)
    rows = np.array([0, H, -1, -H, -H - 1, 3, 2 * H], np.int64)
    np.testing.assert_array_equal(
        TSR.gather_rows(torch.from_numpy(dense), torch.from_numpy(rows))
        .numpy(),
        np.asarray(JSR.gather_rows(jnp.asarray(dense), jnp.asarray(rows))))


def test_selected_rows_shape_and_device():
    rows, vals = _case(9)
    _, t = _both(rows, vals)
    assert t.shape == (H, D) and t.dtype == torch.float32
    moved = t.to("cpu")
    assert moved.height == H and not moved.merged
    assert torch.equal(moved.values, t.values)
    assert "height=11" in repr(t)


def test_prefer_dense_update_reads_the_flag():
    from paddle_tpu_torch.core import flags
    rows, vals = _case(10)
    _, t = _both(rows, vals)
    old = flags.get_flags("sparse_dense_update_max_elems")
    try:
        flags.set_flags({"sparse_dense_update_max_elems": H * D})
        assert TSR.prefer_dense_update(t)
        flags.set_flags({"sparse_dense_update_max_elems": H * D - 1})
        assert not TSR.prefer_dense_update(t)
    finally:
        flags.set_flags({"sparse_dense_update_max_elems": old})
