"""Sparse-embedding kernels: the multi-table gather (K9) and the row-wise
lazy optimizer update (K10).

The port of ``paddle_tpu/kernels/sparse.py``.  Both kernels serve the
DeepFM path with ``FLAGS_sparse_fused_kernel`` on:

- :func:`fused_gather` (K9, the reference's ``_gather_kernel``): ONE
  launch gathers the same id batch from k <= 4 tables.  Ids in [-H, H)
  wrap; any other id gives a NaN row on a float table (``jnp.take``'s
  rule), so a data bug in the feed fails the step loudly on both paths.
  It takes int32 or int64 ids as they come; its launch is one packed
  argument block (:func:`gather_params`).
- :func:`rowwise_update` (K10, the reference's ``_rowwise_update`` and
  ``_update_kernel``): one launch per table updates, in place, only the
  rows a ``SelectedRows`` gradient touches.  Before the launch, torch
  ops canonicalize the ids and sort them stably as int32 keys
  (:func:`sorted_segments`; the reference also sorts outside its
  ``pallas_call``).  The kernel finds the runs of equal ids itself, sums
  each left to right in batch order in float32, reading the values
  through the sort's permutation, and applies the Adam, momentum or
  adagrad math once per unique row.  Untouched rows are never read.
  Tables updated by gradients of one id batch in one run (DeepFM's two)
  share one sort: the optimizer rules pass the run's memo
  (``LowerContext.run_memo``).

Beside them are their plain PyTorch versions, :func:`fused_gather_ref`
and :func:`rowwise_update_ref` (with :func:`_adam_math`,
:func:`_momentum_math`, :func:`_adagrad_math`): the CPU runs them, and
the kernels are held against them on the card.  A wrapper takes its
plain version only for CPU tensors; a CUDA tensor launches the kernel
or raises.  There is no fallback on a fault (the reference returns
``None`` from any exception); the one routing left is by semantics:
:func:`_eligible` sends a gradient the kernel's float32 math cannot
reproduce (merged rows, other dtypes) to the unfused paths, counted as
``sparse_fused.update_fallbacks``.  Each wrapper adds one to its
``launches`` where it launches its kernel.

The reference's ``jaxpr_census`` (a count of scatter ops and Pallas
launches in a traced step) has no counterpart: the launch counters say
which kernels a step ran.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from ..core import flags
from ..core.selected_rows import (run_shared, segment_starts,
                                  segment_sum_in_order, take_rows)
from ..observability import stats as _obs_stats
from . import _build

__all__ = [
    "LookupFusion",
    "enabled_for",
    "fused_adagrad",
    "fused_adam",
    "fused_enabled",
    "fused_gather",
    "fused_gather_ref",
    "fused_momentum",
    "gather_params",
    "plan_lookup_fusion",
    "rowwise_update",
    "rowwise_update_ref",
    "rowwise_update_sorted",
    "sorted_segments",
]

_GATHER, _UPDATE = "sparse_gather", "sparse_update"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_int64
_FLOAT = ctypes.c_float
MAX_TABLES = 4
# sparse_gather(params, stream): params is one packed block (the C
# struct GatherParams): ids, n, table[4], out[4], height[4], width[4],
# k, id bytes, device, 0
_GATHER_PARAMS = struct.Struct("<Qq8Q4q8i")
_GATHER_ARGS = [ctypes.c_char_p, _PTR]
_GATHER_IDS = (torch.int32, torch.int64)
# sparse_update(kind, rows, order, vals, n, d, p, a, b, lr, h1, h2, h3,
# flag, device, stream)
_UPDATE_ARGS = ([_INT, _PTR, _PTR, _PTR, _I64, _INT] + [_PTR] * 4
                + [_FLOAT] * 3 + [_INT, _INT, _PTR])
_KINDS = {"adam": 0, "momentum": 1, "adagrad": 2}


_counters = {}


def _count(name: str) -> None:
    """Add one to ``sparse_fused.<name>`` in the stats registry."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = _obs_stats.scope("sparse_fused").counter(name)
    c.inc()


def fused_enabled() -> bool:
    """``FLAGS_sparse_fused_kernel``, read when a block runs."""
    return bool(flags.get_flags("sparse_fused_kernel"))


def enabled_for(ctx) -> bool:
    """Per-run gate: the flag (the port has no mesh to exclude)."""
    del ctx
    return fused_enabled()


def _kernel_fn(lib: str, argtypes):
    fn = getattr(_build.load(lib), lib)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _raise_launch(lib: str, err: int):
    fn = getattr(_build.load(lib), f"{lib}_error_string")
    fn.argtypes = [_INT]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{lib} launch failed: {fn(err).decode()} "
                       f"(cudaError {err})")


# ---------------------------------------------------------------------------
# K9: fused multi-table gather
# ---------------------------------------------------------------------------

def fused_gather_ref(tables, ids):
    """Plain K9: ``jnp.take(table, ids, axis=0)`` for every table, each
    shaped ``ids.shape + (D_t,)``."""
    return [take_rows(t, ids) for t in tables]


def gather_params(ids, n: int, tables, outs, heights, widths,
                  dev: int) -> bytes:
    """K9's packed argument block (the C struct GatherParams): the ids,
    ``n`` of them, each table's and output's address, height and width,
    the table count, the id width in bytes and the device."""
    pad = [0] * (MAX_TABLES - len(tables))
    return _GATHER_PARAMS.pack(
        ids.data_ptr(), n, *[t.data_ptr() for t in tables], *pad,
        *[o.data_ptr() for o in outs], *pad, *heights, *pad, *widths, *pad,
        len(tables), ids.element_size(), dev, 0)


def fused_gather(tables, ids):
    """Gather ``table[ids]`` for every table in ONE launch (module doc).

    ``tables``: 1..4 float32 [H_t, D_t] tensors sharing the id batch;
    ``ids``: an int32 or int64 tensor of any shape.  CPU tensors take
    :func:`fused_gather_ref`; CUDA tensors launch K9 on the current
    stream (none for an empty batch), or raise."""
    if not ids.is_cuda:
        if ids.device.type == "cpu":
            return fused_gather_ref(tables, ids)
        raise ValueError(f"fused_gather: unsupported device {ids.device}")
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"fused_gather takes 1..{MAX_TABLES} tables, got "
                         f"{len(tables)}")
    if ids.dtype not in _GATHER_IDS:
        raise TypeError(f"fused_gather: ids must be int32/int64, got "
                        f"{ids.dtype}")
    dev = ids.get_device()
    heights, widths = [], []
    for i, t in enumerate(tables):
        if t.get_device() != dev:
            raise ValueError(f"table {i} is on {t.device}, ids on "
                             f"{ids.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"fused_gather: table {i} must be a 2-D float32"
                            f" tensor, got {t.dtype} {tuple(t.shape)}")
        h, d = t.shape
        if not t.is_contiguous() or h < 1:
            raise ValueError(f"fused_gather: table {i} must be contiguous "
                             "and non-empty")
        heights.append(h)
        widths.append(d)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    outs = [ids.new_empty((*ids.shape, d), dtype=torch.float32)
            for d in widths]
    n = ids.numel()
    if n:
        err = _kernel_fn(_GATHER, _GATHER_ARGS)(
            gather_params(ids, n, tables, outs, heights, widths, dev),
            _build.current_stream(ids))
        if err != 0:
            _raise_launch(_GATHER, err)
        fused_gather.launches += 1
        _count("gather_launches")
    return outs


fused_gather.launches = 0


# ---------------------------------------------------------------------------
# K10: row-wise lazy optimizer update
# ---------------------------------------------------------------------------

def sorted_segments(rows, height: int):
    """Canonicalize and stably sort an id batch: ``(r, order)``, ``r``
    the sorted int32 rows and ``order`` int64 with ``r[k] ==
    canonical(rows)[order[k]]``; equal ids keep their batch order, which
    is the order their values are summed in.  Ids in [-H, 0) wrap and
    the rest clamp to an edge row, before the sort, so ids that land on
    one row form ONE run (the reference's rule; program-made ids are in
    range, and an out-of-range feed id has already made the forward
    NaN).  Adds one to ``sorted_segments.launches`` (a torch sort, on
    the CPU too)."""
    if height >= 1 << 31:
        raise ValueError(f"sorted_segments: height {height} does not fit "
                         "the kernel's int32 rows")
    # clamped into [-H, H) and wrapped: ids past either end land on the
    # edge row, as clamping after the wrap puts them there
    rows = torch.remainder(rows.clamp(-height, height - 1).to(torch.int32),
                           height)
    r, order = torch.sort(rows, stable=True)
    sorted_segments.launches += 1
    return r, order


sorted_segments.launches = 0


def _segments(rows, height: int, memo):
    """:func:`sorted_segments` of ``rows``, shared through ``memo`` (a
    dict that lives for one ``Executor.run``) with every other update of
    the run whose rows are the same tensor memory, unwritten since, at
    the same height (``run_shared``)."""
    return run_shared(memo, ("sorted_segments", height), [rows],
                      lambda: sorted_segments(rows, height))


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _adam_math(g, lr, ins, *, beta1, beta2, eps):
    p, m1, m2 = ins
    b1, b2, e, one = (_f32(x, g) for x in (beta1, beta2, eps, 1.0))
    m1n = b1 * m1 + (one - b1) * g
    m2n = b2 * m2 + (one - b2) * g * g
    step = lr * m1n / (torch.sqrt(m2n) + e)
    return [p - step, m1n, m2n]


def _momentum_math(g, lr, ins, *, mu, nesterov):
    p, v = ins
    muf = _f32(mu, g)
    v_new = muf * v + g
    if nesterov:
        return [p - (g + muf * v_new) * lr, v_new]
    return [p - lr * v_new, v_new]


def _adagrad_math(g, lr, ins, *, eps):
    p, mom = ins
    mom_new = mom + g * g
    step = lr * g / (torch.sqrt(mom_new) + _f32(eps, g))
    return [p - step, mom_new]


_MATH = {"adam": _adam_math, "momentum": _momentum_math,
         "adagrad": _adagrad_math}


def rowwise_update_ref(r, order, vals, tables, lr, kind, **hyper):
    """Plain K10 on the output of :func:`sorted_segments`: each run of
    equal ``r`` summed left to right in float32 over ``vals[order]``
    (starting from its first row, as the kernel does), the ``kind`` math
    applied once per unique row, and the rows written back into
    ``tables`` IN PLACE.  Returns ``tables``."""
    v = vals[order]
    first, seg, pos = segment_starts(r)
    rest = ~first
    acc = segment_sum_in_order(v[rest], seg[rest], pos[rest] - 1,
                               v[first].clone())
    urows = r[first].long()
    new = _MATH[kind](acc, lr, [t[urows] for t in tables], **hyper)
    for t, x in zip(tables, new):
        t[urows] = x
    return tables


def _check_update(r, order, v, tables, lr):
    n = r.shape[0]
    for name, t, dtype in (("rows", r, torch.int32),
                           ("order", order, torch.int64)):
        if t.device != v.device or t.dtype != dtype or \
                tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"rowwise_update: {name} must be a contiguous "
                             f"{dtype} [{n}] tensor on {v.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    named = [("values", v)] + [(f"table {i}", t)
                               for i, t in enumerate(tables)]
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"rowwise_update: {name} is on {t.device}, "
                             f"rows on {r.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"rowwise_update: {name} must be a 2-D float32"
                            f" tensor, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"rowwise_update: {name} must be contiguous")
    want = [(n, v.shape[1])] + \
        [(tables[0].shape[0], v.shape[1])] * len(tables)
    for (name, t), shape in zip(named, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"rowwise_update: {name} is {tuple(t.shape)},"
                             f" expected {shape}")
    if lr.numel() != 1 or lr.dtype != torch.float32 or \
            lr.device != r.device:
        raise ValueError("rowwise_update: lr must be one float32 value on "
                         "the tables' device")


def rowwise_update(sr, tables, lr, kind, memo=None, **hyper):
    """Apply the ``kind`` math ("adam": p, m1, m2 with beta1, beta2, eps;
    "momentum": p, velocity with mu, nesterov; "adagrad": p, moment with
    eps) once per unique row of ``sr``, IN PLACE on ``tables``; returns
    ``tables``.  ``lr``: a one-element float32 tensor (the bias-corrected
    step for Adam), read by the kernel from device memory.

    An empty batch changes nothing.  Otherwise the ids are sorted
    (:func:`sorted_segments`, shared through ``memo``, the run's memo,
    with the other updates of the run over the same ids); CPU tensors
    then take :func:`rowwise_update_ref`, CUDA tensors
    :func:`rowwise_update_sorted` (K10)."""
    tables = list(tables)
    if sr.rows.shape[0] == 0:
        return tables
    r, order = _segments(sr.rows, sr.height, memo)
    if r.device.type == "cpu":
        return rowwise_update_ref(r, order, sr.values, tables,
                                  lr.reshape(()), kind, **hyper)
    return rowwise_update_sorted(r, order, sr.values.contiguous(), tables,
                                 lr, kind, **hyper)


def rowwise_update_sorted(r, order, vals, tables, lr, kind, **hyper):
    """Launch K10 on the current stream over the output of
    :func:`sorted_segments` and the values in batch order (CUDA
    tensors), updating ``tables`` in place; raises on what the kernel
    does not take.  Adds one to ``rowwise_update.launches``."""
    if r.device.type != "cuda":
        raise ValueError(f"rowwise_update: unsupported device {r.device}")
    n_tables = {"adam": 3, "momentum": 2, "adagrad": 2}[kind]
    if len(tables) != n_tables:
        raise ValueError(f"rowwise_update({kind}) takes {n_tables} tables, "
                         f"got {len(tables)}")
    lr = lr.reshape(1)
    _check_update(r, order, vals, tables, lr)
    h = (hyper.get("beta1", hyper.get("mu", 0.0)),
         hyper.get("beta2", 0.0), hyper.get("eps", 0.0))
    ptrs = [t.data_ptr() for t in tables] + [None] * (3 - n_tables)
    fn = _kernel_fn(_UPDATE, _UPDATE_ARGS)
    stream = _build.current_stream(r)
    err = fn(_KINDS[kind], r.data_ptr(), order.data_ptr(), vals.data_ptr(),
             r.shape[0], vals.shape[1], *ptrs, lr.data_ptr(), *h,
             int(bool(hyper.get("nesterov", False))), r.device.index, stream)
    if err != 0:
        _raise_launch(_UPDATE, err)
    rowwise_update.launches += 1
    _count("update_launches")
    return tables


rowwise_update.launches = 0


def _eligible(sr, tables) -> bool:
    """The kernel reproduces the sorted reference only when the merge and
    the math both run in float32 on unmerged rows (the production
    embedding configuration); anything else takes the unfused paths,
    counted."""
    ok = (not sr.merged and sr.values.dim() == 2
          and sr.values.dtype == torch.float32
          and all(t.dim() == 2 and t.dtype == torch.float32
                  and t.shape[1] == sr.values.shape[1] for t in tables))
    if not ok:
        _count("update_fallbacks")
    return ok


def fused_adam(p, m1, m2, sr, lr_eff, beta1, beta2, eps, memo=None):
    """Lazy sparse Adam (one K10 launch): (p, m1, m2) updated in place,
    or None when :func:`_eligible` routes the gradient elsewhere.
    ``lr_eff`` is the bias-corrected step the sorted path uses; ``memo``
    the run's memo (:func:`rowwise_update`)."""
    if not _eligible(sr, (p, m1, m2)):
        return None
    return tuple(rowwise_update(sr, [p, m1, m2], lr_eff, "adam", memo,
                                beta1=beta1, beta2=beta2, eps=eps))


def fused_momentum(p, velocity, sr, lr, mu, nesterov, memo=None):
    """Lazy sparse momentum (one K10 launch): (p, velocity) or None."""
    if not _eligible(sr, (p, velocity)):
        return None
    return tuple(rowwise_update(sr, [p, velocity], lr, "momentum", memo,
                                mu=mu, nesterov=bool(nesterov)))


def fused_adagrad(p, moment, sr, lr, eps, memo=None):
    """Lazy sparse adagrad (one K10 launch): (p, moment) or None."""
    if not _eligible(sr, (p, moment)):
        return None
    return tuple(rowwise_update(sr, [p, moment], lr, "adagrad", memo,
                                eps=eps))


# ---------------------------------------------------------------------------
# block-level lookup_table gather fusion (used by core/lowering.py)
# ---------------------------------------------------------------------------

class LookupFusion:
    """Peephole plan for one run of a block: each group of sparse
    ``lookup_table`` ops sharing one Ids input (DeepFM's two tables) is
    gathered by ONE :func:`fused_gather` launch.

    Built by :func:`plan_lookup_fusion`; ``core/lowering.py`` asks
    ``covers(pos)`` per op and calls ``lower(pos, env)``, which gathers
    the whole group at its first member and puts each member's output
    into ``env``.  It returns False, and every member lowers through its
    own rule, when a table is not the float32 matrix K9 takes (counted
    as ``sparse_fused.gather_fallbacks``)."""

    def __init__(self, groups):
        self._by_pos = {pos: g for g in groups for pos, _ in g}
        self._done = {}   # id(group) -> {out_name: value} or None

    def covers(self, pos: int) -> bool:
        return pos in self._by_pos

    def lower(self, pos: int, env: dict) -> bool:
        group = self._by_pos[pos]
        key = id(group)
        if key not in self._done:
            self._done[key] = self._lower_group(group, env)
        outs = self._done[key]
        if outs is None:
            return False
        _, op = next(p for p in group if p[0] == pos)
        out_name = op.outputs["Out"][0]
        env[out_name] = outs[out_name]
        return True

    @staticmethod
    def _lower_group(group, env):
        ids = env[group[0][1].inputs["Ids"][0]]
        tables = [env[op.inputs["W"][0]] for _, op in group]
        if any(t.dim() != 2 or t.dtype != torch.float32 for t in tables):
            _count("gather_fallbacks")
            return None
        if ids.dim() >= 2 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        outs = {}
        for (_, op), out in zip(group, fused_gather(tables, ids)):
            pad = op.attrs.get("padding_idx", -1)
            if pad is not None and pad != -1:
                out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
            outs[op.outputs["Out"][0]] = out
        return outs


def plan_lookup_fusion(block):
    """Scan ``block`` for fusable ``lookup_table`` groups; a
    ``LookupFusion`` or None.  Only sparse-gradient lookups are grouped,
    only groups of 2..4 sharing one Ids var, and only when nothing
    between the members writes a grouped table or the Ids var: hoisting
    the later members' reads to the first member would otherwise read
    stale values the per-op lowering would not."""
    if not fused_enabled():
        return None
    by_ids = {}
    for pos, op in enumerate(block.ops):
        if op.type != "lookup_table" or not op.attrs.get("is_sparse"):
            continue
        w, ids = op.inputs.get("W"), op.inputs.get("Ids")
        if not w or not ids or len(w) != 1 or len(ids) != 1:
            continue
        by_ids.setdefault(ids[0], []).append((pos, op))
    groups = []
    for ids_name, g in by_ids.items():
        if not 2 <= len(g) <= MAX_TABLES:
            continue
        member_pos = {pos for pos, _ in g}
        hazard = {ids_name} | {op.inputs["W"][0] for _, op in g}
        lo, hi = g[0][0], g[-1][0]
        clobbered = any(
            pos not in member_pos
            and any(n in hazard for n in block.ops[pos].output_arg_names())
            for pos in range(lo + 1, hi))
        if not clobbered:
            groups.append(g)
    return LookupFusion(groups) if groups else None
