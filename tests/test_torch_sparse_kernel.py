"""The port's sparse-embedding kernels' plain versions and the sparse
optimizer rules against the JAX reference, on the same numpy inputs.

- ``fused_gather_ref`` (plain K9) against the reference's
  ``fused_gather`` (its Pallas kernel in interpret mode): out-of-range
  ids give NaN rows, an empty batch gives empty outputs; int32 ids, 3
  and 4 tables, widths 1 to 64 and a skewed (Zipf) batch, through the
  wrapper's CPU path too; exact (a copy).  K9's packed argument block
  (``gather_params``) holds each field at the offset the C struct
  asserts for it.
- ``rowwise_update`` on CPU tensors (plain K10) against the reference's
  ``fused_adam``/``fused_momentum``/``fused_adagrad`` in interpret mode
  at the reference's own bound, rtol 2e-6 / atol 1e-6 (XLA may contract
  or reorder the elementwise chain; the port does not), on uniform,
  wrapping and skewed (Zipf) ids, plus the dyadic case where every
  operation is exact, bit for bit; one sort shared by two tables within
  a run gives the tables of a sort each.
- the ``sgd``/``momentum``/``adam``/``adagrad`` rules with a
  ``SelectedRows`` gradient, on each of the three paths (fused,
  masked-dense, sorted), against the reference's rules on the same
  path, at the same bound.
- the lookup fusion plan: same-Ids groups fuse, a clobbered group does
  not, and the outputs do not change.
- ``lookup_table``'s out-of-range rule, forward and gradient.

Interpret mode costs about 0.6 ms a grid position, so every launch here
stays under 200 id positions.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import flags as jflags
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core import selected_rows as JSR
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.kernels import sparse as JS
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core import selected_rows as TSR
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import sparse as TS

FV, FD, FN = 23, 5, 17          # the reference suite's shapes
TOL = dict(rtol=2e-6, atol=1e-6)


@pytest.fixture
def flag_state():
    """Restore both packages' sparse flags after a test."""
    names = ("sparse_fused_kernel", "sparse_dense_update_max_elems")
    saved = [{n: f.get_flags(n) for n in names} for f in (jflags, tflags)]
    yield
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def _set_path(path):
    """Both packages onto one sparse update path."""
    for f in (jflags, tflags):
        f.set_flags({"sparse_fused_kernel": path == "fused",
                     "sparse_dense_update_max_elems":
                         0 if path == "sorted" else 32_000_000})


def _sr(seed=0, n=FN, dyadic=False, lo=0, hi=FV):
    rng = np.random.RandomState(seed)
    rows = rng.randint(lo, hi, n).astype(np.int64)
    if n >= 2:
        rows[1] = rows[0]
    if dyadic:
        vals = rng.randint(-8, 8, (n, FD)).astype(np.float32)
    else:
        vals = rng.randn(n, FD).astype(np.float32)
    return rows, vals


def _skewed_sr(seed, n=60, top=0.1):
    """A skewed batch: Zipf ids (p_k proportional to k^-s over the FV
    rows, s set so the hottest id covers a ``top`` share of the batch),
    the ranks spread over the rows by a seeded permutation."""
    rng = np.random.RandomState(seed)
    k = np.arange(1, FV + 1, dtype=np.float64)
    lo, hi = 0.0, 8.0
    for _ in range(60):   # the hottest id's share grows with s
        s = (lo + hi) / 2
        lo, hi = (lo, s) if 1.0 / np.sum(k ** -s) > top else (s, hi)
    p = k ** -s
    rows = rng.permutation(FV)[rng.choice(FV, n, p=p / p.sum())]
    return rows.astype(np.int64), rng.randn(n, FD).astype(np.float32)


def _j_sr(rows, vals):
    return JSR.SelectedRows(jnp.asarray(rows), jnp.asarray(vals), FV)


def _t_sr(rows, vals):
    return TSR.SelectedRows(torch.from_numpy(rows.copy()),
                            torch.from_numpy(vals.copy()), FV)


def _tables(seed, positive):
    rng = np.random.RandomState(seed)
    out = []
    for pos in positive:
        a = rng.randn(FV, FD).astype(np.float32)
        out.append(np.abs(a) if pos else a)
    return out


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def test_fused_gather_out_of_range_matches_reference():
    t = np.arange(float(FV * FD), dtype=np.float32).reshape(FV, FD)
    w1 = np.arange(float(FV), dtype=np.float32).reshape(FV, 1) * -1.5
    ids = np.array([[0, FV, -1], [-FV, -FV - 1, 3]], np.int64)
    want = JS.fused_gather([jnp.asarray(t), jnp.asarray(w1)],
                           jnp.asarray(ids))
    got = TS.fused_gather([_t(t), _t(w1)], _t(ids))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isnan(got[0].numpy()[0, 1]).all()
    np.testing.assert_array_equal(got[0].numpy()[0, 2], t[FV - 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_gather_random_batch_matches_reference(seed):
    rng = np.random.RandomState(seed)
    tabs = [rng.randn(FV, FD).astype(np.float32),
            rng.randn(FV, 1).astype(np.float32)]
    ids = rng.randint(-FV - 2, FV + 2, (6, 7)).astype(np.int64)
    want = JS.fused_gather([jnp.asarray(x) for x in tabs], jnp.asarray(ids))
    got = TS.fused_gather_ref([_t(x) for x in tabs], _t(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_gather_empty_batch():
    p = np.ones((FV, FD), np.float32)
    want = JS.fused_gather([jnp.asarray(p)], jnp.zeros((0,), jnp.int32))
    before = TS.fused_gather.launches
    (got,) = TS.fused_gather([_t(p)], torch.zeros(0, dtype=torch.int64))
    assert tuple(got.shape) == want[0].shape == (0, FD)
    assert TS.fused_gather.launches == before   # the CPU launches nothing


def _gather_ids(kind, seed, shape=(6, 7)):
    """Ids for a gather case: uniform over [-FV - 2, FV + 2) (wrapping
    and out-of-range ones included), or a skewed (Zipf) batch."""
    if kind == "skewed":
        return _skewed_sr(seed, n=int(np.prod(shape)))[0].reshape(shape)
    return np.random.RandomState(seed).randint(-FV - 2, FV + 2, shape)


# table widths, id dtype, id kind: what the lookup rule can send K9
GATHER_CASES = {
    "int32_ids": ((FD, 1), np.int32, "uniform"),
    "three_tables": ((1, 3, 10), np.int64, "uniform"),
    "four_tables": ((1, 3, 10, 64), np.int32, "uniform"),
    **{f"width_{d}": ((d,), np.int64, "uniform")
       for d in (1, 2, 3, 4, 5, 8, 10, 16, 64)},
    "skewed": ((FD, 1), np.int64, "skewed"),
}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_fused_gather_cases_match_reference(case):
    """Plain K9 and the wrapper's CPU path against the reference's
    ``fused_gather`` (its Pallas kernel in interpret mode), exactly."""
    widths, dtype, kind = GATHER_CASES[case]
    rng = np.random.RandomState(len(case))
    tabs = [rng.randn(FV, d).astype(np.float32) for d in widths]
    ids = _gather_ids(kind, len(case)).astype(dtype)
    want = JS.fused_gather([jnp.asarray(x) for x in tabs], jnp.asarray(ids))
    t_tabs = [_t(x) for x in tabs]
    for got in (TS.fused_gather_ref(t_tabs, _t(ids)),
                TS.fused_gather(t_tabs, _t(ids))):
        assert len(got) == len(widths)
        for g, w in zip(got, want):
            assert tuple(g.shape) == ids.shape + g.shape[-1:] == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _gather_params_layout():
    """GatherParams' field offsets and size as ``csrc/sparse_gather.cu``
    asserts them (``static_assert(offsetof(...) == ...)``)."""
    with open(os.path.join(_build.CSRC_DIR, "sparse_gather.cu")) as f:
        src = f.read()
    offsets = {name: int(at) for name, at in re.findall(
        r"offsetof\(GatherParams, (\w+)\) == (\d+)", src)}
    size = int(re.search(r"sizeof\(GatherParams\) == (\d+)", src).group(1))
    return offsets, size


@pytest.mark.parametrize("widths,dtype", [
    ((FD, 1), torch.int64), ((1, 3, 10, 64), torch.int32), ((16,), torch.int32)])
def test_gather_params_pack_the_kernel_block(widths, dtype):
    """K9's one packed argument holds each field of the C struct
    ``GatherParams`` at the offset ``csrc/sparse_gather.cu`` asserts for
    it: the ids, their count, each table's and output's address, height
    and width, zeros past the last table, the table count, the id width
    in bytes and the device."""
    offsets, size = _gather_params_layout()
    tabs = [torch.zeros(FV + t, d) for t, d in enumerate(widths)]
    ids = torch.zeros((3, 5), dtype=dtype)
    outs = [torch.zeros(3, 5, d) for d in widths]
    heights = [t.shape[0] for t in tabs]
    block = TS.gather_params(ids, 15, tabs, outs, heights, list(widths), 2)
    assert len(block) == size
    pad = [0] * (TS.MAX_TABLES - len(widths))
    want = {"ids": [ids.data_ptr()], "n": [15],
            "table": [t.data_ptr() for t in tabs] + pad,
            "out": [o.data_ptr() for o in outs] + pad,
            "height": heights + pad, "width": list(widths) + pad,
            "k": [len(widths)], "id_bytes": [ids.element_size()],
            "device": [2], "reserved": [0]}
    assert set(offsets) == set(want)
    ends = sorted(offsets.values()) + [size]
    for name, value in want.items():
        at = offsets[name]
        step = (ends[ends.index(at) + 1] - at) // len(value)
        got = [int.from_bytes(block[at + i * step:at + (i + 1) * step],
                              "little", signed=True)
               for i in range(len(value))]
        assert got == value, name


def test_fused_gather_integer_table_clamps():
    t = np.arange(FV * 2, dtype=np.int32).reshape(FV, 2)
    ids = np.array([0, FV, -1, -FV - 1], np.int64)
    want = JS.fused_gather([jnp.asarray(t)], jnp.asarray(ids))
    (got,) = TS.fused_gather([_t(t)], _t(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

UPDATES = {   # kind: (reference fn, table signs (abs?), hyper, scalar)
    "adam": ((False, True, True), dict(beta1=0.9, beta2=0.999, eps=1e-8)),
    "momentum": ((False, False), dict(mu=0.9, nesterov=False)),
    "momentum_nesterov": ((False, False), dict(mu=0.9, nesterov=True)),
    "adagrad": ((False, True), dict(eps=1e-6)),
}


def _ref_update(kind, tabs, sr, lr, hyper):
    lr = jnp.float32(lr)
    j = [jnp.asarray(x) for x in tabs]
    if kind == "adam":
        return JS.fused_adam(*j, sr, lr, hyper["beta1"], hyper["beta2"],
                             hyper["eps"])
    if kind.startswith("momentum"):
        return JS.fused_momentum(*j, sr, lr, hyper["mu"], hyper["nesterov"])
    return JS.fused_adagrad(*j, sr, lr, hyper["eps"])


@pytest.mark.parametrize("kind", list(UPDATES))
@pytest.mark.parametrize("seed,lo,hi", [(0, 0, FV), (1, -FV, FV),
                                        (2, None, None)],
                         ids=["ids", "wrapped_ids", "skewed_ids"])
def test_rowwise_update_matches_reference(kind, seed, lo, hi):
    signs, hyper = UPDATES[kind]
    rows, vals = _sr(seed, lo=lo, hi=hi) if lo is not None else \
        _skewed_sr(seed)
    tabs = _tables(seed + 10, signs)
    want = _ref_update(kind, tabs, _j_sr(rows, vals), 0.1, hyper)
    assert want is not None
    got = [_t(x) for x in tabs]
    out = TS.rowwise_update(_t_sr(rows, vals), got, torch.tensor(
        0.1, dtype=torch.float32), kind.split("_")[0], **hyper)
    assert all(a is b for a, b in zip(out, got))   # in place
    touched = np.unique(np.where(rows < 0, rows + FV, rows))
    untouched = np.setdiff1d(np.arange(FV), touched)
    for g, w, x in zip(got, want, tabs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_array_equal(g.numpy()[untouched], x[untouched])


def test_rowwise_update_dyadic_is_exact():
    """Power-of-two constants and integer inputs make every operation
    exact: a missed duplicate, a wrong row or a reordered sum shows as a
    hard mismatch, against the reference and against a numpy walk."""
    rows, vals = _sr(3, n=9, dyadic=True)
    rng = np.random.RandomState(4)
    p = rng.randint(-16, 16, (FV, FD)).astype(np.float32)
    v = rng.randint(-16, 16, (FV, FD)).astype(np.float32)
    want = JS.fused_momentum(jnp.asarray(p), jnp.asarray(v),
                             _j_sr(rows, vals), jnp.float32(0.5), 0.5, False)
    tp, tv = _t(p), _t(v)
    TS.rowwise_update(_t_sr(rows, vals), [tp, tv],
                      torch.tensor(0.5), "momentum", mu=0.5, nesterov=False)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want[1]))
    pr, vr, merged = p.copy(), v.copy(), {}
    for r, g in zip(rows, vals):
        merged[int(r)] = merged.get(int(r), 0) + g
    for r, g in merged.items():
        vr[r] = 0.5 * vr[r] + g
        pr[r] = pr[r] - 0.5 * vr[r]
    np.testing.assert_array_equal(tp.numpy(), pr)
    np.testing.assert_array_equal(tv.numpy(), vr)


def test_rowwise_update_empty_batch_changes_nothing():
    p = np.ones((FV, FD), np.float32)
    tabs = [_t(p), _t(p), _t(p)]
    sr = TSR.SelectedRows(torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, FD), FV)
    before = TS.rowwise_update.launches
    out = TS.fused_adam(*tabs, sr, torch.tensor(0.1), 0.9, 0.999, 1e-8)
    assert TS.rowwise_update.launches == before
    for t in out:
        np.testing.assert_array_equal(t.numpy(), p)


def test_sorted_segments_canonicalize_before_sorting():
    """Ids that wrap onto one row form ONE run, in original order: the
    sorted int32 rows and the permutation K10 reads the values through."""
    rows = torch.tensor([3, -FV + 3, 1, 3 - FV, 7, 1])
    r, order = TS.sorted_segments(rows, FV)
    assert r.dtype == torch.int32 and order.dtype == torch.int64
    assert r.tolist() == [1, 1, 3, 3, 3, 7]
    assert order.tolist() == [2, 5, 0, 1, 3, 4]
    # ids past either end clamp to the edge rows, as the reference's
    # clip after the wrap does
    r, order = TS.sorted_segments(torch.tensor([FV, -FV - 1, 1 << 40, -FV]),
                                  FV)
    assert r.tolist() == [0, 0, FV - 1, FV - 1]
    assert order.tolist() == [1, 3, 0, 2]


def test_shared_sort_gives_the_same_tables_as_two_sorts():
    """Two tables updated from gradients of one id batch (two views of
    the ids, as ``lookup_table``'s grad makes them) sort once through a
    run's memo, with the same tables bit for bit as a sort each; a write
    to the ids makes the next update sort again."""
    rows, vals = _sr(21, n=40, lo=-FV, hi=FV)
    w1_vals = np.random.RandomState(22).randn(40, 1).astype(np.float32)
    ids = _t(rows)
    hyper = UPDATES["adam"][1]
    lr = torch.tensor(0.1)
    emb = _tables(23, (False, True, True))
    w1 = [np.abs(x[:, :1]) if i else x[:, :1].copy()
          for i, x in enumerate(_tables(24, (False, True, True)))]
    out = {}
    for memo in (None, {}):
        n0 = TS.sorted_segments.launches
        tabs = [[_t(x) for x in emb], [_t(x) for x in w1]]
        for t, v in zip(tabs, (vals, w1_vals)):
            TS.rowwise_update(TSR.SelectedRows(ids.reshape(-1), _t(v), FV), t,
                              lr, "adam", memo, **hyper)
        assert TS.sorted_segments.launches - n0 == (2 if memo is None else 1)
        out[memo is None] = tabs
    for a, b in zip(out[True], out[False]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    n0 = TS.sorted_segments.launches
    ids.add_(0)   # a write: the ids' version counter moves
    TS.rowwise_update(TSR.SelectedRows(ids.reshape(-1), _t(vals), FV),
                      out[False][0], lr, "adam", memo, **hyper)
    assert TS.sorted_segments.launches == n0 + 1


def test_eligible_routes_by_semantics():
    rows, vals = _sr(5)
    p = _t(_tables(6, (False,))[0])
    m = TSR.merge_rows(_t_sr(rows, vals))
    assert TS.fused_momentum(p, p.clone(), m, torch.tensor(0.1), 0.9,
                             False) is None          # merged rows
    half = TSR.SelectedRows(_t(rows), _t(vals).double(), FV)
    assert TS.fused_adagrad(p, p.clone(), half, torch.tensor(0.1),
                            1e-6) is None            # not float32


# ---------------------------------------------------------------------------
# the sparse optimizer rules on each path
# ---------------------------------------------------------------------------

RULES = {   # op: (slots, attrs, extra inputs {slot: positive?})
    "sgd": (("ParamOut",), {}, {"Param": False}),
    "adam": (("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut"), {"beta1": 0.9, "beta2": 0.999,
                               "epsilon": 1e-8},
             {"Param": False, "Moment1": True, "Moment2": True}),
    "momentum": (("ParamOut", "VelocityOut"), {"mu": 0.9},
                 {"Param": False, "Velocity": False}),
    "momentum_nesterov": (("ParamOut", "VelocityOut"),
                          {"mu": 0.9, "use_nesterov": True},
                          {"Param": False, "Velocity": False}),
    "adagrad": (("ParamOut", "MomentOut"), {"epsilon": 1e-6},
                {"Param": False, "Moment": True}),
}


@pytest.mark.parametrize("path", ["fused", "dense", "sorted"])
@pytest.mark.parametrize("op", list(RULES))
def test_sparse_rule_matches_reference(op, path, flag_state):
    slots, attrs, extra = RULES[op]
    rows, vals = _sr(11, lo=-FV, hi=FV)
    tabs = _tables(12, extra.values())
    names = list(extra)
    j_ins = {n: [jnp.asarray(x)] for n, x in zip(names, tabs)}
    t_ins = {n: [_t(x)] for n, x in zip(names, tabs)}
    j_ins["LearningRate"] = [jnp.asarray(np.float32(0.1))]
    t_ins["LearningRate"] = [torch.tensor(0.1)]
    if op == "adam":
        for n, v in (("Beta1Pow", 0.9 ** 3), ("Beta2Pow", 0.999 ** 3)):
            j_ins[n] = [jnp.asarray(np.float32(v))]
            t_ins[n] = [torch.tensor(np.float32(v))]
    j_ins["Grad"] = [_j_sr(rows, vals)]
    t_ins["Grad"] = [_t_sr(rows, vals)]
    _set_path(path)
    base = op.split("_")[0]
    want = jregistry.get(base).lower(jregistry.LowerContext(), j_ins, attrs)
    got = tregistry.get(base).lower(tregistry.LowerContext(), t_ins, attrs)
    for slot in slots:
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]),
                                   err_msg=f"{op}.{slot}", **TOL)


def test_fused_rule_updates_in_place(flag_state):
    """The fused path writes the scope's own tensors (no copy-back)."""
    rows, vals = _sr(13)
    p, m = _tables(14, (False, True))
    ins = {"Param": [_t(p)], "Moment": [_t(m)],
           "LearningRate": [torch.tensor(0.1)], "Grad": [_t_sr(rows, vals)]}
    _set_path("fused")
    out = tregistry.get("adagrad").lower(tregistry.LowerContext(), ins,
                                         {"epsilon": 1e-6})
    assert out["ParamOut"][0] is ins["Param"][0]
    assert out["MomentOut"][0] is ins["Moment"][0]


# ---------------------------------------------------------------------------
# the lookup fusion plan
# ---------------------------------------------------------------------------

V, D = 50, 8


def _grouping_program(fluid, Program, guard, unique, clobber):
    prog, startup = Program(), Program()
    prog.random_seed = startup.random_seed = 9
    with guard(prog, startup), unique.guard():
        ids = fluid.layers.data("ids", [4], dtype="int64")
        other = fluid.layers.data("other", [4], dtype="int64")
        a = fluid.layers.embedding(ids, [V, D], is_sparse=True,
                                   param_attr=fluid.ParamAttr(name="g.a"))
        if clobber:
            bump = fluid.layers.fill_constant([V, D], "float32", 2.0)
            fluid.layers.assign(bump, output=prog.global_block.var("g.a"))
        b = fluid.layers.embedding(ids, [V, 1], is_sparse=True,
                                   param_attr=fluid.ParamAttr(name="g.b"))
        c = fluid.layers.embedding(other, [V, D], is_sparse=True,
                                   param_attr=fluid.ParamAttr(name="g.c"))
        out = fluid.layers.concat(
            [fluid.layers.reduce_sum(a, dim=2),
             fluid.layers.reduce_sum(b, dim=2),
             fluid.layers.reduce_sum(c, dim=2)], axis=1)
    return prog, startup, out


_FEEDS = {"ids": (np.arange(8).reshape(2, 4) * 7 - 9) % V,
          "other": (np.arange(8).reshape(2, 4) * 3) % V}


@pytest.mark.parametrize("clobber", [False, True],
                         ids=["groups_by_ids", "clobbered_group"])
def test_lookup_fusion_plan(clobber, flag_state):
    """Same-Ids sparse lookups form one group (the other ids keep their
    own gather); an op between the members writing a grouped table
    kills the group.  Either way the outputs equal the reference's and
    the flag-off run's."""
    jprog, jstart, jout = _grouping_program(jfluid, JProgram, j_guard,
                                            j_unique, clobber)
    tprog, _, tout = _grouping_program(tfluid, TProgram, t_guard, t_unique,
                                       clobber)
    assert tprog.serialize() == jprog.serialize()
    feeds = {k: v.astype("int64") for k, v in _FEEDS.items()}
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(jstart)
        init = {n: np.array(scope.find_var(n)) for n in ("g.a", "g.b",
                                                         "g.c")}
        (want,) = exe.run(jprog, feed=feeds, fetch_list=[jout.name])
    outs = {}
    for flag in (False, True):
        tflags.set_flags({"sparse_fused_kernel": flag})
        plan = TS.plan_lookup_fusion(tprog.global_block)
        if flag and not clobber:
            lookups = [i for i, op in enumerate(tprog.global_block.ops)
                       if op.type == "lookup_table"]
            assert [plan.covers(i) for i in lookups] == [True, True, False]
        else:
            assert plan is None
        scope = tfluid.Scope()
        scope.load_numpy(init, device="cpu")
        (outs[flag],) = tfluid.Executor("cpu").run(
            tprog, feed=feeds, fetch_list=[tout.name], scope=scope)
    np.testing.assert_array_equal(outs[True], outs[False])
    np.testing.assert_allclose(outs[True], np.asarray(want), rtol=1e-6)


def test_lookup_fusion_masks_padding_idx(flag_state):
    """The fused gather zeroes the padding_idx rows after the gather, as
    each member's own rule does."""
    def build():
        prog, startup = TProgram(), TProgram()
        with t_guard(prog, startup), t_unique.guard():
            ids = tfluid.layers.data("ids", [4], dtype="int64")
            a = tfluid.layers.embedding(ids, [V, D], is_sparse=True,
                                        padding_idx=3)
            b = tfluid.layers.embedding(ids, [V, 1], is_sparse=True)
        return prog, startup, a, b
    outs = {}
    for flag in (False, True):
        tflags.set_flags({"sparse_fused_kernel": flag})
        prog, startup, a, b = build()
        scope = tfluid.Scope()
        exe = tfluid.Executor("cpu")
        exe.run(startup, scope=scope)
        outs[flag] = exe.run(prog, feed={"ids": np.array([[3, 1, 3, 0]])},
                             fetch_list=[a.name, b.name], scope=scope)
    assert (outs[True][0][0, [0, 2]] == 0).all()
    for x, y in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# lookup_table's out-of-range rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_sparse", [False, True], ids=["dense", "sparse"])
def test_lookup_table_out_of_range_ids_match_reference(is_sparse):
    """Ids [0, H, -1, -H, -H-1, 3]: the forward gives the wrapped rows and
    NaN rows, as ``jnp.take``; the dense gradient drops the out-of-range
    rows, as ``.at[rows].add``; the sparse gradient carries the raw ids
    and densifies to the same table."""
    h = 4
    w = np.arange(12, dtype=np.float32).reshape(h, 3)
    ids = np.array([0, h, -1, -h, -h - 1, 3], np.int64).reshape(6, 1)
    cot = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    attrs = {"is_sparse": is_sparse, "padding_idx": -1}
    jr, tr = jregistry.get("lookup_table"), tregistry.get("lookup_table")
    j_ins = {"W": [jnp.asarray(w)], "Ids": [jnp.asarray(ids)]}
    t_ins = {"W": [_t(w)], "Ids": [_t(ids)]}
    want = np.asarray(jr.lower(jregistry.LowerContext(), j_ins, attrs)
                      ["Out"][0])
    got = tr.lower(tregistry.LowerContext(), t_ins, attrs)["Out"][0].numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[[1, 4]]).all()
    j_ins["Out@GRAD"] = [jnp.asarray(cot)]
    t_ins["Out@GRAD"] = [_t(cot)]
    jg = jr.grad(jregistry.LowerContext(), j_ins, attrs)["W@GRAD"][0]
    tg = tr.grad(tregistry.LowerContext(), t_ins, attrs)["W@GRAD"][0]
    if is_sparse:
        assert isinstance(tg, TSR.SelectedRows) and tg.height == h
        np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
        np.testing.assert_array_equal(tg.values.numpy(),
                                      np.asarray(jg.values))
        jg, tg = jg.to_dense(), tg.to_dense()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    want_g = np.zeros_like(w)
    for r, c in zip(ids[:, 0], cot):
        if -h <= r < h:
            want_g[r % h] += c
    np.testing.assert_allclose(tg.numpy(), want_g, rtol=1e-6)
