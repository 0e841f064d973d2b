"""The port's inference plane against the JAX reference: model
directories, the program passes and the Predictor, float32 and int8.

- ``io``: a directory the reference's ``save_inference_model`` wrote
  loads in the port with an equal program dict and equal parameters,
  and a directory the port wrote loads in the reference the same way.
- the passes: each of ``apply_is_test``, ``fuse_fc_act``,
  ``fuse_conv_bn``, ``convert_to_nhwc``, ``fuse_fc_lstm``, ``fuse_fc_gru``,
  ``fuse_elewise_add_act`` and ``quantize_int8`` turns the same loaded
  program into the same program dict as the reference's pass, and the
  weights it writes (folded filters, summed RNN biases, the int8
  sidecars) are bit-equal.
- the Predictor, port (CPU: the kernels' plain versions) against
  reference, on the fc MLP of ``tests/test_quant_serving.py:121``, the
  QAT model of ``:136`` (built, trained and frozen by the reference) and
  a 2-layer Transformer at full width (d_model 512, 8 heads, d_ffn
  2048; vocabulary cut to 2000, which sizes only the embeddings and the
  output projection) at T=16 with dropout 0.1, which the predictor runs
  as identities.  float32 within 1e-5 of max|ref| (XLA's and torch's
  float32 products sum in other orders), every argmax equal.  int8:
  every stamped op, replayed by the port's plain version on the very
  input the reference gave it, is within 1e-6 of max|ref| of the
  reference kernel's output (which fuses its epilogue's multiply-add
  into one rounding).  End to end: each stamped op's activation
  quantizes to the same codes on both sides up to the first op where
  a code flips, and there at most FLIP_FRAC of the codes flip, each by
  one (an activation one float32 rounding apart, from the float32 ops
  between the stamped ones summing in other orders, crosses a rounding
  tie); a wrong int8 wiring moves most codes of the next op.  The MLP
  and the QAT model have no flip: their int8 outputs are within 1e-6
  of max|ref|.  In the Transformer the first flips come in the last
  decoder layer and move the next op's codes too, so its int8 logits
  are held only to the int8 error itself: two int8 runs whose float32
  parts round apart are two draws of that error around the float32
  answer, at most sqrt(2) times the RMS difference of the reference's
  int8 and float32 logits apart.
- ``FLAGS_int8_inference`` stamps like ``enable_int8()``, and an
  inference executor (``Executor(training=False)``) lowers dropout as
  the identity without ``is_test`` (``tests/test_inference.py:285``).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.inference import AnalysisConfig as JConfig
from paddle_tpu.inference import create_predictor as j_create
from paddle_tpu.inference import passes as JP
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.executor import Scope as TScope
from paddle_tpu_torch.core.executor import scope_guard as t_scope_guard
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.inference import AnalysisConfig as TConfig
from paddle_tpu_torch.inference import create_predictor as t_create
from paddle_tpu_torch.inference import passes as TP
from paddle_tpu_torch.kernels import quant as TQ

F32_TOL = 1e-5
REPLAY_TOL = 1e-6
# the share of a stamped op's activation codes that may flip at the first
# op where the port's and the reference's codes differ
FLIP_FRAC = 1e-3


def _norm(program):
    return json.loads(json.dumps(program.to_dict()))


def _arr(v):
    return v.numpy() if hasattr(v, "numpy") and not isinstance(
        v, np.ndarray) else np.asarray(v)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _ref_save(dirname, build, seed=3, setup=None):
    """Build with the reference's layers, run its startup program and
    save the inference model; ``setup(scope, program)`` may change the
    starting values first."""
    prog, startup = JProgram(), JProgram()
    prog.random_seed = seed
    with j_guard(prog, startup), j_unique.guard():
        feeds, outs = build(jfluid.layers)
    scope, exe = JScope(), JExecutor()
    with j_scope_guard(scope):
        exe.run(startup)
        if setup is not None:
            setup(scope, prog)
        jfluid.io.save_inference_model(dirname, feeds, outs, exe,
                                       main_program=prog)


def _load_both(dirname):
    """(reference program, scope, fetch names), (port program, scope,
    fetch names) loaded from ``dirname``."""
    js, ts = JScope(), TScope()
    with j_scope_guard(js):
        jp, _, jf = jfluid.io.load_inference_model(dirname, JExecutor())
    with t_scope_guard(ts):
        tp, _, tf = tfluid.io.load_inference_model(
            dirname, TExecutor(tfluid.CPUPlace()))
    return (jp, js, [v.name for v in jf]), (tp, ts, [v.name for v in tf])


def _assert_same_persistables(jp, js, ts):
    for v in jp.global_block.vars.values():
        if not v.persistable or js.find_var(v.name) is None:
            continue
        want = np.asarray(js.find_var(v.name))
        got = _arr(ts.find_var(v.name))
        assert got.dtype == want.dtype, v.name
        np.testing.assert_array_equal(got, want, err_msg=v.name)


def _mlp(L):
    x = L.data("x", [8])
    h = L.fc(x, 16, act="relu")
    y = L.fc(h, 4)
    return ["x"], [y]


def _mlp_leaky(L):
    """fused_fc with act attrs (leaky_relu alpha): quantize_int8 must
    leave it float32."""
    x = L.data("x", [6])
    h = L.fc(x, 5, act={"type": "leaky_relu", "alpha": 0.5})
    y = L.fc(h, 3, act="tanh")
    return ["x"], [y]


def _conv_bn(L):
    x = L.data("x", [3, 8, 8])
    c = L.conv2d(x, 4, 3, bias_attr=False)
    bn = L.batch_norm(c, is_test=True)
    return ["x"], [L.relu(bn)]


def _conv_chain(L):
    """The reference suite's layout-pass program (test_inference.py:198):
    conv + relu -> batch_norm -> max pool -> 1x1 conv with bias -> fc."""
    x = L.data("img", [3, 16, 16])
    c1 = L.conv2d(x, 8, 3, padding=1, act="relu")
    b1 = L.batch_norm(c1, is_test=True)
    p1 = L.pool2d(b1, 2, "max", 2)
    c2 = L.conv2d(p1, 4, 1)
    return ["img"], [L.fc(c2, 5, act="softmax")]


def _conv_bn_pool(L):
    """conv -> batch_norm -> avg pool (padded) -> conv -> batch_norm ->
    relu: two folds, then the layout pass over their bias adds."""
    x = L.data("img", [3, 12, 12])
    c1 = L.conv2d(x, 6, 3, padding=1, bias_attr=False)
    b1 = L.batch_norm(c1)
    p1 = L.pool2d(b1, 3, "avg", 2, pool_padding=1)
    c2 = L.conv2d(p1, 4, 3, bias_attr=False)
    return ["img"], [L.relu(L.batch_norm(c2))]


def _bn_stats(scope, prog):
    rng = np.random.RandomState(3)
    names = [v.name for v in prog.global_block.vars.values()]
    scope.set_var([n for n in names if "mean" in n][0],
                  rng.randn(4).astype("float32") * 0.1)
    scope.set_var([n for n in names if "variance" in n][0],
                  np.abs(rng.randn(4)).astype("float32") + 0.5)


def _bn_stats_all(scope, prog):
    """Non-trivial running stats for every batch_norm."""
    rng = np.random.RandomState(4)
    for op in prog.global_block.ops:
        if op.type == "batch_norm":
            c = prog.global_block.var(op.input("Mean")[0]).shape[0]
            scope.set_var(op.input("Mean")[0],
                          rng.randn(c).astype("float32") * 0.1)
            scope.set_var(op.input("Variance")[0],
                          np.abs(rng.randn(c)).astype("float32") + 0.5)
            scope.set_var(op.input("Scale")[0],
                          (rng.rand(c) + 0.5).astype("float32"))


B, T, M, H = 3, 5, 6, 4


def _rnns(L):
    """The reference suite's fc+rnn program (test_inference.py:235)."""
    d = L.data("x", [M], lod_level=1)
    proj = L.fc(d, 4 * H, num_flatten_dims=2)
    hidden, _ = L.dynamic_lstm(proj, 4 * H)
    gproj = L.fc(d, 3 * H, num_flatten_dims=2)
    ghidden = L.dynamic_gru(gproj, H)
    s = L.elementwise_add(L.sequence_pool(hidden, "sum"),
                          L.sequence_pool(ghidden, "sum"))
    return ["x"], [L.relu(s)]


def _rnn_feed():
    rng = np.random.RandomState(5)
    return {"x": rng.randn(B, T, M).astype("float32") * 0.4,
            "x@LEN": np.array([5, 2, 4], "int64")}


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_reference_model_dir_loads_in_the_port(tmp_path):
    d = str(tmp_path / "mlp")
    _ref_save(d, _mlp)
    (jp, js, jf), (tp, ts, tf) = _load_both(d)
    assert _norm(tp) == _norm(jp) and tf == jf
    _assert_same_persistables(jp, js, ts)
    assert all(str(ts.find_var(n).device) == "cpu"
               for n in ts.vars)


def test_port_model_dir_loads_in_the_reference(tmp_path):
    d = str(tmp_path / "mlp_port")
    prog, startup = TProgram(), TProgram()
    prog.random_seed = 3
    with t_guard(prog, startup), t_unique.guard():
        feeds, outs = _mlp(tfluid.layers)
    scope, exe = TScope(), TExecutor(tfluid.CPUPlace())
    with t_scope_guard(scope):
        exe.run(startup)
        names = tfluid.io.save_inference_model(d, feeds, outs, exe,
                                               main_program=prog)
    assert names == [outs[0].name]
    (jp, js, jf), (tp, ts, tf) = _load_both(d)
    assert _norm(jp) == _norm(tp) and jf == tf
    for n in ts.vars:
        np.testing.assert_array_equal(np.asarray(js.find_var(n)),
                                      _arr(scope.find_var(n)), err_msg=n)
    # save_persistables / load_persistables round trip, .npy per var too
    d2 = str(tmp_path / "vars")
    with t_scope_guard(scope):
        tfluid.io.save_vars(exe, d2, main_program=prog,
                            predicate=lambda v: v.persistable)
    fresh = TScope()
    with t_scope_guard(fresh):
        tfluid.io.load_vars(exe, d2, main_program=prog,
                            predicate=lambda v: v.persistable)
    for n in ts.vars:
        np.testing.assert_array_equal(_arr(fresh.find_var(n)),
                                      _arr(scope.find_var(n)), err_msg=n)


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------

PASS_CASES = {
    "is_test_mlp": (_mlp, None, ["apply_is_test"]),
    "fc_act_mlp": (_mlp, None, ["apply_is_test", "fuse_fc_act"]),
    "int8_mlp": (_mlp, None, ["apply_is_test", "fuse_fc_act",
                              "quantize_int8"]),
    "int8_act_attrs": (_mlp_leaky, None, ["fuse_fc_act", "quantize_int8"]),
    "int8_unfused": (_mlp, None, ["quantize_int8"]),
    "conv_bn": (_conv_bn, _bn_stats, ["apply_is_test", "fuse_conv_bn"]),
    "nhwc": (_conv_chain, None, ["apply_is_test", "convert_to_nhwc"]),
    "conv_bn_nhwc": (_conv_bn_pool, _bn_stats_all,
                     ["apply_is_test", "fuse_conv_bn", "convert_to_nhwc"]),
    "rnn_fusions": (_rnns, None, ["apply_is_test", "fuse_fc_lstm",
                                  "fuse_fc_gru", "fuse_elewise_add_act"]),
}


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_passes_match_the_reference(tmp_path, case):
    build, setup, names = PASS_CASES[case]
    d = str(tmp_path / case)
    _ref_save(d, build, setup=setup)
    (jp, js, jf), (tp, ts, tf) = _load_both(d)
    for name in names:
        if name == "apply_is_test":
            JP.apply_is_test(jp)
            TP.apply_is_test(tp)
            continue
        want = getattr(JP, name)(jp, js, keep_vars=jf)
        got = getattr(TP, name)(tp, ts, keep_vars=tf)
        assert got == want, name
    assert _norm(tp) == _norm(jp)
    _assert_same_persistables(jp, js, ts)
    if case == "int8_act_attrs":
        stamped = [op.type for op in tp.global_block.ops
                   if op.attrs.get("quant_int8")]
        assert stamped == ["fused_fc"]     # the leaky_relu one is left


def test_rnn_fusions_run_like_the_reference(tmp_path):
    """The fused program (fusion_lstm, fusion_gru,
    fused_elemwise_activation) gives the reference's output."""
    d = str(tmp_path / "rnn")
    _ref_save(d, _rnns)
    (jp, js, jf), (tp, ts, tf) = _load_both(d)
    for P, (p, s, f) in ((JP, (jp, js, jf)), (TP, (tp, ts, tf))):
        P.apply_is_test(p)
        for name in ("fuse_fc_lstm", "fuse_fc_gru", "fuse_elewise_add_act"):
            assert getattr(P, name)(p, s, keep_vars=f) == 1
    types = [op.type for op in tp.global_block.ops]
    assert {"fusion_lstm", "fusion_gru",
            "fused_elemwise_activation"} <= set(types)
    with j_scope_guard(js):
        (want,) = JExecutor().run(jp, feed=_rnn_feed(), fetch_list=jf)
    with t_scope_guard(ts):
        (got,) = TExecutor(tfluid.CPUPlace(), training=False).run(
            tp, feed=_rnn_feed(), fetch_list=tf)
    assert _rel(got, np.asarray(want)) <= F32_TOL


@pytest.mark.parametrize("build", [_conv_chain, _conv_bn_pool],
                         ids=["conv_chain", "conv_bn_pool"])
def test_conv_passes_run_like_the_reference(tmp_path, build):
    """``create_predictor`` with ``fuse_conv_bn`` (a default pass) and
    ``add_pass("convert_to_nhwc")``: the same folds and conversions as
    the reference's predictor, every conv/bn/pool op NHWC, and the
    port's CPU output equal to the reference's and to its own
    unpassed program's."""
    d = str(tmp_path / build.__name__)
    _ref_save(d, build, setup=_bn_stats_all)
    preds = []
    for Config, create in ((JConfig, j_create), (TConfig, t_create)):
        cfg = Config(d)
        cfg.add_pass("convert_to_nhwc")
        if Config is TConfig:
            cfg.disable_gpu()
        preds.append(create(cfg))
    jpred, tpred = preds
    assert _norm(tpred.program()) == _norm(jpred.program())
    ops = tpred.program().global_block.ops
    # conv_chain's conv has a bias add and a relu before its batch norm:
    # nothing folds there
    assert [op.type for op in ops].count("batch_norm") == (
        1 if build is _conv_chain else 0)
    assert all(op.attr("data_layout") == "NHWC" for op in ops
               if op.type in ("conv2d", "pool2d", "batch_norm"))
    plain = TConfig(d)
    plain.switch_ir_optim(False)
    plain.disable_gpu()
    feed = {"img": np.random.RandomState(5).randn(
        2, *jpred.program().global_block.var("img").shape[1:]).astype(
            "float32")}
    (want,) = jpred.run(feed)
    (got,) = tpred.run(feed)
    (unpassed,) = t_create(plain).run(feed)
    assert got.shape == np.asarray(want).shape
    assert _rel(got, np.asarray(want)) <= F32_TOL
    assert _rel(got, unpassed) <= F32_TOL


# ---------------------------------------------------------------------------
# the Predictor
# ---------------------------------------------------------------------------

def _predictors(d, int8):
    jc, tc = JConfig(d), TConfig(d)
    tc.disable_gpu()
    if int8:
        jc.enable_int8()
        tc.enable_int8()
        assert tc.int8_enabled()
    return j_create(jc), t_create(tc)


def _stamped_io(pred, feed, reference):
    """The stamped ops of ``pred``'s int8 program, with the input X and
    the output each took in ``pred``'s run on ``feed``."""
    ops = [op for op in pred.program().global_block.ops
           if op.attrs.get("quant_int8")]
    names = [op.inputs["X"][0] for op in ops] + \
        [op.outputs["Out"][0] for op in ops]
    if reference:
        with j_scope_guard(pred._scope):
            vals = JExecutor(training=False).run(
                pred.program(), feed=feed, fetch_list=names,
                scope=pred._scope)
    else:
        vals = pred._exe.run(pred.program(), feed=feed, fetch_list=names,
                             scope=pred._scope)
    vals = [np.asarray(v) for v in vals]
    return ops, vals[:len(ops)], vals[len(ops):]


def _replay_stamped_ops(tpred, ops, xs, outs):
    """Every stamped op of the reference's int8 run, replayed by the
    port: ``int8_fc_plain`` with the port's weights on the very input
    the reference gave the op, within REPLAY_TOL of max|ref| of the
    reference kernel's output (it fuses the epilogue's multiply-add).
    Returns the number of ops replayed."""
    for op, x, out in zip(ops, xs, outs):
        xnc = int(op.attrs.get("x_num_col_dims", 1))
        xm = torch.from_numpy(x.reshape(int(np.prod(x.shape[:xnc])), -1))
        sc = tpred._scope
        bias = (sc.find_var(op.inputs["Bias"][0]).reshape(-1)
                if op.type == "fused_fc" else None)
        act = (op.attrs.get("act", "") or "") if op.type == "fused_fc" \
            else ""
        got = TQ.int8_fc_plain(xm, sc.find_var(op.inputs["WInt8"][0]),
                               sc.find_var(op.inputs["WScale"][0]),
                               float(op.attrs.get("in_scale", 0.0)), bias,
                               act).numpy()
        assert _rel(got, out.reshape(got.shape)) <= REPLAY_TOL, \
            op.outputs["Out"][0]
    return len(ops)


def _check_first_flip(ops, xs_want, xs_got):
    """Each stamped op's activation, quantized as K5's launch quantizes
    it, on both sides in program order: equal codes up to the first op
    where a code differs, and there at most FLIP_FRAC of the codes
    differ, each by one.  Returns the flipped codes per op."""
    flips = []
    for op, a, b in zip(ops, xs_want, xs_got):
        s = float(op.attrs.get("in_scale", 0.0))
        d = (TQ._quantize_act(torch.from_numpy(a), s)[0].int()
             - TQ._quantize_act(torch.from_numpy(b), s)[0].int())
        n = int((d != 0).sum())
        if n and not any(flips):
            assert int(d.abs().max()) == 1 and n <= FLIP_FRAC * d.numel(), \
                (op.outputs["Out"][0], n, int(d.abs().max()), d.numel())
        flips.append(n)
    return flips


def _rms_rel(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def _check_predictors(d, feeds, int8, deep=False):
    """The port's predictor against the reference's on ``feeds``.  In
    int8, outputs within REPLAY_TOL of max|ref|, or for a ``deep`` model
    (where the first code flip moves later ops' codes) within sqrt(2) x
    the reference's int8 error."""
    jpred, tpred = _predictors(d, int8)
    assert _norm(tpred.program()) == _norm(jpred.program())
    stamped = [op for op in tpred.program().global_block.ops
               if op.attrs.get("quant_int8")]
    assert bool(stamped) == int8
    for op in stamped:
        for slot in ("WInt8", "WScale"):
            n = op.inputs[slot][0]
            np.testing.assert_array_equal(
                _arr(tpred._scope.find_var(n)),
                np.asarray(jpred._scope.find_var(n)), err_msg=n)
    f32_ref = _predictors(d, False)[0] if deep else None
    for feed in feeds:
        want = [np.asarray(a) for a in jpred.run(feed)]
        got = tpred.run(feed)
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.all(np.isfinite(g))
            if not int8:
                assert _rel(g, w) <= F32_TOL
                np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
        if not int8:
            continue
        ops, xs, outs = _stamped_io(jpred, feed, reference=True)
        assert _replay_stamped_ops(tpred, ops, xs, outs) == len(stamped)
        flips = _check_first_flip(ops, xs,
                                  _stamped_io(tpred, feed, False)[1])
        if deep:
            (f32,) = [np.asarray(a) for a in f32_ref.run(feed)]
            assert _rms_rel(got[0], want[0]) <= \
                np.sqrt(2.0) * _rms_rel(want[0], f32)
        else:
            assert not any(flips)
            assert _rel(got[0], want[0]) <= REPLAY_TOL
    return jpred, tpred


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_predictor_mlp_matches_reference(tmp_path, int8):
    d = str(tmp_path / "mlp")
    _ref_save(d, _mlp)
    rng = np.random.RandomState(7)
    feeds = [{"x": rng.randn(n, 8).astype("float32")} for n in (1, 5, 32)]
    _, tpred = _check_predictors(d, feeds, int8)
    ops = [op.type for op in tpred.program().global_block.ops]
    assert ops == ["fused_fc", "fused_fc"]


def _save_qat(d):
    """The reference suite's QAT model (test_quant_serving.py:136):
    built, trained 8 steps and frozen by the reference."""
    from paddle_tpu.contrib.quantize import QuantizeTranspiler

    L = jfluid.layers
    rng = np.random.RandomState(11)
    prog, startup = JProgram(), JProgram()
    prog.random_seed = 4
    with j_guard(prog, startup), j_unique.guard():
        x = L.data("x", [8])
        label = L.data("label", [1], dtype="int64")
        h = L.fc(x, 16, act="relu")
        pred = L.fc(h, 4)
        loss = L.mean(L.cross_entropy(L.softmax(pred), label))
        t = QuantizeTranspiler(
            activation_quantize_type="moving_average_abs_max")
        t.training_transpile(prog, startup)
        jfluid.optimizer.SGD(0.05).minimize(loss)
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(startup)
        for _ in range(8):
            exe.run(prog, feed={
                "x": rng.randn(16, 8).astype("float32"),
                "label": rng.randint(0, 4, (16, 1)).astype("int64")},
                fetch_list=[loss])
        infer = prog.clone().prune([pred.name])
        t.freeze_program(infer)
        jfluid.io.save_inference_model(d, ["x"], [pred], exe,
                                       main_program=infer)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_predictor_qat_model_matches_reference(tmp_path, int8):
    """f32 runs the fake-quant ops in the graph; int8 folds them and
    harvests the moving-average scale as a static activation scale."""
    d = str(tmp_path / "qat")
    _save_qat(d)
    rng = np.random.RandomState(12)
    feeds = [{"x": rng.randn(32, 8).astype("float32")} for _ in range(2)]
    _, tpred = _check_predictors(d, feeds, int8)
    ops = tpred.program().global_block.ops
    if int8:
        assert not any(op.type.startswith("fake_") for op in ops)
        stamped = [op for op in ops if op.attrs.get("quant_int8")]
        assert len(stamped) == 2
        assert any(float(op.attrs["in_scale"]) > 0.0 for op in stamped)
    else:
        assert any(op.type.startswith("fake_") for op in ops)


TT, TV = 16, 2000


def _transformer(L):
    from paddle_tpu.models.transformer import transformer
    src = L.data("src_ids", [TT], dtype="int64")
    tgt = L.data("tgt_ids", [TT], dtype="int64")
    sm = L.data("src_mask", [TT])
    tm = L.data("tgt_mask", [TT])
    logits = transformer(src, tgt, sm, tm, src_vocab=TV, tgt_vocab=TV,
                         max_len=TT, d_model=512, n_head=8, d_ffn=2048,
                         n_layer=2, dropout=0.1, attention_impl="base")
    return ["src_ids", "tgt_ids", "src_mask", "tgt_mask"], [logits]


def _transformer_feed(rng, rows):
    lens = rng.randint(4, TT + 1, (rows, 2))
    pos = np.arange(TT)[None, :]
    return {"src_ids": rng.randint(0, TV, (rows, TT)).astype("int64"),
            "tgt_ids": rng.randint(0, TV, (rows, TT)).astype("int64"),
            "src_mask": (pos < lens[:, :1]).astype("float32"),
            "tgt_mask": (pos < lens[:, 1:]).astype("float32")}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_predictor_transformer_matches_reference(tmp_path, int8):
    """2 + 2 layers at full width: in int8, 4 x 2 + 8 x 2 projections,
    2 x 2 + 2 x 2 FFN fused_fc and the output projection are stamped
    (33 of the 97 at 6 + 6 layers)."""
    d = str(tmp_path / "tfm")
    _ref_save(d, _transformer, seed=5)
    rng = np.random.RandomState(13)
    _, tpred = _check_predictors(d, [_transformer_feed(rng, 2)], int8,
                                 deep=True)
    ops = tpred.program().global_block.ops
    assert not any(op.type == "dropout" and not op.attrs.get("is_test")
                   for op in ops)
    stamped = [op.type for op in ops if op.attrs.get("quant_int8")]
    if int8:
        assert stamped.count("mul") == 4 * 2 + 8 * 2 + 1
        assert stamped.count("fused_fc") == 2 * 2 + 2 * 2


def _transformer_6x6_narrow(L):
    """The serving Transformer's program at 6 + 6 layers, narrow widths
    (the stamped ops depend on the depth, not the widths)."""
    from paddle_tpu.models.transformer import transformer
    names = ["src_ids", "tgt_ids", "src_mask", "tgt_mask"]
    src, tgt = (L.data(n, [8], dtype="int64") for n in names[:2])
    sm, tm = (L.data(n, [8]) for n in names[2:])
    return names, [transformer(src, tgt, sm, tm, src_vocab=40, tgt_vocab=40,
                               max_len=8, d_model=16, n_head=2, d_ffn=32,
                               n_layer=6, dropout=0.1)]


def test_int8_pass_stamps_97_ops_of_the_6_plus_6_transformer(tmp_path):
    """The count the card's serving phase gates on (97 K5 launches a
    dispatch), taken from the reference's own passes on the same
    program: 6 x 4 encoder and 6 x 8 decoder projections, 12 x 2 FFN
    fused_fc, the output projection; the port stamps the same ops."""
    d = str(tmp_path / "tfm6")
    _ref_save(d, _transformer_6x6_narrow, seed=5)
    (jp, js, jf), (tp, ts, tf) = _load_both(d)
    for P, (p, sc, f) in ((JP, (jp, js, jf)), (TP, (tp, ts, tf))):
        P.apply_is_test(p)
        P.fuse_fc_act(p, sc, keep_vars=f)
        P.quantize_int8(p, sc, keep_vars=f)
    assert _norm(tp) == _norm(jp)
    stamped = [op.type for op in jp.global_block.ops
               if op.attrs.get("quant_int8")]
    assert len(stamped) == 97
    assert stamped.count("mul") == 6 * 4 + 6 * 8 + 1
    assert stamped.count("fused_fc") == 12 * 2


def test_flag_int8_inference_stamps_like_enable_int8(tmp_path):
    d = str(tmp_path / "mlp")
    _ref_save(d, _mlp)
    saved = tflags.get_flags("int8_inference")
    tflags.set_flags({"int8_inference": True})
    try:
        cfg = TConfig(d)
        cfg.disable_gpu()
        pred = t_create(cfg)
    finally:
        tflags.set_flags({"int8_inference": saved})
    assert cfg.int8_enabled()
    cfg2 = TConfig(d)
    cfg2.disable_gpu()
    cfg2.enable_int8()
    explicit = t_create(cfg2)
    assert _norm(pred.program()) == _norm(explicit.program())
    xv = np.random.RandomState(8).randn(4, 8).astype("float32")
    np.testing.assert_array_equal(pred.run({"x": xv})[0],
                                  explicit.run({"x": xv})[0])


def test_inference_executor_lowers_training_false():
    """Executor(training=False) lowers dropout in its test branch with no
    is_test attr: downgrade_in_infer gives x * (1 - p), as the
    reference's (tests/test_inference.py:285)."""
    xv = np.ones((4, 32), "float32")
    outs = []
    for pkg, exe, guard, prog_cls, pg, uq, scope in (
            (jfluid, JExecutor(training=False), j_scope_guard, JProgram,
             j_guard, j_unique, JScope()),
            (tfluid, TExecutor(tfluid.CPUPlace(), training=False),
             t_scope_guard, TProgram, t_guard, t_unique, TScope())):
        prog, startup = prog_cls(), prog_cls()
        prog.random_seed = 9
        with pg(prog, startup), uq.guard():
            x = pkg.layers.data("x", [32])
            out = pkg.layers.dropout(x, dropout_prob=0.5)
        with guard(scope):
            (o,) = exe.run(prog, feed={"x": xv}, fetch_list=[out])
        outs.append(np.asarray(o))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[1], xv * 0.5, rtol=1e-6)


def test_predictor_clone_shares_weights_and_warm_start(tmp_path):
    d = str(tmp_path / "mlp")
    _ref_save(d, _mlp)
    cfg = TConfig(d)
    cfg.disable_gpu()
    pred = t_create(cfg)
    twin = pred.clone()
    assert twin._scope is pred._scope and twin._exe is not pred._exe
    xv = np.random.RandomState(9).randn(3, 8).astype("float32")
    np.testing.assert_array_equal(pred.run([xv])[0], twin.run({"x": xv})[0])
    info = pred.warm_start([pred.feed_specs_for_batch(b) for b in (1, 8)])
    assert info["segments"] == 2 and info["warmed"] == 2
    assert info["compiled"] == 0 and info["skipped"] == []
    assert pred.feed_specs_for_batch(4) == {"x": ((4, 8), "float32")}
    with pytest.raises(ValueError, match="missing feeds"):
        pred.run({})
