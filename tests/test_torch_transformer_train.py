"""Training the small Transformer through Program → append_backward →
Executor.run: the port against the JAX reference from the same copied
starting values, with ``attention_impl`` "pallas" (the reference's
flash kernels in interpret mode; the port's plain K1–K3 on the CPU)
and "xla" (the plain attention chain on both sides).

Both run dropout 0, so the steps are deterministic.  Tolerances: every
gradient within 1e-4 relative and 2e-6 absolute after one step (float32
in two frameworks, different summation orders); after 3 Adam steps on
the noam schedule (learning rate ~1e-6 at these steps) the parameters
within 1e-6 absolute and the losses within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import attention as TA
from paddle_tpu_torch.models import transformer as t_transformer

SMALL = dict(src_vocab=50, tgt_vocab=50, max_len=16, d_model=32, n_head=4,
             d_ffn=64, n_layer=2, dropout=0.0)
B, T, STEPS = 4, 16, 3
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


def _feed():
    rs = np.random.RandomState(0)
    m = np.zeros((B, T), "float32")
    for b in range(B):
        m[b, : rs.randint(3, T + 1)] = 1
    return {"src_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "tgt_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "lbl_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "src_mask": m, "tgt_mask": m}


def _build(Program, guard, unique, module, impl):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 3
    with guard(main, startup), unique.guard():
        _, loss, _ = module.build(**SMALL, attention_impl=impl)
    params = sorted(p.name for p in main.all_parameters())
    persist = [v.name for v in startup.global_block.vars.values()
               if v.persistable]
    return main, startup, loss, params, persist


def _reference(impl):
    main, startup, loss, params, persist = _build(
        JProgram, j_guard, j_unique, j_transformer, impl)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n)) for n in persist}
        steps = [[np.array(x) for x in
                  exe.run(main, feed=_feed(), fetch_list=fetch, sync=True)]
                 for _ in range(STEPS)]
        final = {n: np.array(scope.find_var(n)) for n in params}
    return dict(init=init, params=params, steps=steps, final=final)


def _port(impl, init):
    main, startup, loss, params, _ = _build(
        TProgram, t_guard, t_unique, t_transformer, impl)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    scope.load_numpy(init, device="cpu")
    recomputes = t_lowering.grad_recomputes
    launches = TA.flash_attention_fwd.launches
    with tfluid.scope_guard(scope):
        steps = [exe.run(main, feed=_feed(), fetch_list=fetch)
                 for _ in range(STEPS)]
    assert t_lowering.grad_recomputes == recomputes
    assert TA.flash_attention_fwd.launches == launches   # CPU: plain path
    return dict(params=params, steps=steps,
                final=scope.to_numpy(params))


@pytest.fixture(scope="module", params=["pallas", "xla"])
def runs(request):
    ref = _reference(request.param)
    return ref, _port(request.param, ref["init"])


def test_first_step_gradients_match(runs):
    ref, got = runs
    assert got["params"] == ref["params"]
    np.testing.assert_allclose(got["steps"][0][0], ref["steps"][0][0],
                               rtol=1e-5)
    for name, a, b in zip(ref["params"], got["steps"][0][1:],
                          ref["steps"][0][1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_three_adam_noam_steps_match(runs):
    ref, got = runs
    np.testing.assert_allclose([s[0] for s in got["steps"]],
                               [s[0] for s in ref["steps"]], rtol=1e-5)
    for name in ref["params"]:
        np.testing.assert_allclose(got["final"][name], ref["final"][name],
                                   atol=1e-6, rtol=0, err_msg=name)
        assert not np.array_equal(got["final"][name], ref["init"][name]), \
            name


def _dropout_program(p):
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        x = tfluid.layers.data("x", [4096], stop_gradient=False)
        y = tfluid.layers.dropout(
            x, p, dropout_implementation="upscale_in_train")
        loss = tfluid.layers.reduce_sum(y)
        tfluid.append_backward(loss)
    mask = [op for op in main.global_block.ops
            if op.type == "dropout"][0].output("Mask")[0]
    return main, x, y, mask


def test_dropout_keeps_scales_and_grad_reuses_mask():
    p = 0.3
    main, x, y, mask = _dropout_program(p)
    xv = np.random.RandomState(2).rand(8, 4096).astype("float32") + 0.5
    exe = tfluid.Executor("cpu")
    with tfluid.scope_guard(tfluid.Scope()):
        out, m, gx = exe.run(main, feed={"x": xv},
                             fetch_list=[y, mask, x.name + "@GRAD"])
    kept = m != 0
    assert abs(kept.mean() - (1 - p)) < 0.01
    np.testing.assert_allclose(m[kept], 1.0 / (1 - p), rtol=1e-6)
    np.testing.assert_allclose(out, xv * m, rtol=1e-6)
    np.testing.assert_array_equal(gx, m)     # d sum(x * mask) / dx = mask
    assert torch.is_grad_enabled()
