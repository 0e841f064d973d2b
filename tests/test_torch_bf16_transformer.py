"""The bench's Transformer configuration (``dtype="bfloat16"``, as
``bench.py``'s ``bench_transformer`` builds it) at 2 layers, trained
through Program -> append_backward -> Executor.run: the port against
the JAX reference from the same copied starting values, at
``attention_impl`` "pallas" and "xla".

The program keeps its weights and embeddings in bfloat16.  Its first
elementwise add promotes the bfloat16 embedding with the float32
positional table, so every activation after it is float32 and every
FC a product of a float32 activation and a bfloat16 weight, promoted
as jnp promotes it; the attention inputs are float32.

The reference runs with XLA's ``xla_allow_excess_precision`` off.  By
default XLA's CPU compiler keeps a bfloat16 value that feeds another
operation in float32 inside a fusion (the embedding's ``scale`` before
the positional add, for one), so the reference does not compute the
roundings its program declares; the port does, and the two then differ
by up to 5% of max|grad| after one step.  With the option off the
reference rounds where the program says, and the port agrees with it
as below.

Dropout is 0, so the steps are deterministic.  Tolerances: the
first-step loss within 1e-5 relative; every bfloat16 gradient within
2^-7 * max|ref| (one bfloat16 rounding of the largest value; the
gradients of the two frameworks are summed in other orders before
that rounding), every float32 one at the float32 test's GRAD_TOL;
after 3 Adam steps on the noam schedule the losses within 1e-5
relative, the float32 parameters within 1e-6 absolute and the
bfloat16 ones within 2^-7 * max|ref|.
"""
import functools

import jax
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
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import attention as TA
from paddle_tpu_torch.models import transformer as t_transformer

SMALL = dict(src_vocab=50, tgt_vocab=50, max_len=16, d_model=32, n_head=4,
             d_ffn=64, n_layer=2, dropout=0.0, dtype="bfloat16")
B, T, STEPS = 4, 16, 3
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
BF16_REL = 2.0 ** -7


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


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _reference(impl):
    main, startup, loss, params, persist = _build(
        JProgram, j_guard, j_unique, j_transformer, impl)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    exe, scope = JExecutor(), JScope()
    no_excess = functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False})
    with pytest.MonkeyPatch.context() as mp, j_scope_guard(scope):
        mp.setattr(jax, "jit", no_excess)
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
    launches = TA.flash_attention_fwd.launches
    with tfluid.scope_guard(scope):
        steps = [exe.run(main, feed=_feed(), fetch_list=fetch)
                 for _ in range(STEPS)]
    assert TA.flash_attention_fwd.launches == launches   # CPU: plain path
    dtypes = {n: scope.find_var(n).dtype for n in params}
    return dict(params=params, steps=steps, dtypes=dtypes,
                final=scope.to_numpy(params))


@pytest.fixture(scope="module", params=["pallas", "xla"])
def runs(request):
    ref = _reference(request.param)
    return ref, _port(request.param, ref["init"])


def _close(name, got, ref, bf16, f32_tol):
    got, ref = _f32(got), _f32(ref)
    if bf16:
        err = np.abs(got - ref).max()
        assert err <= BF16_REL * np.abs(ref).max(), (name, err)
    else:
        np.testing.assert_allclose(got, ref, err_msg=name, **f32_tol)


def test_program_keeps_bf16_weights_and_f32_activations(runs):
    ref, got = runs
    bf16 = [n for n, d in got["dtypes"].items() if d == torch.bfloat16]
    f32 = [n for n, d in got["dtypes"].items() if d == torch.float32]
    assert any(n.endswith(".w") for n in bf16) and "src.word_emb" in bf16
    assert f32 and all(".ln." in n for n in f32)
    assert all(str(ref["init"][n].dtype) == "bfloat16" for n in bf16)


def test_first_step_gradients_match(runs):
    ref, got = runs
    assert got["params"] == ref["params"]
    np.testing.assert_allclose(got["steps"][0][0], ref["steps"][0][0],
                               rtol=1e-5)
    for name, a, b in zip(ref["params"], got["steps"][0][1:],
                          ref["steps"][0][1:]):
        _close(name, a, b, got["dtypes"][name] == torch.bfloat16, GRAD_TOL)


def test_three_adam_noam_steps_match(runs):
    ref, got = runs
    np.testing.assert_allclose([s[0] for s in got["steps"]],
                               [s[0] for s in ref["steps"]], rtol=1e-5)
    for name in ref["params"]:
        bf16 = got["dtypes"][name] == torch.bfloat16
        _close(name, got["final"][name], ref["final"][name], bf16,
               dict(atol=1e-6, rtol=0))
        if not bf16:   # a bfloat16 weight may keep its value at lr ~1e-6
            assert not np.array_equal(got["final"][name],
                                      ref["init"][name]), name
