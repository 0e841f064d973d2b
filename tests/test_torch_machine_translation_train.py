"""Training attention seq2seq (machine translation) through
``layers.*`` → ``Adam.minimize`` → ``Executor.run``: the port against
the JAX reference from the same copied starting values.

A small configuration (vocab 50, emb = hid = 32, T = 8, B = 4) with
ragged source and target masks (one source row of length 1).  The
encoder is two ``gru`` ops (one reversed); the teacher-forced decoder a
``static_rnn`` sub-block of 33 ops a step, whose gradient reaches the
``dec.*`` parameters only through ``static_rnn_grad``.  The reference
runs its gru as on any CPU (the XLA scan and its vjp) and its
sub-block through ``jax.vjp``; the port runs the plain K8a/K8b versions
through the gru op's explicit grad and the sub-block under one autograd
tape, so no grad op re-runs its forward.  Tolerances: the first step's
loss within 1e-5 relative and every gradient within 1e-3 of its largest
entry; after 3 Adam steps every parameter and moment within rtol 1e-5 /
atol 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu.core.executor import Executor as JExecutor
from paddle_tpu.core.executor import Scope as JScope
from paddle_tpu.core.executor import scope_guard as j_scope_guard
from paddle_tpu.core.program import Program as JProgram
from paddle_tpu.core.program import program_guard as j_guard
from paddle_tpu.models import machine_translation as j_mt
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import rnn as TR
from paddle_tpu_torch.models import machine_translation as t_mt

SMALL = dict(src_vocab=50, tgt_vocab=50, emb_dim=32, hid=32, max_len=8)
B, T, STEPS = 4, 8, 3
GRAD_REL = 1e-3
STATE_TOL = dict(rtol=1e-5, atol=1e-6)


def _feed():
    rs = np.random.RandomState(0)
    src_len, tgt_len = np.array([8, 5, 1, 3]), np.array([7, 8, 2, 4])
    t = np.arange(T)[None, :]
    return {"src_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "src_mask": (t < src_len[:, None]).astype("float32"),
            "tgt_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "lbl_ids": rs.randint(0, 50, (B, T)).astype("int64"),
            "tgt_mask": (t < tgt_len[:, None]).astype("float32")}


def _build(Program, guard, unique, module):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 5
    with guard(main, startup), unique.guard():
        _, loss = module.build(**SMALL)
    params = sorted(p.name for p in main.all_parameters())
    persist = sorted(v.name for v in startup.global_block.vars.values()
                     if v.persistable)
    return main, startup, loss, params, persist


def _reference():
    main, startup, loss, params, persist = _build(JProgram, j_guard,
                                                  j_unique, j_mt)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n)) for n in persist}
        steps = [[np.array(x) for x in
                  exe.run(main, feed=_feed(), fetch_list=fetch, sync=True)]
                 for _ in range(STEPS)]
        final = {n: np.array(scope.find_var(n)) for n in persist}
    return dict(init=init, params=params, persist=persist, steps=steps,
                final=final, program=(main.serialize(), startup.serialize()))


def _port(init):
    main, startup, loss, params, persist = _build(TProgram, t_guard,
                                                  t_unique, t_mt)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    scope.load_numpy(init, device="cpu")
    counts = (t_lowering.grad_recomputes, TR.gru_fused.launches,
              TR.gru_fused_grad.launches)
    with tfluid.scope_guard(scope):
        steps = [exe.run(main, feed=_feed(), fetch_list=fetch)
                 for _ in range(STEPS)]
    # no forward re-run; the CPU takes the plain versions, not K8a/K8b
    assert (t_lowering.grad_recomputes, TR.gru_fused.launches,
            TR.gru_fused_grad.launches) == counts
    return dict(params=params, persist=persist, steps=steps,
                final=scope.to_numpy(persist),
                program=(main.serialize(), startup.serialize()),
                blocks=[[op.type for op in b.ops] for b in main.blocks])


@pytest.fixture(scope="module")
def runs():
    ref = _reference()
    return ref, _port(ref["init"])


def test_same_program(runs):
    """The port's layers (embedding, fc, dynamic_gru, concat,
    sequence_last_step, StaticRNN with matmul/softmax attention, slice,
    sigmoid, tanh, fill_constant_batch_size_like, softmax_with_cross_
    entropy) build the reference's programs byte for byte, and a
    deserialized program serializes to the same bytes."""
    ref, got = runs
    assert got["program"] == ref["program"]
    for data in ref["program"]:
        assert TProgram.deserialize(data).serialize() == data
    top, step = got["blocks"]
    assert top.count("gru") == 2 and top.count("gru_grad") == 2
    assert top.count("static_rnn") == 1 and top.count("static_rnn_grad") == 1
    assert len(step) == 33
    assert got["params"] == ref["params"]


def test_first_step_loss_and_gradients_match(runs):
    ref, got = runs
    np.testing.assert_allclose(got["steps"][0][0], ref["steps"][0][0],
                               rtol=1e-5)
    for name, a, b in zip(ref["params"], got["steps"][0][1:],
                          ref["steps"][0][1:]):
        scale = np.abs(b).max()
        assert scale > 0, name        # dec.* reached through static_rnn_grad
        assert np.abs(a - b).max() <= GRAD_REL * scale, name


def test_three_adam_steps_match(runs):
    ref, got = runs
    np.testing.assert_allclose([s[0] for s in got["steps"]],
                               [s[0] for s in ref["steps"]], rtol=1e-5)
    assert got["persist"] == ref["persist"]
    for name in ref["persist"]:
        np.testing.assert_allclose(got["final"][name], ref["final"][name],
                                   err_msg=name, **STATE_TOL)
    for name in ref["params"]:
        assert not np.array_equal(got["final"][name], ref["init"][name]), \
            name


def test_infer_program_shares_training_params(runs):
    """mode="infer" builds the beam-search program, whose every
    parameter is one of the training program's, so a training
    checkpoint fills it (tests/test_torch_machine_translation_infer.py
    decodes one)."""
    ref, got = runs
    main, startup = TProgram(), TProgram()
    with t_guard(main, startup), t_unique.guard():
        t_mt.build(mode="infer", **SMALL)
    infer_params = sorted(p.name for p in main.all_parameters())
    assert infer_params and set(infer_params) <= set(got["params"])
    assert "while" in [op.type for op in main.global_block.ops]
