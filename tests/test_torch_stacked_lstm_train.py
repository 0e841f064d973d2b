"""Training the small stacked LSTM through ``layers.data(lod_level=1)`` →
``layers.*`` → ``Adam.minimize`` → ``Executor.run``: the port against
the JAX reference from the same copied starting values.

Three layers, so the middle one runs ``is_reverse``; ragged
``words@LEN`` with a length-1 row.  The reference runs its lstm op as
on any CPU (the XLA scan and its vjp); the port runs the plain K6/K7
versions through the op's explicit grad rule, so no grad op re-runs its
forward.  Tolerances: every gradient within 1e-4 relative and 2e-6
absolute after one step, as the Transformer's (float32 through three
recurrences and a max pool in two frameworks); after 3 Adam steps the
parameters within 1e-6 absolute (lr 0.002) and the losses within 1e-5
relative.
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
from paddle_tpu.models import stacked_lstm as j_stacked_lstm
from paddle_tpu_torch.core import lowering as t_lowering
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.core.program import Program as TProgram
from paddle_tpu_torch.core.program import program_guard as t_guard
from paddle_tpu_torch.kernels import rnn as TR
from paddle_tpu_torch.models import stacked_lstm as t_stacked_lstm

SMALL = dict(dict_dim=50, emb_dim=16, hid_dim=16, stacked_num=3)
B, T, STEPS = 4, 7, 3
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


def _feed():
    rs = np.random.RandomState(0)
    return {"words": rs.randint(0, SMALL["dict_dim"], (B, T, 1)).astype(
                "int64"),
            "words@LEN": np.array([7, 3, 1, 5], "int64"),
            "label": rs.randint(0, 2, (B, 1)).astype("int64")}


def _build(Program, guard, unique, module):
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 5
    with guard(main, startup), unique.guard():
        _, loss, acc = module.build(**SMALL)
    params = sorted(p.name for p in main.all_parameters())
    persist = [v.name for v in startup.global_block.vars.values()
               if v.persistable]
    return main, startup, loss, acc, params, persist


def _reference():
    main, startup, loss, acc, params, persist = _build(
        JProgram, j_guard, j_unique, j_stacked_lstm)
    fetch = [loss.name, acc.name] + [p + "@GRAD" for p in params]
    exe, scope = JExecutor(), JScope()
    with j_scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.find_var(n)) for n in persist}
        steps = [[np.array(x) for x in
                  exe.run(main, feed=_feed(), fetch_list=fetch, sync=True)]
                 for _ in range(STEPS)]
        final = {n: np.array(scope.find_var(n)) for n in params}
    return dict(init=init, params=params, steps=steps, final=final,
                program=(main.serialize(), startup.serialize()))


def _port(init):
    main, startup, loss, acc, params, _ = _build(
        TProgram, t_guard, t_unique, t_stacked_lstm)
    fetch = [loss.name, acc.name] + [p + "@GRAD" for p in params]
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    scope.load_numpy(init, device="cpu")
    counts = (t_lowering.grad_recomputes, TR.lstm_fused.launches,
              TR.lstm_fused_grad.launches)
    with tfluid.scope_guard(scope):
        steps = [exe.run(main, feed=_feed(), fetch_list=fetch)
                 for _ in range(STEPS)]
    # no forward re-run; the CPU takes the plain versions, not K6/K7
    assert (t_lowering.grad_recomputes, TR.lstm_fused.launches,
            TR.lstm_fused_grad.launches) == counts
    return dict(params=params, steps=steps, final=scope.to_numpy(params),
                program=(main.serialize(), startup.serialize()),
                types=[op.type for op in main.global_block.ops])


@pytest.fixture(scope="module")
def runs():
    ref = _reference()
    return ref, _port(ref["init"])


def test_same_program(runs):
    """The port's layers (dynamic_lstm, sequence_pool, fc over a list
    with act="softmax", cross_entropy, accuracy) build the reference's
    programs byte for byte."""
    ref, got = runs
    assert got["program"] == ref["program"]
    assert got["types"].count("lstm") == 3
    assert got["types"].count("lstm_grad") == 3
    assert got["params"] == ref["params"]


def test_first_step_loss_and_gradients_match(runs):
    ref, got = runs
    np.testing.assert_allclose(got["steps"][0][0], ref["steps"][0][0],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["steps"][0][1], ref["steps"][0][1])
    for name, a, b in zip(ref["params"], got["steps"][0][2:],
                          ref["steps"][0][2:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_three_adam_steps_match(runs):
    ref, got = runs
    np.testing.assert_allclose([s[0] for s in got["steps"]],
                               [s[0] for s in ref["steps"]], rtol=1e-5)
    for name in ref["params"]:
        np.testing.assert_allclose(got["final"][name], ref["final"][name],
                                   atol=1e-6, rtol=0, err_msg=name)
        assert not np.array_equal(got["final"][name], ref["init"][name]), \
            name
