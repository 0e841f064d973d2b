"""Executor: runs Programs, and the callable dispatch of the decode plane.

The port of ``paddle_tpu/core/executor.py``.

``Executor.run(program, feed, fetch_list, scope)`` runs block 0 of a
Program with the reference's semantics: feeds are moved to the
executor's device in their declared dtypes, every other variable an op
reads comes from the scope (a missing one raises, asking for the
startup program), the block runs op by op through the registry
(``core/lowering.py``), persistable variables the block writes go back
to the scope, and the fetches come back as numpy arrays (a fetched
``SelectedRows`` gradient as itself).  A persistable that already holds
a tensor of the same shape, dtype and device is written IN PLACE
(``copy_``, skipped when a rule already updated that very storage), as
``run_callable`` updates its state; the reference instead donates the
old buffer to XLA and stores the new one.
The plan (dataflow analysis and grad pairing) is cached per program
version, feed names and fetch names; constants the rules make on the
device (literal tables, optimizer scalars) are cached per executor.
``Executor(training=False)`` is the Predictor's inference executor, and
``warm_start`` builds the plans a serving bucket ladder will use (there
is no compile cache to fill).  Two hooks, as in the reference, let
``parallel.ParallelExecutor`` rewrite the program a run executes
(``_prepare_program``) and hand its device mesh to the rules
(``_mesh``, read by ``fused_attention impl="ring"``).  The reference's
jit cache, segmented host ops, numerics guard, compile cache,
``LazyFetch`` and ``run_steps`` are not ported yet.

``run_callable(key, build_fn, feed, state, const)`` builds
``build_fn()`` once per key, moves the host feeds to the executor's
device, and runs the built function under ``torch.inference_mode()``.
Calls and builds are counted as ``executor.steps`` /
``executor.cache_misses`` / ``executor.cache_hits`` in the port's
stats registry, like the reference's.  ``state`` is updated IN PLACE
by the function: it stands in for XLA buffer donation.  The same state
tensors come back, so a caller written against the reference
(``outs, new_state = ...``) keeps working, and the paged KV cache never
leaves the device or is copied.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..observability import stats as _obs_stats
from ..platform import get_device
from .lowering import analyze_block, lower_ops
from .program import Program, Variable, default_main_program
from .registry import LowerContext
from .selected_rows import SelectedRows
from .types import BFLOAT16_NP, normalize_dtype, np_dtype

RNG_STATE_VAR = "@RNG_STATE@"


class Scope:
    """Name → value map with parent fallback (scope.h:41).  Values are
    torch tensors on the device of the executor that wrote them."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict[str, object] = {}
        self.parent = parent

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def set_var(self, name: str, value) -> None:
        self.vars[name] = value

    def load_numpy(self, arrays: Dict[str, np.ndarray],
                   device: Optional[Union[str, torch.device]] = None
                   ) -> None:
        """Put host arrays into this scope as tensors on ``device``
        (``cuda:0`` by default), copied, never regenerated: how a run
        starts from another run's (or the JAX reference's) values."""
        dev = get_device(device)
        for name, arr in arrays.items():
            self.vars[name] = tensor_from_numpy(np.array(arr, copy=True),
                                                device=dev)

    def to_numpy(self, names: Optional[Sequence[str]] = None
                 ) -> Dict[str, np.ndarray]:
        """Host copies of the named tensors (every local tensor when
        ``names`` is None)."""
        names = [n for n, v in self.vars.items()
                 if isinstance(v, torch.Tensor)] if names is None else names
        return {n: _to_numpy(self.find_var(n)) for n in names}


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    saved = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = saved


def _is_bf16_bits(arr: np.ndarray) -> bool:
    """An array of bfloat16 values: ``ml_dtypes.bfloat16``, or the
    2-byte raw records (``|V2``) that ``np.save`` writes for it and
    ``np.load`` gives back, the reference's on-disk form."""
    return ((BFLOAT16_NP is not None and arr.dtype == BFLOAT16_NP)
            or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2
                and arr.dtype.fields is None))


def tensor_from_numpy(arr, dtype=None, device=None) -> torch.Tensor:
    """Host array ``arr`` as a tensor on ``device`` (the CPU when None;
    there it may share ``arr``'s memory), converted to the IR dtype
    ``dtype`` when one is given.  bfloat16 values
    (:func:`_is_bf16_bits`) move exactly, by their bits (a ``uint16``
    view as ``torch.int16``, viewed as ``torch.bfloat16``); other
    arrays become bfloat16 through torch's round-to-nearest-even cast,
    never through float32's dtype."""
    arr = np.asarray(arr)
    want = None if dtype is None else normalize_dtype(dtype)
    if _is_bf16_bits(arr):
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16).to(device)
        return t if want in (None, "bfloat16") else t.to(getattr(torch,
                                                                   want))
    if want == "bfloat16":
        return torch.as_tensor(arr, device=device).to(torch.bfloat16)
    if want is not None:
        arr = arr.astype(np_dtype(want), copy=False)
    return torch.as_tensor(arr, device=device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of tensor ``t``.  A bfloat16 tensor comes back as an
    ``ml_dtypes.bfloat16`` array where ``ml_dtypes`` can be imported
    (the reference's fetch type), else as float32 holding the same
    values (exact: every bfloat16 is a float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        if BFLOAT16_NP is None:
            return t.float().cpu().numpy()
        return bf16_bits(t).view(BFLOAT16_NP)
    return np.array(t.cpu(), copy=True)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """The bits of bfloat16 tensor ``t`` as a host ``uint16`` array."""
    return t.detach().contiguous().view(torch.int16).cpu().numpy() \
        .view(np.uint16).copy()


def _to_numpy(v):
    """A host copy of a fetched value (:func:`tensor_to_numpy`); a
    ``SelectedRows`` is returned as it is, as the reference's executor
    returns it."""
    if isinstance(v, SelectedRows):
        return v
    if isinstance(v, torch.Tensor):
        return tensor_to_numpy(v)
    return np.array(v, copy=True)


class Executor:
    """Runs Programs and built callables on one device (module doc).

    ``place``: ``None`` (``cuda:0``), a ``CUDAPlace``/``CPUPlace``, a
    device string or a ``torch.device``.  ``training=False`` makes an
    inference executor (the Predictor's): its rules take their test
    branch (``LowerContext.training``)."""

    def __init__(self, place=None, training: bool = True):
        self.device = get_device(place)
        self.place = place
        self.training = bool(training)
        self._cache: Dict[str, Callable] = {}
        self._plans: Dict[tuple, object] = {}
        self._consts: Dict[tuple, torch.Tensor] = {}
        sc = _obs_stats.scope("executor")
        self._steps = sc.counter("steps", "dispatches run")
        self._misses = sc.counter(
            "cache_misses", "dispatch keys built for the first time")
        self._hits = sc.counter("cache_hits",
                                "dispatches of an already-built key")

    def _to_device(self, v, var: Optional[Variable] = None) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device, non_blocking=True)
        dtype = var.dtype if var is not None else None
        return tensor_from_numpy(v, dtype, self.device)

    # -- Program runs --------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, object]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True):
        """Run block 0 of ``program`` (module doc); returns the fetches,
        numpy arrays when ``return_numpy`` else tensors."""
        program = program if program is not None else default_main_program()
        feed = feed or {}
        program = self._prepare_program(program, feed)
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        scope = scope or global_scope()
        feed_names = sorted(feed)
        plan = self._plan(program, feed_names, fetch_names)
        block = program.global_block
        env: Dict[str, object] = {}
        for n in feed_names:
            env[n] = self._to_device(feed[n], block.var_or_none(n))
        for n in plan.state_reads:
            env[n] = self._state_val(scope, block, n)
        ctx = LowerContext(block=block, device=self.device,
                           base_seed=program.random_seed,
                           generator=self._generator(scope, program),
                           consts=self._consts, training=self.training,
                           mesh=self._mesh())
        with torch.no_grad():
            lower_ops(ctx, program, block, env, plan)
        fetches = [env[n] for n in fetch_names]
        out = ([_to_numpy(v) for v in fetches] if return_numpy
               else list(fetches))
        for name in plan.persist_writes:
            self._write_state(scope, name, env[name])
        if plan.has_stateful:
            scope.set_var(RNG_STATE_VAR, ctx._generator)
        self._steps.inc()
        return out

    def _plan(self, program: Program, feed_names, fetch_names):
        key = (program._uid, program._version, tuple(feed_names),
               tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = analyze_block(program, 0, feed_names,
                                                    fetch_names)
        return plan

    def warm_start(self, program: Optional[Program] = None,
                   feed_specs=None, fetch_list: Optional[Sequence] = None,
                   scope: Optional[Scope] = None) -> dict:
        """Prepare ``(program, feed_specs, fetch_list)`` before the first
        run: the port has no compile cache, so this builds the plan for
        the feed names and checks that the scope holds every state the
        block reads.  ``feed_specs`` is one name -> spec dict, or a list
        of them (a serving bucket ladder).  Returns the reference's keys,
        {"segments", "warmed", "persistent_hits", "compiled",
        "skipped", "ms"}: one segment per spec, warmed when its state
        is all there (skipped, with the reason, when not), and never a
        persistent hit or a compile."""
        t0 = time.perf_counter()
        program = program if program is not None else default_main_program()
        scope = scope or global_scope()
        specs = (list(feed_specs) if isinstance(feed_specs, (list, tuple))
                 else [feed_specs or {}])
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        out = {"segments": 0, "warmed": 0, "persistent_hits": 0,
               "compiled": 0, "skipped": [], "ms": 0.0}
        for i, fs in enumerate(specs):
            out["segments"] += 1
            plan = self._plan(self._prepare_program(program, fs),
                              sorted(fs), fetch_names)
            missing = [n for n in plan.state_reads
                       if scope.find_var(n) is None]
            if missing:
                out["skipped"].append(f"program[{i}]: state not in the "
                                      f"scope: {missing[:4]}")
            else:
                out["warmed"] += 1
        out["ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    # -- hooks (overridden by parallel.ParallelExecutor) --------------------
    def _prepare_program(self, program: Program, feed: Dict) -> Program:
        """The program a run executes (the gradient-scale rewrite)."""
        return program

    def _mesh(self):
        """The device mesh handed to the rules (``LowerContext.mesh``)."""
        return None

    def _generator(self, scope: Scope, program: Program) -> torch.Generator:
        g = scope.find_var(RNG_STATE_VAR)
        if isinstance(g, torch.Generator) and g.device == self.device:
            return g
        g = torch.Generator(device=self.device)
        g.manual_seed(int(program.random_seed or 0))
        return g

    def _state_val(self, scope: Scope, block, name: str) -> torch.Tensor:
        val = scope.find_var(name)
        if val is None:
            raise RuntimeError(
                f"variable {name!r} is not initialized in the scope — run "
                f"the startup program first "
                f"(fluid.default_startup_program())")
        if isinstance(val, torch.Tensor) and val.device == self.device:
            return val
        t = self._to_device(val, block.var_or_none(name))
        scope.set_var(name, t)
        return t

    def _write_state(self, scope: Scope, name: str, val) -> None:
        old = scope.vars.get(name)
        if (isinstance(old, torch.Tensor) and isinstance(val, torch.Tensor)
                and old is not val and old.shape == val.shape
                and old.dtype == val.dtype and old.device == val.device):
            # a rule that updated the tensor in place (the sparse
            # optimizers' K10) returns it again, under a new tensor
            # object (the interpreter's detach): nothing to copy
            if (old.data_ptr() != val.data_ptr()
                    or old.stride() != val.stride()):
                old.copy_(val)
        else:
            scope.set_var(name, val)

    # -- callable dispatch (decode plane) -----------------------------------
    def run_callable(self, key: str, build_fn, feed: Sequence,
                     state: Sequence = (), const: Sequence = ()
                     ) -> Tuple[List, List]:
        """Run ``build_fn()(feed, state, const) -> outs`` (built once per
        ``key``); returns ``(outs, state)`` with ``state`` the same
        tensors, written in place."""
        fn = self._cache.get(key)
        if fn is None:
            fn = build_fn()
            self._cache[key] = fn
            self._misses.inc()
        else:
            self._hits.inc()
        feed = [self._to_device(v) for v in feed]
        state = list(state)
        with torch.inference_mode():
            outs = fn(feed, state, list(const))
        self._steps.inc()
        return outs, state


__all__ = ["Executor", "RNG_STATE_VAR", "Scope", "global_scope",
           "scope_guard"]
