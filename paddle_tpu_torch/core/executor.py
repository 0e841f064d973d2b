"""Executor: runs Programs, and the callable dispatch of the decode plane.

The port of ``paddle_tpu/core/executor.py``.

``Executor.run(program, feed, fetch_list, scope, return_numpy,
use_program_cache, sync)`` runs block 0 of a Program with the
reference's semantics: feeds are moved to the executor's device in
their declared dtypes (a fed ``LoDTensor`` becomes its padded array
plus ``@LEN``, and ``@LEN2`` when nested), every other variable an op
reads comes from the scope (a missing one raises, asking for the
startup program), the block runs op by op through the registry
(``core/lowering.py``), and persistable variables the block writes go
back to the scope.  A persistable that already holds a tensor of the
same shape, dtype and device is written IN PLACE (``copy_``, skipped
when a rule already updated that very storage), as ``run_callable``
updates its state; the reference instead donates the old buffer to XLA
and stores the new one.

Fetches.  With ``sync=True`` every fetch is a numpy array (a fetched
``SelectedRows`` gradient comes back as itself).  With ``sync=False``,
the default, a tensor fetch comes back as a :class:`LazyFetch`: it
keeps the device tensor, and the first read of any pending fetch copies
every pending fetch to the host in one batch (non-blocking copies into
pinned buffers, then one synchronisation a card), so a step loop that
reads its losses at the end pays one round trip, not one a step.
Because persistables are written in place, a fetch whose storage
overlaps one the run read or wrote as state (a parameter, or a
``reshape`` view of one fetched under another name), or a feed's, is
copied at once instead, before the state is written: a deferred read
would see a later step's value.  The reference decides by name only
(its buffers are donated, never overwritten).

``Executor.run_steps(program, feed, fetch_list, scope)`` runs K steps
over feeds stacked ``[K, ...]``: each stacked feed goes to the device
once, the cached plan runs K times over its device slices with no host
read between steps, and the fetches are stacked on the device and
copied to the host once at the end.  Persistable state and the scope's
generator advance exactly as K ``run`` calls would, bit for bit.

The plan (dataflow analysis and grad pairing) is cached per program
version, feed names and fetch names; constants the rules make on the
device (literal tables, optimizer scalars) are cached per executor.
``Executor(training=False)`` is the Predictor's inference executor, and
``warm_start`` builds the plans a serving bucket ladder will use (there
is no compile cache to fill).  Two hooks, as in the reference, let
``parallel.ParallelExecutor`` rewrite the program a run executes
(``_prepare_program``) and hand its device mesh to the rules
(``_mesh``, read by ``fused_attention impl="ring"``).  The reference's
jit cache, segmented host ops, numerics guard and compile cache are not
ported yet.

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
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..lod_tensor import LoDTensor
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
    """A host copy of tensor ``t`` (:func:`_host_array` of a private
    host tensor)."""
    t = t.detach()
    host = t.cpu()
    return _host_array(host.clone() if host is t else host)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """The numpy array of host tensor ``t``, sharing its memory.  A
    bfloat16 tensor comes back as an ``ml_dtypes.bfloat16`` array where
    ``ml_dtypes`` can be imported (the reference's fetch type), else as
    a float32 copy holding the same values (exact: every bfloat16 is a
    float32)."""
    if t.dtype == torch.bfloat16:
        if BFLOAT16_NP is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(BFLOAT16_NP)
    return t.numpy()


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


def _card(v):
    """The card that tensor ``v`` lies on (None for other values)."""
    return v.device if isinstance(v, torch.Tensor) and v.is_cuda else None


def _storage(v):
    """The address of tensor ``v``'s storage (None for other values)."""
    return v.untyped_storage().data_ptr() if isinstance(v, torch.Tensor) \
        else None


def host_copies(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies (:func:`tensor_to_numpy`) of ``tensors``.  A card's
    tensors are copied non-blocking into pinned buffers on its current
    stream, then waited for with one synchronisation a card; each
    buffer is private, so its array is returned without another copy.
    CPU tensors are plain copies."""
    out: List = [None] * len(tensors)
    on_card: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        if t.device.type == "cuda":
            on_card.setdefault(t.device, []).append(i)
        else:
            out[i] = tensor_to_numpy(t)
    for dev, idx in on_card.items():
        bufs = []
        for i in idx:
            t = tensors[i].detach()
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            bufs.append(buf)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
        for i, buf in zip(idx, bufs):
            out[i] = _host_array(buf)
    return out


class LazyFetch(np.lib.mixins.NDArrayOperatorsMixin):
    """A deferred ``Executor.run`` fetch (reference
    ``core/executor.py:245``): it holds the device tensor and becomes a
    numpy array at the first host access, so back-to-back ``run`` calls
    queue their work instead of waiting for the card once a step.

    Reading ANY pending fetch materializes ALL pending fetches in one
    batch (:func:`host_copies`: one synchronisation a card; on the CPU a
    plain copy).  ``shape``, ``dtype``, ``ndim`` and ``size`` need no
    sync.  It acts as an ndarray for ufuncs, indexing, ``float()``,
    ``int()``, ``bool()``, ``format`` and ``repr``; anything else
    delegates to the materialized array.  Pending fetches are held as
    weakrefs (a dropped fetch frees its tensor), under a lock
    (``Executor.run`` is called from many threads), with a backstop of
    :attr:`_MAX_PENDING` unread fetches, past which the constructor
    materializes the batch.  Counters: :attr:`batches` (materializations
    of one or more fetches) and :attr:`syncs` (the synchronisations
    those materializations made: one a card a batch, one a card fetch
    when a failed batch is read one by one; ``run_steps``' copy and the
    ``sync=True`` fetches are not counted)."""

    _PENDING: List = []
    _LOCK = threading.Lock()
    _MAX_PENDING = 512
    batches = 0
    syncs = 0

    def __init__(self, dev: torch.Tensor):
        self._dev = dev
        self._np = None
        self._err = None
        self._done = threading.Event()
        backstop = None
        with LazyFetch._LOCK:
            if len(LazyFetch._PENDING) >= LazyFetch._MAX_PENDING:
                backstop = LazyFetch._snapshot_locked()
            LazyFetch._PENDING.append(weakref.ref(self))
        if backstop:  # materialize outside the lock (see _flush)
            LazyFetch._materialize(backstop)

    @classmethod
    def _snapshot_locked(cls):
        batch = [f for ref in cls._PENDING
                 if (f := ref()) is not None
                 and f._np is None and f._err is None]
        cls._PENDING.clear()
        return batch

    @classmethod
    def _flush(cls):
        # snapshot under the lock, copy outside it: holding the lock
        # across the device wait would serialize every concurrent run
        with cls._LOCK:
            batch = cls._snapshot_locked()
        cls._materialize(batch)

    @classmethod
    def _materialize(cls, batch):
        if not batch:
            return
        with cls._LOCK:
            cls.batches += 1
        try:
            vals = host_copies([f._dev for f in batch])
        except Exception:  # noqa: BLE001 - isolate the failing fetch
            # one by one, so a single failed read loses no other value
            for f in batch:
                try:
                    card = _card(f._dev)
                    cls._assign(f, host_copies([f._dev])[0])
                    cls._count_syncs({card})
                except Exception as e:  # noqa: BLE001 - kept for the read
                    f._err = e
                    f._dev = None
                f._done.set()
            return
        cls._count_syncs({_card(f._dev) for f in batch})
        for f, v in zip(batch, vals):
            cls._assign(f, v)
            f._done.set()

    @classmethod
    def _count_syncs(cls, cards):
        # host_copies waits once for each card among the copied tensors
        with cls._LOCK:
            cls.syncs += len(cards - {None})

    @staticmethod
    def _assign(f, v):
        # one mutable array per fetch (a private host copy), like the
        # sync path's returned ndarray
        f._np = v
        f._dev = None

    @property
    def pending(self) -> bool:
        """True until the fetch is materialized (or failed)."""
        return self._np is None and self._err is None

    def _val(self):
        if self.pending:
            LazyFetch._flush()
            # raced another thread's in-flight batch: it will assign and
            # signal; wait instead of copying twice
            if self.pending and not self._done.wait(timeout=600.0):
                raise RuntimeError(
                    "deferred fetch timed out waiting for another "
                    "thread's in-flight copy to the host")
        if self._err is not None:
            raise RuntimeError(
                f"deferred fetch failed: {self._err!r}") from self._err
        return self._np

    # metadata without a sync (snapshot the fields first: a concurrent
    # flush may assign _np and clear _dev between the reads)
    @property
    def shape(self):
        a, dev = self._np, self._dev
        if a is not None:
            return a.shape
        if dev is not None:
            return tuple(dev.shape)
        return self._val().shape

    @property
    def dtype(self):
        a, dev = self._np, self._dev
        if a is not None:
            return a.dtype
        if dev is not None:
            return _host_array(torch.empty(0, dtype=dev.dtype)).dtype
        return self._val().dtype

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n

    def __array__(self, dtype=None, *args, **kwargs):
        # np.asarray of the fetch is its own mutable array, as for the
        # sync path's ndarray; a dtype conversion or numpy 2's copy=True
        # gives a private copy
        a = self._val()
        if kwargs.get("copy") or (args and args[0]):
            return np.array(a, dtype=dtype, copy=True)
        return np.asarray(a, dtype=dtype) if dtype is not None else a

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = tuple(np.asarray(i) if isinstance(i, LazyFetch) else i
                       for i in inputs)
        return getattr(ufunc, method)(*inputs, **kwargs)

    def __getitem__(self, idx):
        return self._val()[idx]

    def __setitem__(self, idx, value):
        self._val()[idx] = value

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        return iter(self._val())

    def __float__(self):
        return float(self._val())

    def __int__(self):
        return int(self._val())

    def __bool__(self):
        return bool(self._val())

    def __format__(self, spec):
        return format(self._val(), spec)

    def __repr__(self):
        return repr(self._val())

    def __str__(self):
        return str(self._val())

    def item(self, *args):
        return self._val().item(*args)

    def __getattr__(self, name):
        # anything beyond the surface above: materialize and delegate.
        # Dunder protocols must not leak through (numpy would find the
        # bfloat16 array's __array_interface__ and read its bytes as
        # void records; __array__ above is the one door)
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return getattr(self._val(), name)


def _expand_lod_feeds(feed: Dict) -> Dict:
    """A fed ``LoDTensor`` becomes its padded array plus the ``@LEN``
    lengths, and the inner ``@LEN2`` lengths when nested (reference
    ``core/executor.py:454``)."""
    out = {}
    for name, val in feed.items():
        if isinstance(val, LoDTensor):
            out[name] = val.data
            out.setdefault(name + "@LEN", val.seq_lens)
            if val.inner_lens is not None:
                out.setdefault(name + "@LEN2", val.inner_lens)
        else:
            out[name] = val
    return out


def _fetch_names(fetch_list) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]


def _leading(v) -> int:
    """The leading dim of a feed value (a tensor stays where it is)."""
    return v.shape[0] if hasattr(v, "shape") else np.shape(v)[0]


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
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True, sync: bool = False):
        """Run block 0 of ``program`` (module doc); returns the fetches:
        tensors when ``return_numpy`` is false, else numpy arrays with
        ``sync``, and deferred fetches (:class:`LazyFetch`) without.
        ``use_program_cache=False`` analyzes the program anew."""
        program = program if program is not None else default_main_program()
        feed = _expand_lod_feeds(feed or {})
        program = self._prepare_program(program, feed)
        fetch_names = _fetch_names(fetch_list)
        scope = scope or global_scope()
        feed_names = sorted(feed)
        plan = self._plan(program, feed_names, fetch_names,
                          use_program_cache)
        block = program.global_block
        feeds = {n: self._to_device(feed[n], block.var_or_none(n))
                 for n in feed_names}
        env, ctx = self._step(program, plan, feeds, scope)
        fetches = [env[n] for n in fetch_names]
        if not return_numpy:
            out = list(fetches)
        elif sync:
            out = [_to_numpy(v) for v in fetches]
        else:
            out = self._deferred(plan, scope, env, feeds, fetch_names,
                                 fetches)
        self._commit(plan, scope, env, ctx)
        self._steps.inc()
        return out

    def run_steps(self, program: Optional[Program] = None,
                  feed: Optional[Dict[str, object]] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None, return_numpy: bool = True):
        """Run K steps over ``feed``, each value stacked ``[K, ...]``:
        step i consumes slice i, and the fetches come back stacked
        ``[K, ...]`` (module doc).  Persistable state and the scope's
        generator advance exactly as K ``run`` calls would."""
        program = program if program is not None else default_main_program()
        feed = feed or {}
        for n, v in feed.items():
            if isinstance(v, LoDTensor):
                raise TypeError(
                    f"run_steps feed {n!r} is a LoDTensor: the leading dim "
                    "of a run_steps feed is the STEP count, not the "
                    "batch; stack padded arrays + '@LEN' vectors per "
                    "step instead")
        if not feed:
            raise ValueError("run_steps needs at least one stacked feed "
                             "to define the step count")
        fetch_names = _fetch_names(fetch_list)
        scope = scope or global_scope()
        program = self._prepare_program(program, feed)
        feed_names = sorted(feed)
        steps = {n: int(_leading(feed[n])) for n in feed_names}
        if len(set(steps.values())) != 1:
            raise ValueError(
                f"stacked feeds disagree on the step count: {steps}")
        K = steps[feed_names[0]]
        plan = self._plan(program, feed_names, fetch_names)
        block = program.global_block
        # one host-to-device copy a feed, for all K steps
        stacked = {n: self._to_device(feed[n], block.var_or_none(n))
                   for n in feed_names}
        outs: List[torch.Tensor] = []
        for i in range(K):
            env, ctx = self._step(program, plan,
                                  {n: stacked[n][i] for n in feed_names},
                                  scope)
            for j, name in enumerate(fetch_names):
                v = env[name]
                if not isinstance(v, torch.Tensor):
                    raise TypeError(
                        f"run_steps cannot stack fetch {name!r} "
                        f"({type(v).__name__}); fetch it with run()")
                if i == 0:
                    outs.append(torch.empty((K,) + tuple(v.shape),
                                            dtype=v.dtype, device=v.device))
                # copied now: a fetch may be state the next step rewrites
                outs[j][i].copy_(v)
            self._commit(plan, scope, env, ctx)
            del env, ctx    # this step's values go before the next runs
        self._steps.inc()
        return host_copies(outs) if return_numpy else outs

    def _step(self, program: Program, plan, feeds: Dict, scope: Scope):
        """One pass of block 0 over device ``feeds`` and the scope's
        state; returns the run's environment and its context."""
        block = program.global_block
        env: Dict[str, object] = dict(feeds)
        for n in plan.state_reads:
            env[n] = self._state_val(scope, block, n)
        ctx = LowerContext(block=block, device=self.device,
                           base_seed=program.random_seed,
                           generator=self._generator(scope, program),
                           consts=self._consts, training=self.training,
                           mesh=self._mesh())
        with torch.no_grad():
            lower_ops(ctx, program, block, env, plan)
        return env, ctx

    def _commit(self, plan, scope: Scope, env: Dict, ctx) -> None:
        """Write the persistables the step wrote, and its generator."""
        for name in plan.persist_writes:
            self._write_state(scope, name, env[name])
        if plan.has_stateful:
            scope.set_var(RNG_STATE_VAR, ctx._generator)

    def _deferred(self, plan, scope: Scope, env: Dict, feeds: Dict,
                  fetch_names, fetches) -> list:
        """``run``'s fetches without ``sync``: a :class:`LazyFetch` for a
        tensor, a host copy made now for anything else and for a tensor
        that names or shares storage with the run's state or feeds
        (module doc), before the state is written."""
        state = set(plan.state_reads) | set(plan.persist_writes)
        held = {_storage(v) for v in feeds.values()}
        held |= {_storage(scope.find_var(n)) for n in plan.state_reads}
        held |= {_storage(env.get(n)) for n in plan.persist_writes}
        return [LazyFetch(v) if (isinstance(v, torch.Tensor)
                                 and name not in state
                                 and _storage(v) not in held)
                else _to_numpy(v)
                for name, v in zip(fetch_names, fetches)]

    def _plan(self, program: Program, feed_names, fetch_names,
              cache: bool = True):
        key = (program._uid, program._version, tuple(feed_names),
               tuple(fetch_names))
        plan = self._plans.get(key) if cache else None
        if plan is None:
            plan = analyze_block(program, 0, feed_names, fetch_names)
            if cache:
                self._plans[key] = plan
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
        fetch_names = _fetch_names(fetch_list)
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


__all__ = ["Executor", "LazyFetch", "RNG_STATE_VAR", "Scope",
           "global_scope", "host_copies", "scope_guard"]
