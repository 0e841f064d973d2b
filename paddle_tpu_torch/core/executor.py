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

The plan (dataflow analysis and grad pairing) is cached under the
reference's executable-cache key: program version, feed signature
(names, shapes, dtypes), fetch names and mode, at most
``FLAGS_executor_cache_capacity`` entries (oldest out first).  The plan
build stands where the reference compiles: a new key is a cache miss
(a new feed signature for a known program and fetch list is a shape
recompile), the analysis is its ``lowering_ms`` and the first pass over
a fresh plan its ``compile_ms``.  Constants the rules make on the
device (literal tables, optimizer scalars) are cached per executor.
``Executor(training=False)`` is the Predictor's inference executor, and
``warm_start`` builds the plans a serving bucket ladder will use (there
is no compile cache to fill).  Two hooks, as in the reference, let
``parallel.ParallelExecutor`` rewrite the program a run executes
(``_prepare_program``) and hand its device mesh to the rules
(``_mesh``, read by ``fused_attention impl="ring"``).  The reference's
segmented host ops and compile cache are not ported yet.

Telemetry, as the reference's (``FLAGS_runtime_stats``, on by default:
off makes it one flag read): each ``run``, ``run_steps`` and
``run_callable`` records one ``StepStats`` (``observability/
step_stats.py``) and the ``executor.*`` counters (steps, cache hits and
misses, shape recompiles, evictions, feed and fetch bytes, the wall
histogram).  Opt-in planes, each one flag read when off:
``FLAGS_perf_attribution`` gives each plan a cost/memory record
(``observability/perf.py``: the cost walk over the first pass's shapes)
fed with each run's wall; ``FLAGS_run_log_dir`` appends each step's
scalar fetches to a JSONL log (``observability/runlog.py``; a raw
tensor fetch waits on an event recorded after the step, never on a
sync); ``FLAGS_numerics_check`` (``warn``/``fatal``) checks every float
fetch and written persistable for NaN/Inf with device-side flags and
one host read, before the state is committed.  Because the port writes
state in place, and the sparse optimizers' K10 writes the tables
during the step, ``fatal`` keeps a pre-step copy of every persistable
the step writes (and of the generator's state) and puts it back on a
fatal verdict, so the scope is bit-equal to its pre-step state.

``run_callable(key, build_fn, feed, state, const)`` builds
``build_fn()`` once per key and feed/state/const signature (the
reference's jit cache key), moves the host feeds to the executor's
device, and runs the built function under ``torch.inference_mode()``,
with the telemetry of a program run under ``callable:<key>``.
``state`` is updated IN PLACE
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
from . import flags as _flags
from ..observability import debug_server as _debug_server
from ..observability import perf as _obs_perf
from ..observability import runlog as _obs_runlog
from ..observability import stats as _obs_stats
from ..observability import step_stats as _obs_step
from ..observability import trace as _obs_trace
from ..platform import get_device
from .lowering import analyze_block, lower_ops
from .program import Program, Variable, default_main_program
from .registry import LowerContext
from .selected_rows import SelectedRows
from .types import BFLOAT16_NP, normalize_dtype, np_dtype

RNG_STATE_VAR = "@RNG_STATE@"

_exec_metrics = None

# live executors for the debug server's /statusz (weak: the provider
# must never keep a discarded executor alive)
_live_executors: "weakref.WeakSet" = weakref.WeakSet()


def _executor_statusz() -> dict:
    cap = _flags.get_flags("executor_cache_capacity")
    return {
        "cache_capacity": cap,
        "executors": [
            {"training": e.training,
             "cache_entries": len(e._plans) + len(e._cache),
             "seen_shape_buckets": len(e._seen_shapes)}
            for e in list(_live_executors)],
    }


_debug_server.register_provider("executors", _executor_statusz)


def _em():
    """Cached executor metric handles (the reference's): created once,
    they survive ``observability.reset()``, so a run pays no registry
    lookup."""
    global _exec_metrics
    m = _exec_metrics
    if m is None:
        sc = _obs_stats.scope("executor")
        import types as _t
        m = _t.SimpleNamespace(
            steps=sc.counter("steps", "dispatches run"),
            hits=sc.counter("cache_hits",
                            "dispatches of an already-built key"),
            misses=sc.counter("cache_misses",
                              "dispatch keys built for the first time"),
            shape_recompiles=sc.counter(
                "shape_recompiles",
                "plan builds caused by a new feed-shape bucket for an "
                "already-built program"),
            evictions=sc.counter("cache_evictions"),
            feed_bytes=sc.counter("feed_bytes"),
            fetch_bytes=sc.counter("fetch_bytes"),
            wall=sc.histogram("run_wall_ms"),
        )
        _exec_metrics = m
    return m


_numerics_metrics = None


def _nm():
    """Cached numerics-sentinel metric handles (see ``_em``)."""
    global _numerics_metrics
    m = _numerics_metrics
    if m is None:
        sc = _obs_stats.scope("numerics")
        import types as _t
        m = _t.SimpleNamespace(
            nan=sc.counter("nan", "variables with NaN values caught by "
                           "the FLAGS_numerics_check post-step sentinel"),
            inf=sc.counter("inf", "variables with Inf values caught by "
                           "the FLAGS_numerics_check post-step sentinel"),
            checked=sc.counter("checked_steps"),
        )
        _numerics_metrics = m
    return m


def _numerics_mode() -> str:
    """'' (off) / 'warn' / 'fatal' from ``FLAGS_numerics_check``."""
    v = str(_flags.get_flags("numerics_check") or "").strip().lower()
    if v in ("", "0", "false", "off", "no", "none"):
        return ""
    return "fatal" if v == "fatal" else "warn"


class _CacheEntry:
    """One slot of the executor's plan cache (the reference's
    executable-cache entry): the plan, the telemetry constants of its
    key (``meta``: program_key and the feed/fetch byte totals) and its
    cost/memory record when ``FLAGS_perf_attribution`` harvested it."""

    __slots__ = ("plan", "meta", "perf")

    def __init__(self, plan):
        self.plan = plan
        self.meta = None
        self.perf = None


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
        self._cache: Dict[tuple, Callable] = {}
        self._plans: Dict[tuple, _CacheEntry] = {}
        self._consts: Dict[tuple, torch.Tensor] = {}
        # telemetry: feed signatures seen per (program, fetch, mode)
        # base key, to tell shape-bucket rebuilds from first builds
        self._seen_shapes: Dict = {}
        _live_executors.add(self)

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
        tel = _obs_trace.flags_on()
        rl = _obs_runlog.enabled()
        if rl:
            # before this step writes state in place: queued raw
            # fetches that alias it land first
            _obs_runlog.drain_pending()
        pf = _obs_perf.enabled()
        t_run0 = time.perf_counter_ns() if (tel or rl or pf) else None
        feed_names = sorted(feed)
        block = program.global_block
        feeds = {n: self._to_device(feed[n], block.var_or_none(n))
                 for n in feed_names}
        key, entry, hit, lowering_ms = self._entry(
            program, feeds, fetch_names, "run", tel, use_program_cache)
        plan = entry.plan
        nc = _numerics_mode()
        backup = self._backup_state(scope, plan) if nc == "fatal" else None
        trace = [] if pf and entry.perf is None else None
        mem0 = self._perf_mem_begin() if trace is not None else None
        t_disp0 = time.perf_counter_ns()
        env, ctx = self._step(program, plan, feeds, scope, trace)
        compile_ms = 0.0 if hit else (time.perf_counter_ns() - t_disp0) / 1e6
        if trace is not None:
            lowering_ms += self._harvest(entry, "run", 1, trace, mem0,
                                         feeds, scope, env, fetch_names,
                                         lowering_ms)
        fetches = [env[n] for n in fetch_names]
        self._numerics_guard(nc, backup, fetch_names, fetches, plan,
                             [env[n] for n in plan.persist_writes], scope)
        if not return_numpy:
            out = list(fetches)
        elif sync:
            out = [_to_numpy(v) for v in fetches]
        else:
            out = self._deferred(plan, scope, env, feeds, fetch_names,
                                 fetches)
        self._commit(plan, scope, env, ctx)
        ready = self._ready_event() if rl and not return_numpy else None
        if tel:
            self._record_step(entry, key, hit, lowering_ms, compile_ms,
                              list(feeds.values()), fetches, t_run0, plan,
                              program)
        if pf and entry.perf is not None:
            self._observe_perf(entry, key, t_run0, lowering_ms)
        if rl:
            _obs_runlog.log_run(
                fetch_names, out,
                wall_ms=(time.perf_counter_ns() - t_run0) / 1e6,
                batch=_obs_runlog.batch_of(list(feeds.values())),
                ready=ready)
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
        tel = _obs_trace.flags_on()
        rl = _obs_runlog.enabled()
        if rl:
            _obs_runlog.drain_pending()
        pf = _obs_perf.enabled()
        t_run0 = time.perf_counter_ns() if (tel or rl or pf) else None
        block = program.global_block
        # one host-to-device copy a feed, for all K steps
        stacked = {n: self._to_device(feed[n], block.var_or_none(n))
                   for n in feed_names}
        key, entry, hit, lowering_ms = self._entry(
            program, stacked, fetch_names, "run_steps", tel)
        plan = entry.plan
        nc = _numerics_mode()
        backup = self._backup_state(scope, plan) if nc == "fatal" else None
        trace = [] if pf and entry.perf is None else None
        mem0 = self._perf_mem_begin() if trace is not None else None
        outs: List[torch.Tensor] = []
        t_disp0 = time.perf_counter_ns()
        for i in range(K):
            env, ctx = self._step(program, plan,
                                  {n: stacked[n][i] for n in feed_names},
                                  scope, trace if i == 0 else None)
            if i == 0 and trace is not None:
                lowering_ms += self._harvest(
                    entry, "run_steps", K, trace, mem0, stacked, scope,
                    env, fetch_names, lowering_ms)
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
        compile_ms = 0.0 if hit else (time.perf_counter_ns() - t_disp0) / 1e6
        self._numerics_guard(nc, backup, fetch_names, outs, plan,
                             [scope.find_var(n) for n in plan.persist_writes],
                             scope)
        out = host_copies(outs) if return_numpy else outs
        if tel:
            self._record_step(entry, key, hit, lowering_ms, compile_ms,
                              list(stacked.values()), outs, t_run0, plan,
                              program)
        if pf and entry.perf is not None:
            self._observe_perf(entry, key, t_run0, lowering_ms)
        if rl:
            _obs_runlog.log_run_steps(
                fetch_names, out, K,
                wall_ms=(time.perf_counter_ns() - t_run0) / 1e6,
                batch=_obs_runlog.batch_of(list(stacked.values()), axis=1),
                ready=None if return_numpy else self._ready_event())
        return out

    def _step(self, program: Program, plan, feeds: Dict, scope: Scope,
              trace: Optional[list] = None):
        """One pass of block 0 over device ``feeds`` and the scope's
        state; returns the run's environment and its context.  A
        ``trace`` list gets each op's shapes (the perf cost walk)."""
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
            lower_ops(ctx, program, block, env, plan, trace)
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

    # -- the plan cache (the reference's executable cache) -------------------
    @staticmethod
    def _feed_sig(feed_names, vals) -> tuple:
        """Feed-signature component of the cache key: each feed's name,
        shape and IR dtype name."""
        return tuple((n, tuple(int(d) for d in v.shape), _dtype_name(v))
                     for n, v in zip(feed_names, vals))

    def _mem_key(self, program: Program, sig, fetch_names,
                 mode: str = "run") -> tuple:
        """THE plan-cache key (``run``, ``run_steps`` and ``warm_start``
        share it)."""
        if mode == "run":
            return (program._uid, program._version, sig,
                    tuple(fetch_names), self.training)
        return (program._uid, program._version, sig, tuple(fetch_names),
                mode, self.training)

    def _entry(self, program: Program, feeds: Dict, fetch_names, mode: str,
               tel: bool, cache: bool = True):
        """(key, cache entry, hit, build ms) for a run over ``feeds``;
        a miss analyzes the block (the plan build), counted as the
        reference counts a compile."""
        feed_names = sorted(feeds)
        sig = self._feed_sig(feed_names, [feeds[n] for n in feed_names])
        key = self._mem_key(program, sig, fetch_names, mode)
        entry = self._plans.get(key) if cache else None
        if entry is not None:
            if tel:
                _em().hits.inc()
            return key, entry, True, 0.0
        t0 = time.perf_counter_ns()
        entry = _CacheEntry(analyze_block(program, 0, feed_names,
                                          fetch_names))
        build_ms = (time.perf_counter_ns() - t0) / 1e6
        if cache:
            self._plans[key] = entry
            self._evict_cache_overflow(self._plans)
        if tel:
            base = (program._uid, program._version, tuple(fetch_names),
                    mode, self.training)
            self._note_cache_miss(base, sig)
        return key, entry, False, build_ms

    def _note_cache_miss(self, base, sig) -> None:
        m = _em()
        m.misses.inc()
        if len(self._seen_shapes) > 1024:
            # bound the side-table (telemetry only: a clear just makes
            # the next miss per base count as a first build)
            self._seen_shapes.clear()
        seen = self._seen_shapes.setdefault(base, set())
        if seen and sig not in seen:
            # same program+fetches, new feed signature: a shape-bucket
            # rebuild (a storm of these means feed shapes are churning)
            m.shape_recompiles.inc()
        if len(seen) > 1024:
            seen.clear()
        seen.add(sig)

    def _evict_cache_overflow(self, cache: Dict) -> None:
        cap = _flags.get_flags("executor_cache_capacity")
        while cap and len(cache) > cap:
            del cache[next(iter(cache))]   # insertion order = FIFO
            if _obs_trace.flags_on():
                _em().evictions.inc()

    def warm_start(self, program: Optional[Program] = None,
                   feed_specs=None, fetch_list: Optional[Sequence] = None,
                   scope: Optional[Scope] = None) -> dict:
        """Prepare ``(program, feed_specs, fetch_list)`` before the first
        run: the port has no compile cache, so this builds the plan of
        each spec under the key its first run will look up, and checks
        that the scope holds every state the block reads.
        ``feed_specs`` is one name -> (shape, dtype) dict, or a list of
        them (a serving bucket ladder).  Returns the reference's keys,
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
            prog = self._prepare_program(program, fs)
            names = sorted(fs)
            sig = tuple((n, tuple(int(d) for d in fs[n][0]),
                         normalize_dtype(fs[n][1])) for n in names)
            key = self._mem_key(prog, sig, fetch_names)
            entry = self._plans.get(key)
            if entry is None:
                entry = _CacheEntry(analyze_block(prog, 0, names,
                                                  fetch_names))
                self._plans[key] = entry
                self._evict_cache_overflow(self._plans)
            missing = [n for n in entry.plan.state_reads
                       if scope.find_var(n) is None]
            if missing:
                out["skipped"].append(f"program[{i}]: state not in the "
                                      f"scope: {missing[:4]}")
            else:
                out["warmed"] += 1
        out["ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    # -- telemetry -----------------------------------------------------------
    def _record_step(self, entry, key, cache_hit: bool, lowering_ms: float,
                     compile_ms: float, feed_vals, fetches, t_run0_ns: int,
                     plan, program: Optional[Program] = None) -> None:
        t_now = time.perf_counter_ns()
        wall_ms = (t_now - t_run0_ns) / 1e6
        meta = entry.meta
        if meta is None:
            # once per entry: the key pins every feed/fetch shape, so
            # program_key and the transfer byte totals are constants
            nbytes = _obs_step.approx_nbytes
            meta = (self._program_key(key),
                    sum(nbytes(v) for v in feed_vals),
                    sum(nbytes(v) for v in fetches))
            entry.meta = meta
        pk, feed_bytes, fetch_bytes = meta
        ss = _obs_step.StepStats(
            program_key=pk,
            cache_hit=cache_hit,
            lowering_ms=round(lowering_ms, 3),
            compile_ms=round(compile_ms, 3),
            feed_bytes=feed_bytes,
            fetch_bytes=fetch_bytes,
            wall_ms=round(wall_ms, 3),
            extras=self._step_stat_extras(program, plan, fetches))
        _obs_step.record(ss)
        m = _em()
        m.steps.inc()
        m.wall.observe(wall_ms)
        m.feed_bytes.inc(ss.feed_bytes)
        m.fetch_bytes.inc(ss.fetch_bytes)
        if _obs_trace.enabled():
            _obs_trace.emit("executor::run", t_run0_ns, t_now)

    @staticmethod
    def _step_stat_extras(program, plan, fetches):
        """Model-health scalars for the StepStats record: a fetch
        registered in ``Program.step_stat_vars`` lands in the record's
        ``extras`` and a same-named gauge (one small host read each).
        For ``run_steps`` the stacked [K] fetch reports the LAST step."""
        reg = getattr(program, "step_stat_vars", None)
        if not reg:
            return None
        out = {}
        for name, val in zip(plan.fetch_names, fetches):
            key = reg.get(name)
            if key is None or not isinstance(val, torch.Tensor) \
                    or val.numel() < 1:
                continue
            v = float(val.detach().reshape(-1)[-1].item())
            out[key] = v
            _obs_stats.gauge(key).set(v)
        return out or None

    @staticmethod
    def _program_key(key) -> str:
        """Short telemetry id of a plan-cache key (the StepStats
        ``program_key`` and the /profilez record key share it)."""
        return f"{key[0]:x}v{key[1]}:{abs(hash(key)) % (16 ** 8):08x}"

    def _ready_event(self):
        """An event recorded after the step on a card (the run log's
        non-blocking readiness test for raw tensor fetches)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # -- the perf plane (FLAGS_perf_attribution) ----------------------------
    def _perf_mem_begin(self):
        """The bytes live before a harvested pass (a card's), with the
        peak counter reset so the pass's own peak can be read after."""
        if self.device.type != "cuda":
            return None
        live = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        return live

    def _harvest(self, entry, mode: str, steps: int, trace, mem0, feeds,
                 scope: Scope, env: Dict, fetch_names, build_ms) -> float:
        """The cost walk of a fresh plan's first pass into its perf
        record (its ``compile_ms``: the plan's build, ``build_ms``, the
        port's counterpart of the reference's AOT compile); returns the
        walk's milliseconds, a build cost too."""
        t0 = time.perf_counter_ns()
        plan = entry.plan
        nb = _obs_step.approx_nbytes

        def analyze():
            reads = sum(nb(scope.find_var(n)) for n in plan.state_reads)
            writes = sum(nb(env[n]) for n in plan.persist_writes)
            alias = sum(nb(env[n]) for n in plan.persist_writes
                        if n in plan.state_reads)
            mem = {"argument_bytes": sum(nb(v) for v in feeds.values())
                   + reads,
                   "output_bytes": sum(nb(env[n]) for n in fetch_names)
                   + writes,
                   "alias_bytes": alias}
            if mem0 is not None:
                mem["temp_bytes"] = max(
                    0, torch.cuda.max_memory_allocated(self.device) - mem0)
            mem["peak_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem.get("temp_bytes", 0) - alias)
            return _obs_perf.cost_walk(trace, steps), mem

        entry.perf = _obs_perf.harvest(analyze, "compile", mode,
                                       compile_ms=round(build_ms, 3))
        return (time.perf_counter_ns() - t0) / 1e6

    def _observe_perf(self, entry, key, t_run0: int,
                      lowering_ms: float) -> None:
        """Feed the run's wall into its perf record (the plan build
        taken out: the first pass does run the step, so only the
        analysis and the walk are build costs) and sample the live
        device-memory gauges."""
        wall = (time.perf_counter_ns() - t_run0) / 1e6 - lowering_ms
        _obs_perf.observe_step(entry.perf, self._program_key(key),
                               max(wall, 0.0))
        _obs_perf.sample_device_memory()

    # -- the numerics sentinel (FLAGS_numerics_check) -------------------------
    @staticmethod
    def _copy_state_val(v):
        """A copy of one persistable (fatal mode's pre-step snapshot)."""
        if isinstance(v, SelectedRows):
            return SelectedRows(v.rows.clone(), v.values.clone(), v.height)
        return v.clone() if isinstance(v, torch.Tensor) else v

    def _backup_state(self, scope: Scope, plan):
        """Fatal mode's pre-step copies: every persistable the step
        writes (in place, or through a rule that writes a table before
        the commit, the sparse optimizers' K10) and the generator's
        state, each with the object the scope held."""
        saved = [(n, n in scope.vars, scope.find_var(n),
                  self._copy_state_val(scope.find_var(n)))
                 for n in plan.persist_writes]
        g = scope.find_var(RNG_STATE_VAR)
        rng = (g, g.get_state()) if isinstance(g, torch.Generator) else None
        return saved, rng

    @staticmethod
    def _restore_state(scope: Scope, backup) -> None:
        """Put fatal mode's pre-step copies back, bit for bit, into the
        objects the scope held (views and deferred fetches of them see
        the restored values)."""
        saved, rng = backup
        for name, local, obj, copy in saved:
            if obj is None:
                scope.vars.pop(name, None)
                continue
            if isinstance(obj, torch.Tensor):
                obj.copy_(copy)
            elif isinstance(obj, SelectedRows):
                obj = copy
            if local:
                scope.vars[name] = obj
            elif scope.vars.get(name) is not None:
                scope.vars.pop(name)
        if rng is not None:
            rng[0].set_state(rng[1])

    def _numerics_guard(self, mode: str, backup, fetch_names, fetches,
                        plan, new_state, scope: Scope) -> None:
        """Run the sentinel before the state is committed: a fatal
        verdict puts the pre-step copies back and raises."""
        if not mode:
            return
        try:
            self._check_numerics(fetch_names, fetches, plan.persist_writes,
                                 new_state, mode)
        except FloatingPointError:
            if backup is not None:
                self._restore_state(scope, backup)
            raise

    def _check_numerics(self, fetch_names, fetches, persist_names,
                        new_state, mode: str) -> None:
        """Post-step NaN/Inf sentinel over every float fetch and written
        persistable: device-side ``isnan``/``isinf`` reductions and ONE
        batched host read of the flags, never a host scan.  ``fatal``
        dumps a flight record and raises ``FloatingPointError`` naming
        the variables; ``warn`` names them, bumps ``numerics.{nan,inf}``
        and notes the flight ring, and lets the step land."""
        names: List[str] = []
        flags = []
        seen = set()
        for name, val in list(zip(fetch_names, fetches)) + \
                list(zip(persist_names, new_state)):
            if name in seen:  # a fetched persistable counts once
                continue
            v = val.values if isinstance(val, SelectedRows) else val
            if not isinstance(v, torch.Tensor) or not v.is_floating_point():
                continue
            seen.add(name)
            names.append(name)
            flags.append(torch.isnan(v).any().to(self.device))
            flags.append(torch.isinf(v).any().to(self.device))
        m = _nm()
        m.checked.inc()
        if not names:
            return
        host = torch.stack(flags).cpu().tolist()   # one batched read
        nan_vars = [n for n, f in zip(names, host[0::2]) if f]
        inf_vars = [n for n, f in zip(names, host[1::2]) if f]
        if not nan_vars and not inf_vars:
            return
        m.nan.inc(len(nan_vars))
        m.inf.inc(len(inf_vars))
        from ..observability import flight as _flight
        _flight.note("numerics_sentinel", mode=mode,
                     nan_vars=nan_vars[:16], inf_vars=inf_vars[:16])
        msg = (f"numerics sentinel (FLAGS_numerics_check={mode}): "
               f"NaN in {nan_vars or '[]'}, Inf in {inf_vars or '[]'}")
        if mode == "fatal":
            _flight.dump("numerics_fatal")
            raise FloatingPointError(
                msg + " — step NOT applied (the pre-step state snapshot "
                "is restored into the scope)")
        import sys as _sys
        print("[numerics] " + msg, file=_sys.stderr, flush=True)

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
        """Run ``build_fn()(feed, state, const) -> outs``; returns
        ``(outs, state)`` with ``state`` the same tensors, written in
        place.  Built once per ``(key, feed/state/const signature)``, as
        the reference compiles per signature, in a cache of its own
        under ``FLAGS_executor_cache_capacity``; telemetry as for a
        program run, keyed ``callable:<key>``."""
        tel = _obs_trace.flags_on()
        t_run0 = time.perf_counter_ns() if tel else None
        feed = [self._to_device(v) for v in feed]
        state = list(state)
        const = list(const)
        sig = (self._feed_sig([str(i) for i in range(len(feed))], feed)
               + self._feed_sig([f"s{i}" for i in range(len(state))], state)
               + self._feed_sig([f"c{i}" for i in range(len(const))], const))
        mem_key = ("callable", key, sig, self.training)
        fn = self._cache.get(mem_key)
        cache_hit = fn is not None
        lowering_ms = 0.0
        if fn is None:
            t_low0 = time.perf_counter_ns()
            fn = build_fn()
            lowering_ms = (time.perf_counter_ns() - t_low0) / 1e6
            self._cache[mem_key] = fn
            self._evict_cache_overflow(self._cache)
            if tel:
                self._note_cache_miss(("callable", key, self.training), sig)
        elif tel:
            _em().hits.inc()
        t_disp0 = time.perf_counter_ns()
        with torch.inference_mode():
            outs = fn(feed, state, const)
        if tel:
            compile_ms = 0.0 if cache_hit else \
                (time.perf_counter_ns() - t_disp0) / 1e6
            m = _em()
            m.steps.inc()
            wall_ms = (time.perf_counter_ns() - t_run0) / 1e6
            m.wall.observe(wall_ms)
            _obs_step.record(_obs_step.StepStats(
                program_key=f"callable:{key}",
                cache_hit=cache_hit,
                lowering_ms=round(lowering_ms, 3),
                compile_ms=round(compile_ms, 3),
                feed_bytes=sum(_obs_step.approx_nbytes(v) for v in feed),
                fetch_bytes=sum(_obs_step.approx_nbytes(v) for v in outs),
                wall_ms=round(wall_ms, 3)))
        return outs, state


def _dtype_name(v) -> str:
    """The IR dtype name of a tensor or array (``float32``, ``int64``,
    ``bfloat16``)."""
    dt = v.dtype
    if isinstance(dt, torch.dtype):
        return str(dt)[len("torch."):]
    return normalize_dtype(str(dt))


__all__ = ["Executor", "LazyFetch", "RNG_STATE_VAR", "Scope",
           "global_scope", "host_copies", "scope_guard"]
