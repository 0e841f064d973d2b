"""DecodeEngine: token-level continuous batching over the paged cache.

The port of ``paddle_tpu/decode/engine.py``.  One scheduler thread
drives two kinds of dispatch through one
:class:`~paddle_tpu_torch.core.executor.Executor`:

- **prefill** — one dispatch per JOINING request, prompt padded to the
  smallest bucket on the prefill ladder (``FLAGS_decode_prefill_buckets``).
  It writes the prompt's K/V into the request's cache blocks and samples
  the first token, so a joining stream emits at once.  A long new
  prompt costs the in-flight streams one prefill dispatch of latency,
  never a batch-shape change.
- **decode step** — ONE dispatch advances every active slot by one
  token: fixed ``[max_slots]`` shapes, idle slots ride along into the
  reserved trash block.  Requests join (slot assigned at admission) and
  leave (slot freed the moment eos/length finishes it) at token
  granularity — the running batch never drains to reshape.  On the
  card the step's attention is the CUDA kernel
  ``kernels/csrc/paged_decode_attn.cu``, launched once per layer on the
  scheduler thread's current stream.

Admission control: a bounded pending queue (``FLAGS_decode_max_queue``)
sheds with the typed :class:`Overloaded`; an over-budget prompt/output
(off the ladder, or past the block-table context bound) is a typed
:class:`RequestTooLong`.  Blocks are reserved at admission —
``ceil((prompt+max_new)/block_tokens)`` up front — so a running stream
never runs out of cache mid-generation.

Two latched flags rebuild the block lifecycle on the refcounted
allocator (:mod:`paddle_tpu_torch.decode.cache`); both off (default)
keeps every code path, allocation order and metric series of the
legacy engine:

- ``FLAGS_decode_prefix_cache`` — admission walks the prompt's
  block-aligned prefix against a content-addressed
  :class:`~paddle_tpu_torch.decode.cache.PrefixCache` and ADOPTS hits
  as refcounted references, so a shared system prompt prefills once and
  later requests dispatch only a suffix prefill
  (:meth:`TransformerLM.prefill_suffix`).  Full prompt blocks register
  after prefill; zero-ref cached blocks park in an LRU reclaimed under
  pool pressure.  Hits are capped one block short of the prompt so the
  suffix is never empty (the last position's logits seed the stream).
- ``FLAGS_decode_overcommit`` — admission reserves only
  ``ceil((P+1)/block_tokens)`` blocks and the decode step grows one
  block as a stream crosses each block boundary; when growth cannot
  allocate, the NEWEST running stream is preempted (blocks decref'd,
  generated tokens kept host-side on its handle) and re-queued
  head-of-line for re-prefill of ``prompt + generated[:-1]`` — the
  counter-hash sampler is positional, so a resumed stream's remaining
  tokens are identical to an uninterrupted run.  The oldest stream is
  never evicted: it finishes, frees blocks, and the FIFO head (the
  preempted request) re-admits — no livelock.

Writes into a block that is shared (refcount > 1) or advertised by the
prefix cache fork it first — a block copy on the device over every
pool (the int8 scale pools included) plus a block-table remap
(copy-on-write).  Inside this engine streams only ever append past
their adopted prefix, so forks are the beam decoder's path; the
step-side check is the invariant that makes that true by construction.

Observability: ``decode.<name>.*`` counters/gauges/histograms, the
``/decodez`` payload (:meth:`DecodeEngine.decodez`), and the flag-gated
hooks: latency phases and goodput (``FLAGS_phase_attribution``),
capacity (``FLAGS_capacity_attribution``), tenant metering
(``FLAGS_tenant_accounting``), the KV pool in the MemoryLedger with OOM
forensics and recovery (``FLAGS_memory_attribution``), the stream audit
hash, and the fault-injection sites ``decode_prefill``,
``decode_step`` (``delay``/``oom``) and ``decode_preempt``.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .cache import PagedKVCache, PrefixCache, blocks_for
from .model import TransformerLM
from ..core import flags as _flags
from ..core.executor import Executor
from ..distributed import faults as _faults
from ..kernels import quant as _quant_kernels
from ..observability import audit as _audit
from ..observability import capacity as _capacity
from ..observability import memory as _memory
from ..observability import phase as _phase
from ..observability import stats as _obs_stats
from ..observability import tenant as _tenant
from ..platform import get_device
from ..serving.batcher import BucketLadder, Overloaded, RequestTooLong

# decode request phases (FLAGS_phase_attribution): queue = submit ->
# slot claimed, prefill = slot -> first token emitted (the TTFT tail
# minus queue wait), decode = first token -> stream finished.  The
# three sum to the request's end-to-end wall by construction
DECODE_PHASES = ("queue", "prefill", "decode")

class SamplingParams:
    """Per-request sampling config.  ``temperature <= 0`` is greedy;
    ``top_k == 0`` samples the full vocab (under the ``TOPK_MAX``
    ceiling)."""

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 max_new_tokens: int = 32, eos_id: Optional[int] = None,
                 seed: int = 0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.seed = int(seed)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    def to_dict(self) -> dict:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "max_new_tokens": self.max_new_tokens,
                "eos_id": self.eos_id, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingParams":
        return cls(temperature=d.get("temperature", 0.0),
                   top_k=d.get("top_k", 0),
                   max_new_tokens=d.get("max_new_tokens", 32),
                   eos_id=d.get("eos_id"), seed=d.get("seed", 0) or 0)


class DecodeRequest:
    __slots__ = ("rid", "prompt", "sampling", "t_enq", "handle", "tl",
                 "tenant", "resume_tokens")

    def __init__(self, rid: int, prompt: np.ndarray,
                 sampling: SamplingParams,
                 tenant: Optional[str] = None):
        self.rid = rid
        self.prompt = prompt
        self.sampling = sampling
        self.tenant = tenant
        # set by preemption: the tokens generated before eviction; a
        # non-None value marks a queued request as a RESUME (re-prefill
        # prompt + resume_tokens[:-1], then continue token-exact)
        self.resume_tokens: Optional[List[int]] = None
        self.t_enq = time.monotonic()
        self.handle = DecodeHandle(rid)
        # phase timeline sharing the enqueue stamp (flag-gated; None
        # keeps the flag-off path allocation-free)
        self.tl = (_phase.PhaseTimeline(t0=self.t_enq)
                   if _phase.enabled() else None)


class DecodeHandle:
    """Client-side view of one generation: iterate for the token
    stream, or :meth:`result` for the aggregate."""

    _DONE = object()

    def __init__(self, rid: int):
        self.rid = rid
        self._q: "queue.Queue" = queue.Queue()
        self._tokens: List[int] = []
        self._logits: List[np.ndarray] = []   # capture_logits engines only
        self._final: Optional[dict] = None
        self._err: Optional[BaseException] = None
        self._done = threading.Event()
        self._cancelled = threading.Event()

    # -- engine side -------------------------------------------------------
    def _emit(self, token: int, logits: Optional[np.ndarray]) -> None:
        self._tokens.append(int(token))
        if logits is not None:
            self._logits.append(logits)
        self._q.put(int(token))

    def _finish(self, reason: str) -> None:
        self._final = {"tokens": list(self._tokens), "finish": reason,
                       "n_tokens": len(self._tokens)}
        self._done.set()
        self._q.put(self._DONE)

    def _fail(self, exc: BaseException) -> None:
        self._err = exc
        self._done.set()
        self._q.put(self._DONE)

    # -- client side -------------------------------------------------------
    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def next_token(self, timeout: Optional[float] = None):
        """One token id, or None when the stream is finished; raises
        TimeoutError if the engine produces nothing for ``timeout``
        seconds."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"decode request {self.rid}: no token within {timeout}s")
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            return None
        return item

    def cancel(self) -> None:
        """Abandon the generation: the engine retires the request's
        slot (freeing its cache blocks) at the next step boundary, or
        drops it from the pending queue at the next admission sweep.
        No-op once the stream already finished."""
        if not self._done.is_set():
            self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"decode request {self.rid} still running")
        if self._err is not None:
            raise self._err
        return dict(self._final)

    @property
    def tokens(self) -> List[int]:
        return list(self._tokens)

    @property
    def logits(self) -> List[np.ndarray]:
        return list(self._logits)


class _Slot:
    __slots__ = ("req", "blocks", "pos_next", "n_generated", "last_token",
                 "t_last", "cached_tokens", "seq")

    def __init__(self, req: DecodeRequest, blocks: List[int],
                 prompt_len: int, first_token: int,
                 cached_tokens: int = 0, seq: Optional[np.ndarray] = None):
        self.req = req
        self.blocks = blocks
        self.pos_next = prompt_len   # where the last sampled token's
        self.n_generated = 1         # K/V lands on the next step
        self.last_token = first_token
        self.t_last = time.monotonic()
        # prefix-cache / resume bookkeeping (0 / None on the legacy
        # path): positions [0, cached_tokens) are already resident in
        # adopted blocks; ``seq`` is the full token sequence prefill
        # must make resident (prompt, or prompt+generated[:-1] on a
        # preemption resume)
        self.cached_tokens = cached_tokens
        self.seq = seq


class _LatencyStats:
    """The flag-gated token-level latency + goodput bundle
    (``FLAGS_phase_attribution``): created on first use so a flag-off
    process never registers these series.

    - ``ttft_ms``: submit -> first token emitted (queue + prefill; what
      a streaming client perceives as time-to-first-token);
    - ``tbt_ms``: per-stream inter-token interval (time between
      tokens), the token-level tail SLO metric — an SLO rule on
      ``decode.<name>.ttft_ms:p99`` / ``tbt_ms:p99`` reads these;
    - goodput accounting: every decode-step lane is either useful
      (live stream) or padding (inactive slot riding into the trash
      block), every prefill token either real prompt or bucket pad,
      and cancelled streams generated into the void — the counters
      say how much of the device time bought tokens a client kept.
      (Preemption re-prefill compute is accounted separately in
      :class:`_PrefixStats` — ``preempt_reprefill_tokens``.)
    """

    def __init__(self, name: str):
        sc = _obs_stats.scope(f"decode.{name}")
        self.ttft_ms = sc.histogram(
            "ttft_ms", help_str="time to first token: submit -> first "
            "token emitted (queue wait + prefill dispatch)")
        self.tbt_ms = sc.histogram(
            "tbt_ms", help_str="time between tokens, per stream (the "
            "client-perceived per-token latency)")
        self.live_slot_steps = sc.counter(
            "goodput_live_slot_steps", "decode-step lanes that advanced "
            "a live stream (useful device work)")
        self.pad_slot_steps = sc.counter(
            "goodput_pad_slot_steps", "decode-step lanes dispatched for "
            "INACTIVE slots (padding riding into the trash block)")
        self.prefill_tokens = sc.counter(
            "goodput_prefill_tokens", "real prompt tokens prefilled")
        self.pad_prefill_tokens = sc.counter(
            "goodput_pad_prefill_tokens", "pad tokens added snapping "
            "prompts onto the prefill bucket ladder")
        self.cancelled = sc.counter(
            "cancelled", "streams abandoned by their client (engine "
            "retired the slot / dropped the queued request)")
        self.cancelled_tokens = sc.counter(
            "cancelled_tokens", "tokens generated for streams later "
            "cancelled (device work no client kept)")
        self.phases = _phase.PhaseRecorder(f"decode.{name}",
                                           DECODE_PHASES)

    def goodput(self) -> dict:
        live = self.live_slot_steps.value
        pad = self.pad_slot_steps.value
        pre = self.prefill_tokens.value
        pre_pad = self.pad_prefill_tokens.value
        return {
            "live_slot_steps": live, "pad_slot_steps": pad,
            "slot_utilization": round(live / max(live + pad, 1), 4),
            "prefill_tokens": pre, "pad_prefill_tokens": pre_pad,
            "prefill_efficiency": round(pre / max(pre + pre_pad, 1), 4),
            "cancelled": self.cancelled.value,
            "cancelled_tokens": self.cancelled_tokens.value,
        }


class _PrefixStats:
    """Refcounted-pool metric bundle: prefix-cache hit accounting,
    copy-on-write forks, preemption/resume accounting and the pool
    leak invariant.  Created only when ``FLAGS_decode_prefix_cache``
    or ``FLAGS_decode_overcommit`` latched on at engine construction,
    so a flags-off process registers none of these series (the
    byte-identical metric-surface pin)."""

    def __init__(self, name: str):
        sc = _obs_stats.scope(f"decode.{name}")
        self.prefix_lookups = sc.counter(
            "prefix_lookups", "full prompt blocks walked against the "
            "prefix cache at admission (the hit-rate denominator)")
        self.prefix_hits = sc.counter(
            "prefix_hits", "blocks adopted from the prefix cache — "
            "prompt positions that did NOT re-prefill")
        self.prefix_inserts = sc.counter(
            "prefix_inserts", "freshly prefilled full blocks registered "
            "into the prefix cache")
        self.prefix_evictions = sc.counter(
            "prefix_evictions", "parked zero-ref cached blocks reclaimed "
            "to the free list under pool pressure (LRU order)")
        self.prefix_collisions = sc.counter(
            "prefix_collisions", "hash hits rejected by the full "
            "token-id verify (served as a miss, never as wrong K/V)")
        self.saved_prefill_tokens = sc.counter(
            "prefix_saved_prefill_tokens", "prompt tokens whose prefill "
            "compute was skipped via adopted cached blocks")
        self.cow_forks = sc.counter(
            "cow_forks", "shared blocks forked (device block-copy + "
            "table remap) on the first divergent write")
        self.preempts = sc.counter(
            "preempts", "running streams evicted by overcommit pressure "
            "(blocks freed, generated tokens kept host-side)")
        self.preempt_resumes = sc.counter(
            "preempt_resumes", "preempted streams re-admitted via "
            "re-prefill")
        self.reprefill_tokens = sc.counter(
            "preempt_reprefill_tokens", "tokens re-prefilled resuming "
            "preempted streams (overcommit's compute cost)")
        self.blocks_referenced = sc.gauge("blocks_referenced")
        self.blocks_cached = sc.gauge("blocks_cached")
        self.blocks_leaked = sc.gauge(
            "blocks_leaked", "pool invariant: usable blocks neither "
            "free, referenced nor cached — MUST be zero")


class _EngineStats:
    def __init__(self, name: str):
        self._name = name
        self._lat_lock = threading.Lock()
        self._lat: Optional[_LatencyStats] = None
        sc = _obs_stats.scope(f"decode.{name}")
        self.tokens = sc.counter("tokens", "generated tokens (all streams)")
        self.prefills = sc.counter("prefills")
        self.joins = sc.counter(
            "joins", "requests admitted into the running decode batch")
        self.leaves = sc.counter(
            "leaves", "requests retired from the running batch (eos/length)")
        self.shed = sc.counter(
            "shed", "requests refused by admission control (typed "
            "Overloaded/RequestTooLong)")
        self.steps = sc.counter("steps", "decode-step dispatches")
        self.queue = sc.gauge("queue_depth")
        self.active = sc.gauge("slots_active")
        self.blocks_free = sc.gauge("blocks_free")
        self.step_ms = sc.histogram("step_ms")
        self.prefill_ms = sc.histogram("prefill_ms")
        self.token_ms = sc.histogram(
            "token_ms",
            help_str="per-stream inter-token interval (what a client "
                     "perceives as per-token latency)")

    def latency(self) -> _LatencyStats:
        """The flag-gated bundle (lazy: see :class:`_LatencyStats`)."""
        with self._lat_lock:
            if self._lat is None:
                self._lat = _LatencyStats(self._name)
            return self._lat

    @property
    def lat(self) -> Optional[_LatencyStats]:
        return self._lat

    def capacity_tracker(self) -> "_capacity.CapacityTracker":
        """Get-or-create this engine's capacity tracker (callers gate
        on ``_capacity.enabled()`` so a flag-off process never
        registers ``decode.<name>.util.*`` series)."""
        return _capacity.tracker(f"decode.{self._name}",
                                 ("prefill", "decode"))

    def capacity(self) -> Optional["_capacity.CapacityTracker"]:
        return _capacity.get(f"decode.{self._name}")




class DecodeEngine:
    """One model's stateful generative scheduler (module doc).  Runs
    on the model's device, which must be ``device`` (``cuda:0`` by
    default; the CPU only when asked for)."""

    def __init__(self, model: TransformerLM,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 name: str = "lm",
                 max_slots: Optional[int] = None,
                 block_tokens: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_buckets=None,
                 max_queue: Optional[int] = None,
                 executor: Optional[Executor] = None,
                 capture_logits: bool = False,
                 cache_dtype: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 overcommit: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = get_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        if params is not None:
            model.load_numpy(params)
        self.model = model
        self.name = name
        cfg = model.config
        self.max_slots = int(_flags.get_flags("decode_max_slots")
                             if max_slots is None else max_slots)
        self.max_queue = int(_flags.get_flags("decode_max_queue")
                             if max_queue is None else max_queue)
        bs = int(_flags.get_flags("decode_block_tokens")
                 if block_tokens is None else block_tokens)
        # block TABLE width: enough blocks per slot for a full-length
        # context
        self.max_blocks_per_seq = blocks_for(cfg.max_seq_len, bs)
        if num_blocks is None:
            num_blocks = 1 + self.max_slots * self.max_blocks_per_seq
        if cache_dtype is None:
            cache_dtype = str(_flags.get_flags("decode_kv_dtype"))
        self.cache = PagedKVCache(cfg.n_layer, cfg.n_head, cfg.head_dim,
                                  num_blocks, bs, dtype=cache_dtype,
                                  device=self.device)
        ladder = (prefill_buckets if prefill_buckets is not None
                  else BucketLadder.parse(
                      _flags.get_flags("decode_prefill_buckets")))
        sizes = sorted({int(b) for b in
                        (ladder.sizes if isinstance(ladder, BucketLadder)
                         else ladder) if int(b) <= cfg.max_seq_len})
        if not sizes:
            sizes = [cfg.max_seq_len]
        self.prefill_ladder = BucketLadder(sizes)
        self.capture_logits = capture_logits
        self._exe = executor if executor is not None \
            else Executor(self.device)
        if self._exe.device != self.device:
            raise ValueError(f"executor is on {self._exe.device}, engine "
                             f"on {self.device}")
        self.stats = _EngineStats(name)
        # refcounted block lifecycle (module doc) — latched here; both
        # flags off keeps the legacy single-owner paths
        self._prefix_on = bool(_flags.get_flags("decode_prefix_cache")
                               if prefix_cache is None else prefix_cache)
        self._overcommit_on = bool(_flags.get_flags("decode_overcommit")
                                   if overcommit is None else overcommit)
        self._refc = self._prefix_on or self._overcommit_on
        self.prefix = (PrefixCache(
            self.cache.allocator, bs,
            model_key=f"{name}/{cfg.vocab}x{cfg.d_model}x{cfg.n_layer}")
            if self._prefix_on else None)
        self._pstats = _PrefixStats(name) if self._refc else None
        if self._refc:
            # suffix / resume bucket ladder: a prefix-hit suffix (or a
            # preemption re-prefill, whose length can exceed the
            # prefill ladder) snaps onto block-size doublings so a
            # handful of shapes cover every residual length
            limit = self.max_context()
            sizes2 = set(self.prefill_ladder.sizes)
            b2 = bs
            while b2 < limit:
                sizes2.add(b2)
                b2 *= 2
            sizes2.add(limit)
            self._resume_ladder = BucketLadder(sorted(sizes2))

        self._lock = threading.Condition()
        self._pending: List[DecodeRequest] = []
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        # decode-step feed rows (host mirrors of the fixed-shape feeds)
        self._tables = np.zeros((self.max_slots, self.max_blocks_per_seq),
                                np.int32)
        self._rid = itertools.count(1)
        self._closed = False
        # memory anatomy (FLAGS_memory_attribution): the KV block pool
        # registers on the process MemoryLedger with its tensors — pool
        # bytes, per-state block counts (incl. parked LRU blocks),
        # bytes-per-resident-stream — and its refcount invariant feeds
        # the leak sentinel.  Flag off: no pool, no series, no thread
        self._block_bytes = self.cache.nbytes // max(self.cache.num_blocks,
                                                     1)
        if self.cache.quantized:
            # /quantz: advertise the quantized pool (bytes per block
            # INCLUDING the parallel scale pools)
            _quant_kernels.note_kv_cache(name, {
                "dtype": self.cache.dtype,
                "num_blocks": self.cache.num_blocks,
                "block_tokens": bs,
                "bytes_per_block": self._block_bytes,
                "pool_bytes": self.cache.nbytes,
            })
        self._mem_pool: Optional[str] = None
        if _memory.enabled():
            self._mem_pool = f"decode_kv.{name}"
            _memory.pool(self._mem_pool, "device",
                         self._mem_pool_snapshot,
                         audit=self._mem_pool_audit, device=self.device,
                         tensors=self.cache.state)
            _memory.maybe_start_sentinel()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"decode-sched-{name}")
        self._thread.start()

    # -- admission ---------------------------------------------------------
    def max_context(self) -> int:
        return min(self.model.config.max_seq_len,
                   self.cache.max_context(self.max_blocks_per_seq))

    def submit(self, prompt, sampling: Optional[SamplingParams] = None,
               tenant: Optional[str] = None) -> DecodeHandle:
        """Enqueue one generation.  ``tenant`` is an optional
        client-supplied id for per-tenant usage metering
        (``FLAGS_tenant_accounting``; ignored when off).  Raises
        :class:`RequestTooLong` (prompt off the prefill ladder or
        prompt+budget past the context bound) or :class:`Overloaded`
        (queue bound) — both typed, never queued."""
        sampling = sampling or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.model.config.vocab:
            # an out-of-range id would be a device-side assert on the
            # card, which poisons the whole CUDA context
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.model.config.vocab})")
        limit = self.max_context()
        if prompt.size > self.prefill_ladder.max:
            self.stats.shed.inc()
            raise RequestTooLong(self.name, "prompt", prompt.size,
                                 self.prefill_ladder.max)
        if prompt.size + sampling.max_new_tokens > limit:
            self.stats.shed.inc()
            raise RequestTooLong(
                self.name, "prompt+max_new_tokens",
                prompt.size + sampling.max_new_tokens, limit)
        need = blocks_for(prompt.size + sampling.max_new_tokens,
                          self.cache.block_tokens)
        if need > self.cache.num_blocks - 1:
            # could never be admitted even with the pool idle — typed
            # rejection now, not a head-of-line livelock later
            self.stats.shed.inc()
            raise RequestTooLong(
                self.name, "blocks",
                need * self.cache.block_tokens,
                (self.cache.num_blocks - 1) * self.cache.block_tokens)
        req = DecodeRequest(next(self._rid), prompt, sampling,
                            tenant=tenant)
        if _tenant.enabled():
            _tenant.account(tenant, requests=1)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"decode engine {self.name!r} is closed")
            if len(self._pending) >= self.max_queue:
                self.stats.shed.inc()
                raise Overloaded(self.name, len(self._pending),
                                 self.max_queue)
            self._pending.append(req)
            self.stats.queue.set(len(self._pending))
            self._lock.notify_all()
        return req.handle

    def generate(self, prompt, timeout: Optional[float] = 120.0,
                 **sampling_kw) -> dict:
        """Blocking convenience over :meth:`submit`."""
        return self.submit(
            prompt, SamplingParams(**sampling_kw)).result(timeout=timeout)

    # -- scheduler loop ----------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._closed and not self._pending and \
                        not any(self._slots):
                    self._lock.wait()
                if self._closed:
                    pending = self._pending
                    self._pending = []
                    break_slots = [s for s in self._slots if s is not None]
                    break
                admit = self._admissible_locked()
            for req in admit:
                try:
                    self._prefill(req)
                except Exception as e:   # noqa: BLE001 — fail ONE stream
                    _memory.oom_forensics(e, "decode_prefill")
                    self._release(req, error=e)
            if any(s is not None for s in self._slots):
                try:
                    self._decode_step()
                except Exception as e:   # noqa: BLE001 — the handles
                    if not self._recover_oom(e):   # carry the fault
                        self._fail_all(e)          # to the callers
        for req in pending:
            req.handle._fail(RuntimeError("decode engine closed"))
        for slot in break_slots:
            slot.req.handle._fail(RuntimeError("decode engine closed"))

    def _admissible_locked(self) -> List[DecodeRequest]:
        """Pop every pending request that has a free slot AND a full
        block reservation right now (called under the lock)."""
        out = []
        # cancelled-before-admission requests drop from the queue head
        # (a vanished client must not hold a queue slot); they never
        # joined, so they count neither join nor leave
        while self._pending and self._pending[0].handle.cancelled:
            dropped = self._pending.pop(0)
            if dropped.tl is not None:
                self.stats.latency().cancelled.inc()
            dropped.handle._finish("cancelled")
        bs = self.cache.block_tokens
        for i, slot in enumerate(self._slots):
            if slot is not None or not self._pending:
                continue
            req = self._pending[0]
            resume = req.resume_tokens is not None
            if resume and len(req.resume_tokens) > 1:
                # re-prefill target: prompt + generated[:-1]; the LAST
                # generated token's K/V is written by the next decode
                # step (exactly the post-prefill slot contract)
                seq = np.concatenate(
                    [req.prompt,
                     np.asarray(req.resume_tokens[:-1], np.int32)])
            else:
                seq = req.prompt
            L = int(seq.size)
            if self._overcommit_on:
                # lazy reservation: enough for the resident sequence
                # plus the next write position; the decode step grows
                # one block per boundary crossing (or preempts)
                need = blocks_for(L + 1, bs)
                if self._mem_pool is not None and \
                        not self._admit_headroom_ok(need):
                    break   # measured bytes say no room: FIFO head
            else:           # waits for a release, like an alloc miss
                need = blocks_for(
                    req.prompt.size + req.sampling.max_new_tokens, bs)
            acquired: List[int] = []
            start = 0
            if self.prefix is not None:
                # cap one block short of the sequence: prefill must
                # compute >= 1 real position (the stream's next logits)
                cap = min((L - 1) // bs, need)
                if cap > 0:
                    c0 = self.prefix.collisions
                    hits = self.prefix.match(seq, cap)
                    self._pstats.prefix_lookups.inc(cap)
                    dc = self.prefix.collisions - c0
                    if dc:
                        self._pstats.prefix_collisions.inc(dc)
                    # acquire BEFORE the fresh alloc: a referenced hit
                    # cannot be stolen by the LRU reclaim that alloc
                    # may trigger under pressure
                    acquired = [self.prefix.acquire(k) for k, _ in hits]
                    start = len(acquired) * bs
            blocks = self._alloc_blocks(need - len(acquired))
            if blocks is None:
                for b in acquired:       # re-park the hits; FIFO head
                    self.cache.allocator.decref(b)   # waits for blocks
                break
            if self._mem_pool is not None and blocks:
                _memory.note_event("alloc", self._mem_pool,
                                   len(blocks) * self._block_bytes,
                                   rid=req.rid)
            blocks = acquired + blocks
            if _tenant.enabled():
                # resident KV attribution: the stream now holds a ref
                # on every one of its blocks (prefix hits included);
                # the matching negative delta files at retire/preempt
                _tenant.account(req.tenant, resident_kv_bytes=(
                    len(blocks) * self._block_bytes))
            if start:
                self._pstats.prefix_hits.inc(len(acquired))
                self._pstats.saved_prefill_tokens.inc(start)
            self._pending.pop(0)
            # the slot is claimed NOW (table row filled) so a later
            # admission in the same sweep can't take it
            row = self._tables[i]
            row[:] = 0
            row[:len(blocks)] = blocks
            self._slots[i] = _Slot(req, blocks, L,
                                   first_token=-1,   # token set by prefill
                                   cached_tokens=start,
                                   seq=seq if (start or resume) else None)
            if req.tl is not None and not resume:
                req.tl.stamp("queue")   # queue wait ends at slot claim
            if not resume:
                self.stats.joins.inc()   # every join has a matching
            out.append(req)              # leave through _retire
        self.stats.queue.set(len(self._pending))
        self.stats.blocks_free.set(self.cache.allocator.free_blocks)
        self.stats.active.set(sum(s is not None for s in self._slots))
        if self._refc:
            self._update_pool_gauges()
        return out

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Allocator alloc with prefix-cache backpressure: a miss
        reclaims parked (zero-ref cached) blocks LRU-first and retries
        — a cached block is only ever a loan from the free pool."""
        got = self.cache.allocator.alloc(n)
        if got is None and self.prefix is not None:
            freed = self.prefix.reclaim(
                n - self.cache.allocator.free_blocks)
            if freed:
                self._pstats.prefix_evictions.inc(freed)
                if self._mem_pool is not None:
                    _memory.note_event("reclaim", self._mem_pool,
                                       freed * self._block_bytes)
                got = self.cache.allocator.alloc(n)
        return got

    def _slot_of(self, req: DecodeRequest):
        for i, s in enumerate(self._slots):
            if s is not None and s.req is req:
                return i, s
        raise KeyError(f"request {req.rid} has no slot")

    def _logits_np(self, logits) -> Optional[np.ndarray]:
        return logits.float().cpu().numpy() if self.capture_logits else None

    # -- dispatches --------------------------------------------------------
    def _builder(self, method: str):
        """``build_fn`` for ``run_callable``: call the model's ``method``
        (prefill, prefill_suffix or decode_step) on the cache pools,
        which it writes in place — the int8 scale pools ride along when
        quantized."""
        model = self.model

        def build():
            def fn(feed, state, const):
                kc, vc, *scales = state
                ks, vs = scales if scales else (None, None)
                return list(getattr(model, method)(kc, vc, *feed,
                                                   ks=ks, vs=vs))
            return fn
        return build

    def _seed(self, req: DecodeRequest) -> np.int64:
        return np.int64(req.sampling.seed & 0xFFFFFFFF)

    def _prefill(self, req: DecodeRequest) -> None:
        t0 = time.perf_counter()
        i, slot = self._slot_of(req)
        if req.handle.cancelled:   # client vanished between admit and here
            self._retire(i, slot, "cancelled")
            return
        if req.resume_tokens is not None or slot.cached_tokens > 0:
            self._prefill_partial(i, slot, req, t0)
            return
        P = req.prompt.size
        bucket = self.prefill_ladder.snap(P)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :P] = req.prompt
        feed = [tokens,
                np.int32(P),
                self._tables[i].copy(),
                self._seed(req),
                np.float32(req.sampling.temperature),
                np.int32(req.sampling.top_k)]
        # chaos hook: `delay:decode_prefill` sleeps here, inside the
        # prefill phase / TTFT window
        _faults.event("decode_prefill")
        (tok, logits), _ = self._exe.run_callable(
            f"decode/{self.name}/prefill/{bucket}",
            self._builder("prefill"), feed,
            state=self.cache.state())
        first = int(tok)
        slot.last_token = first
        slot.t_last = time.monotonic()
        self.stats.prefills.inc()
        self.stats.tokens.inc()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        self.stats.prefill_ms.observe(prefill_ms)
        self._note_prefill(req, slot, prefill_ms, bucket, P)
        self._register_prefix(slot, req.prompt)
        req.handle._emit(first, self._logits_np(logits))
        self._maybe_finish(i, slot, first)

    def _note_prefill(self, req: DecodeRequest, slot: _Slot,
                      prefill_ms: float, bucket: int, n: int) -> None:
        """The flag-gated hooks of one prefill of ``n`` real tokens."""
        if _capacity.enabled():
            # the engine thread is serial: prefill wall IS busy time
            self.stats.capacity_tracker().note(
                "prefill", prefill_ms, bucket=bucket, work=1)
        if _tenant.enabled():
            # a prefill serves exactly one request: its whole wall is
            # that tenant's device time
            _tenant.account(req.tenant, prefill_tokens=n,
                            device_ms=prefill_ms)
        if req.tl is not None and req.resume_tokens is None:
            req.tl.stamp("prefill", t=slot.t_last)
            lat = self.stats.latency()
            lat.ttft_ms.observe((slot.t_last - req.t_enq) * 1e3)
            lat.prefill_tokens.inc(n)
            lat.pad_prefill_tokens.inc(bucket - n)

    def _prefill_partial(self, i: int, slot: _Slot, req: DecodeRequest,
                         t0: float) -> None:
        """Prefill with a resident prefix (prefix-cache hits) and/or a
        preemption resume: only positions [start, L) dispatch, via
        :meth:`TransformerLM.prefill_suffix` (a full re-prefill when
        start == 0 rides the dense :meth:`TransformerLM.prefill` on
        the wider resume ladder).  On resume the sampled token is
        DISCARDED and the slot restored to its pre-eviction state —
        the next decode step re-samples token index n_generated, which
        the positional counter-hash makes identical to the token the
        stream would have produced uninterrupted."""
        resume = req.resume_tokens is not None
        seq = slot.seq if slot.seq is not None else req.prompt
        L = int(seq.size)
        start = slot.cached_tokens
        n = L - start
        bucket = self._resume_ladder.snap(n)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = seq[start:]
        sampling = [self._tables[i].copy(), self._seed(req),
                    np.float32(req.sampling.temperature),
                    np.int32(req.sampling.top_k)]
        if start > 0:
            feed = [tokens, np.int32(start), np.int32(L)] + sampling
            key, method = (f"decode/{self.name}/prefill_sfx/{bucket}",
                           "prefill_suffix")
        else:
            feed = [tokens, np.int32(L)] + sampling
            key, method = f"decode/{self.name}/prefill/{bucket}", "prefill"
        _faults.event("decode_prefill")
        (tok, logits), _ = self._exe.run_callable(
            key, self._builder(method), feed, state=self.cache.state())
        slot.t_last = time.monotonic()
        self.stats.prefills.inc()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        self.stats.prefill_ms.observe(prefill_ms)
        self._note_prefill(req, slot, prefill_ms, bucket, n)
        self._register_prefix(slot, seq)
        if resume:
            # restore the evicted stream's exact slot state; the
            # freshly sampled token is a DISCARD (the client already
            # has the token it re-derives)
            gen = req.resume_tokens
            slot.pos_next = L
            slot.n_generated = len(gen)
            slot.last_token = int(gen[-1])
            req.resume_tokens = None
            self._pstats.preempt_resumes.inc()
            self._pstats.reprefill_tokens.inc(n)
            return
        first = int(tok)
        slot.last_token = first
        self.stats.tokens.inc()
        req.handle._emit(first, self._logits_np(logits))
        self._maybe_finish(i, slot, first)

    def _register_prefix(self, slot: _Slot, seq: np.ndarray) -> None:
        """Advertise the slot's freshly prefilled FULL blocks in the
        prefix cache (content is immutable from here: the stream only
        ever appends past them).  Hit blocks [0, cached_tokens) are
        already registered."""
        if self.prefix is None:
            return
        bs = self.cache.block_tokens
        toks = [int(t) for t in seq]
        keys = self.prefix.chain_keys(toks)
        inserted = 0
        for bi in range(slot.cached_tokens // bs, len(seq) // bs):
            if self.prefix.insert(keys[bi], toks[:(bi + 1) * bs],
                                  slot.blocks[bi]):
                inserted += 1
        if inserted:
            self._pstats.prefix_inserts.inc(inserted)

    def _decode_step(self) -> None:
        t0 = time.perf_counter()
        # retire cancelled slots FIRST: they must not burn a batch lane
        # generating for a vanished reader
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.handle.cancelled:
                self._retire(i, slot, "cancelled")
        if self._refc:
            # overcommit growth + copy-on-write forks (may preempt);
            # the feed below is built only after the tables settled
            self._ensure_blocks()
        tokens = np.zeros((self.max_slots,), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        seeds = np.zeros((self.max_slots,), np.int64)
        steps = np.zeros((self.max_slots,), np.int32)
        temps = np.zeros((self.max_slots,), np.float32)
        topks = np.zeros((self.max_slots,), np.int32)
        tables = self._tables.copy()
        live = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                tables[i, :] = 0   # trash block: masked garbage
                continue
            live.append(i)
            tokens[i] = slot.last_token
            positions[i] = slot.pos_next
            seeds[i] = slot.req.sampling.seed & 0xFFFFFFFF
            steps[i] = slot.n_generated   # this dispatch samples token
            temps[i] = slot.req.sampling.temperature  # index n_generated
            topks[i] = slot.req.sampling.top_k
        if not live:
            return
        # chaos hooks: `delay:decode_step` sleeps inside the decode
        # phase; `oom:decode_step` raises the injected out-of-memory
        # error exactly where a real allocation failure would surface,
        # so OOM forensics + preempt-and-recover are drillable
        _faults.event("decode_step")
        _faults.oom_fault("decode_step")
        (toks, logits), _ = self._exe.run_callable(
            f"decode/{self.name}/step", self._builder("decode_step"),
            [tokens, positions, tables, seeds, steps, temps, topks],
            state=self.cache.state())
        toks_np = toks.cpu().numpy()
        logits_np = self._logits_np(logits)
        now = time.monotonic()
        self.stats.steps.inc()
        step_ms = (time.perf_counter() - t0) * 1e3
        self.stats.step_ms.observe(step_ms)
        if _capacity.enabled():
            self.stats.capacity_tracker().note(
                "decode", step_ms, work=len(live))
        if _tenant.enabled():
            # the fixed-width step's wall splits evenly over the LIVE
            # slots (pad lanes belong to nobody), so per-tenant
            # device-ms sums to the measured step wall
            share = step_ms / len(live)
            for i in live:
                _tenant.account(self._slots[i].req.tenant,
                                decode_tokens=1, device_ms=share)
        lat = self.stats.latency() if _phase.enabled() else None
        if lat is not None:
            lat.live_slot_steps.inc(len(live))
            lat.pad_slot_steps.inc(self.max_slots - len(live))
        for i in live:
            slot = self._slots[i]
            tok = int(toks_np[i])
            slot.pos_next += 1
            slot.n_generated += 1
            slot.last_token = tok
            self.stats.tokens.inc()
            self.stats.token_ms.observe((now - slot.t_last) * 1e3)
            if lat is not None:
                lat.tbt_ms.observe((now - slot.t_last) * 1e3)
            slot.t_last = now
            slot.req.handle._emit(
                tok, logits_np[i] if logits_np is not None else None)
            self._maybe_finish(i, slot, tok)

    # -- refcounted block lifecycle (prefix cache / overcommit) ------------
    def _ensure_blocks(self) -> None:
        """Make every live slot's write-target block PRESENT (overcommit
        growth: one block per boundary crossing) and PRIVATE (fork a
        block that is shared or advertised by the prefix cache before
        writing into it).  Runs before each step dispatch; allocation
        failure preempts the newest stream and retries — bounded by the
        live-slot count, and the oldest stream is never evicted, so the
        engine always makes forward progress."""
        bs = self.cache.block_tokens
        alloc = self.cache.allocator
        for i in range(self.max_slots):
            slot = self._slots[i]
            if slot is None:
                continue
            j = slot.pos_next // bs
            while j >= len(slot.blocks):
                got = self._alloc_blocks(1)
                if got is not None:
                    with self._lock:
                        slot.blocks.append(got[0])
                        self._tables[i, len(slot.blocks) - 1] = got[0]
                    if self._mem_pool is not None:
                        _memory.note_event("alloc", self._mem_pool,
                                           self._block_bytes,
                                           rid=slot.req.rid, grow=True)
                    if _tenant.enabled():
                        _tenant.account(slot.req.tenant,
                                        resident_kv_bytes=self._block_bytes)
                    break
                self._preempt_newest()
                if self._slots[i] is None:   # preempted itself
                    break
            slot = self._slots[i]
            if slot is None or j >= len(slot.blocks):
                continue
            b = slot.blocks[j]
            if alloc.refcount(b) > 1 or (self.prefix is not None
                                         and self.prefix.holds(b)):
                nb: Optional[int] = None
                while nb is None:
                    got = self._alloc_blocks(1)
                    if got is not None:
                        nb = got[0]
                        break
                    self._preempt_newest()
                    if self._slots[i] is None:
                        break
                if self._slots[i] is None or nb is None:
                    continue
                self._copy_block(b, nb)
                with self._lock:
                    slot.blocks[j] = nb
                    self._tables[i, j] = nb
                alloc.decref(b)
                self._pstats.cow_forks.inc()
                if self._mem_pool is not None:
                    # net-zero for the tenant (block swap), but the
                    # timeline names the fork
                    _memory.note_event("alloc", self._mem_pool,
                                       self._block_bytes,
                                       rid=slot.req.rid, cow=True)
        self._update_pool_gauges()

    def _preempt_newest(self) -> None:
        """Evict the NEWEST (highest rid) live stream: free its blocks,
        keep its generated tokens host-side on the handle, and requeue
        it head-of-line for re-prefill.  Newest-victim keeps the oldest
        stream running to completion — freed blocks then admit the FIFO
        head (the preempted request), the no-livelock argument."""
        v = None
        for j, s in enumerate(self._slots):
            if s is not None and (v is None or
                                  s.req.rid > self._slots[v].req.rid):
                v = j
        if v is None:
            return
        slot = self._slots[v]
        req = slot.req
        # chaos hook: `kill_after:decode_preempt` dies HERE, mid-
        # eviction — the process vanishes with the pool half-mutated
        _faults.event("decode_preempt")
        parked_before = (self.prefix.parked_blocks
                         if self.prefix is not None else 0)
        with self._lock:
            self._slots[v] = None
            self.cache.allocator.release(slot.blocks)
            self._tables[v, :] = 0
            req.resume_tokens = list(req.handle._tokens)
            self._pending.insert(0, req)
            self.stats.queue.set(len(self._pending))
            self.stats.active.set(
                sum(s is not None for s in self._slots))
            self.stats.blocks_free.set(self.cache.allocator.free_blocks)
            self._lock.notify_all()
        self._pstats.preempts.inc()
        self._note_blocks_released(len(slot.blocks), parked_before,
                                   "preempt", rid=req.rid)
        if _tenant.enabled():
            _tenant.account(req.tenant, resident_kv_bytes=-(
                len(slot.blocks) * self._block_bytes))

    def _copy_block(self, src: int, dst: int) -> None:
        """Block copy on the device (the COW fork): every cache pool
        (codes AND, when quantized, the per-block scale pools) keeps its
        block axis at dim 1, so one loop forks them all — a forked block
        carries its scales.  K/V never round-trip to the host."""
        def build():
            def fn(feed, state, const):
                s, d = (x.reshape(1).long() for x in feed)
                for a in state:
                    a.index_copy_(1, d, a.index_select(1, s))
                return []
            return fn

        self._exe.run_callable(
            f"decode/{self.name}/blkcopy", build,
            [np.int32(src), np.int32(dst)], state=self.cache.state())

    def _update_pool_gauges(self) -> None:
        if not self._refc:
            return
        alloc = self.cache.allocator
        parked = self.prefix.parked_blocks if self.prefix is not None else 0
        self._pstats.blocks_referenced.set(alloc.referenced_blocks)
        self._pstats.blocks_cached.set(parked)
        self._pstats.blocks_leaked.set(alloc.leaked(parked))

    # -- retirement --------------------------------------------------------
    def _maybe_finish(self, i: int, slot: _Slot, token: int) -> None:
        s = slot.req.sampling
        if s.eos_id is not None and token == s.eos_id:
            self._retire(i, slot, "eos")
        elif slot.n_generated >= s.max_new_tokens:
            self._retire(i, slot, "length")

    def _retire(self, i: int, slot: _Slot, reason: str) -> None:
        """Free the slot + its cache blocks and finish the stream
        (eos / length / cancelled all leave through here)."""
        parked_before = (self.prefix.parked_blocks
                         if self.prefix is not None else 0)
        with self._lock:
            self._slots[i] = None
            self.cache.allocator.release(slot.blocks)
            self._tables[i, :] = 0
            self.stats.leaves.inc()
            self.stats.active.set(sum(x is not None for x in self._slots))
            self.stats.blocks_free.set(self.cache.allocator.free_blocks)
            self._update_pool_gauges()
            self._lock.notify_all()   # blocks freed: admit the queue head
        req = slot.req
        self._note_blocks_released(len(slot.blocks), parked_before,
                                   "free", rid=req.rid, reason=reason)
        if _capacity.enabled():
            self.stats.capacity_tracker().note_done(1)
        if _tenant.enabled():
            _tenant.account(
                req.tenant,
                cancellations=1 if reason == "cancelled" else 0,
                resident_kv_bytes=-(len(slot.blocks) * self._block_bytes),
                latency_ms=(time.monotonic() - req.t_enq) * 1e3)
        if req.tl is not None:
            lat = self.stats.latency()
            if reason == "cancelled":
                lat.cancelled.inc()
                lat.cancelled_tokens.inc(slot.n_generated)
            # close the decode phase (zero-width for a stream finished
            # at its first token) and fold the timeline in: the three
            # phases sum to this request's end-to-end wall
            req.tl.stamp("decode")
            lat.phases.observe(req.tl, rid=req.rid, finish=reason,
                               tokens=slot.n_generated)
        if _audit.enabled() and reason != "cancelled":
            # per-stream token-id rolling hash into the audit ring,
            # keyed by the prompt's content hash so replicas that
            # decoded the SAME prompt are comparable fleet-wide.
            # Cancelled streams truncate at client timing, never at
            # model output — they are not comparable and stay out
            h = _audit.fnv1a64(b"")
            for t in req.handle._tokens:
                h = _audit.fold_token(h, t)
            _audit.note_stream(self.name, "",
                               _audit.request_hash(req.prompt), h)
        req.handle._finish(reason)

    def _release(self, req: DecodeRequest, error) -> None:
        parked_before = (self.prefix.parked_blocks
                         if self.prefix is not None else 0)
        released = 0
        with self._lock:
            for i, s in enumerate(self._slots):
                if s is not None and s.req is req:
                    self.cache.allocator.release(s.blocks)
                    released += len(s.blocks)
                    self._tables[i, :] = 0
                    self._slots[i] = None
                    self.stats.leaves.inc()
            self.stats.blocks_free.set(self.cache.allocator.free_blocks)
            self.stats.active.set(sum(x is not None for x in self._slots))
            self._update_pool_gauges()
        if released:
            self._note_blocks_released(released, parked_before, "free",
                                       rid=req.rid, reason="error")
            if _tenant.enabled():
                _tenant.account(req.tenant, resident_kv_bytes=-(
                    released * self._block_bytes))
        req.handle._fail(error)

    def _fail_all(self, error) -> None:
        parked_before = (self.prefix.parked_blocks
                         if self.prefix is not None else 0)
        released = 0
        with self._lock:
            slots, self._slots = (list(self._slots),
                                  [None] * self.max_slots)
            for s in slots:
                if s is not None:
                    self.cache.allocator.release(s.blocks)
                    released += len(s.blocks)
                    self.stats.leaves.inc()
            self._tables[:] = 0
            self.stats.blocks_free.set(self.cache.allocator.free_blocks)
            self.stats.active.set(0)
            self._update_pool_gauges()
            self._lock.notify_all()
        if released:
            self._note_blocks_released(released, parked_before, "free",
                                       reason="fail_all")
        for s in slots:
            if s is not None:
                if _tenant.enabled():
                    _tenant.account(s.req.tenant, resident_kv_bytes=-(
                        len(s.blocks) * self._block_bytes))
                s.req.handle._fail(error)

    # -- memory anatomy ----------------------------------------------------
    def _mem_pool_snapshot(self) -> dict:
        """The MemoryLedger callback: this engine's KV pool bytes by
        state.  Lock-light (counter reads race admission by at most one
        block — the ledger is a snapshot, not a barrier)."""
        alloc = self.cache.allocator
        parked = (self.prefix.parked_blocks
                  if self.prefix is not None else 0)
        bb = self._block_bytes
        resident = sum(s is not None for s in self._slots)
        out = {"reserved": self.cache.nbytes,
               "used": alloc.referenced_blocks * bb,
               "parked": parked * bb,
               "block_bytes": bb,
               "blocks": {"size": self.cache.num_blocks,
                          "free": alloc.free_blocks,
                          "referenced": alloc.referenced_blocks,
                          "parked": parked},
               "resident_streams": resident}
        if resident:
            out["bytes_per_resident_stream"] = (
                alloc.referenced_blocks * bb // resident)
        return out

    def _mem_pool_audit(self) -> int:
        """The leak sentinel's refcount invariant: blocks neither free
        nor referenced nor parked nor the trash block — must be 0."""
        parked = (self.prefix.parked_blocks
                  if self.prefix is not None else 0)
        return self.cache.allocator.leaked(parked)

    def _note_blocks_released(self, n_blocks: int, parked_before: int,
                              kind: str, **extra) -> None:
        """File block-release events: blocks the prefix cache kept
        (refcount hit zero while advertised) park, the rest free."""
        if self._mem_pool is None or n_blocks <= 0:
            return
        parked_now = (self.prefix.parked_blocks
                      if self.prefix is not None else 0)
        d = min(max(parked_now - parked_before, 0), n_blocks)
        bb = self._block_bytes
        if d:
            _memory.note_event("park", self._mem_pool, d * bb)
        if n_blocks - d:
            _memory.note_event(kind, self._mem_pool,
                               (n_blocks - d) * bb, **extra)

    def _admit_headroom_ok(self, need_blocks: int) -> bool:
        """Overcommit admission's measured-bytes consult: admit only
        while the ledger's byte view of the pool agrees there is room
        (reserved − used; parked bytes are reclaimable so they count
        as headroom).  Attribution that disagrees with the allocator
        would be a bug, so this is a cross-check, not a second
        allocator — and it only exists when the ledger does."""
        p = _memory.get(self._mem_pool)
        if p is None:
            return True
        s = p.snapshot()
        return s["reserved"] - s["used"] >= need_blocks * self._block_bytes

    def _recover_oom(self, error) -> bool:
        """OOM forensics + recovery: an out-of-memory error
        (``torch.cuda.OutOfMemoryError``, or the injected
        ``RESOURCE_EXHAUSTED``) escaping the step dispatch dumps a
        named post-mortem (full ledger, top holders, event tail) and —
        when the refcounted lifecycle is on and a stream is live —
        sheds the NEWEST stream through the existing preemption path
        (counted), so the engine keeps serving instead of failing
        every slot.  Returns False (caller
        falls through to _fail_all) when unarmed or not an OOM."""
        if self._mem_pool is None or not _memory.is_oom(error):
            return False
        _memory.oom_forensics(error, "decode_step")
        if not self._refc or not any(s is not None for s in self._slots):
            return False
        self._preempt_newest()
        _obs_stats.scope(f"decode.{self.name}").counter(
            "oom_recovered", "out-of-memory step dispatches "
            "survived by preempting the newest stream").inc()
        return True

    # -- observability -----------------------------------------------------
    def decodez(self) -> dict:
        """The /decodez payload: slots, cache, queue, recent rates."""
        with self._lock:
            slots = [
                None if s is None else {
                    "rid": s.req.rid, "prompt_len": int(s.req.prompt.size),
                    "generated": s.n_generated,
                    "context_len": int(s.pos_next),
                    "max_new_tokens": s.req.sampling.max_new_tokens}
                for s in self._slots]
            pending = len(self._pending)
        out = {
            "model": self.name,
            "config": self.model.config.to_dict(),
            "cache": self.cache.snapshot(),
            "max_blocks_per_seq": self.max_blocks_per_seq,
            "prefill_buckets": list(self.prefill_ladder.sizes),
            "max_slots": self.max_slots,
            "slots": slots,
            "queue_depth": pending,
            "tokens": self.stats.tokens.value,
            "steps": self.stats.steps.value,
            "prefills": self.stats.prefills.value,
            "joins": self.stats.joins.value,
            "leaves": self.stats.leaves.value,
            "shed": self.stats.shed.value,
        }
        if self._refc:
            # the refcounted block lifecycle (flag-latched; absent
            # flags-off so the payload shape stays byte-identical)
            alloc = self.cache.allocator
            parked = (self.prefix.parked_blocks
                      if self.prefix is not None else 0)
            ps = self._pstats
            out["block_pool"] = {
                "size": self.cache.num_blocks,
                "free": alloc.free_blocks,
                "referenced": alloc.referenced_blocks,
                "cached": parked,
                "leaked": alloc.leaked(parked),
                "cow_forks": ps.cow_forks.value,
                "overcommit": self._overcommit_on,
            }
            if self.prefix is not None:
                lk, ht = ps.prefix_lookups.value, ps.prefix_hits.value
                out["prefix_cache"] = {
                    "entries": len(self.prefix),
                    "cached_blocks": parked,
                    "lookups": lk,
                    "hits": ht,
                    "hit_rate": round(ht / max(lk, 1), 4),
                    "saved_prefill_tokens": ps.saved_prefill_tokens.value,
                    "inserts": ps.prefix_inserts.value,
                    "evictions": ps.prefix_evictions.value,
                    "collisions": self.prefix.collisions,
                }
            if self._overcommit_on:
                out["preemption"] = {
                    "preempts": ps.preempts.value,
                    "resumes": ps.preempt_resumes.value,
                    "reprefill_tokens": ps.reprefill_tokens.value,
                }
        snap = self.stats.step_ms.snapshot()
        if snap.get("count"):
            out["step_p50_ms"] = self.stats.step_ms.percentile(0.50)
            out["step_p99_ms"] = self.stats.step_ms.percentile(0.99)
        tsnap = self.stats.token_ms.snapshot()
        if tsnap.get("count"):
            out["token_p50_ms"] = self.stats.token_ms.percentile(0.50)
            out["token_p99_ms"] = self.stats.token_ms.percentile(0.99)
        lat = self.stats.lat
        if lat is not None:
            # the FLAGS_phase_attribution plane: TTFT/TBT tails,
            # goodput accounting, per-phase attribution
            if lat.ttft_ms.count:
                out["ttft_p50_ms"] = lat.ttft_ms.percentile(0.50)
                out["ttft_p99_ms"] = lat.ttft_ms.percentile(0.99)
            if lat.tbt_ms.count:
                out["tbt_p50_ms"] = lat.tbt_ms.percentile(0.50)
                out["tbt_p99_ms"] = lat.tbt_ms.percentile(0.99)
            out["goodput"] = lat.goodput()
            out["phases"] = lat.phases.snapshot()
        cap = self.stats.capacity()
        if cap is not None:
            out["capacity"] = cap.snapshot()
        return out

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until every accepted request has finished."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._pending or any(s is not None for s in self._slots):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._lock.wait(timeout=min(left, 0.2))
        return True

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout=timeout)
        if self._mem_pool is not None:
            _memory.unregister(self._mem_pool)
        _capacity.unregister(f"decode.{self.name}")


__all__ = ["DECODE_PHASES", "DecodeEngine", "DecodeHandle", "DecodeRequest",
           "SamplingParams"]
