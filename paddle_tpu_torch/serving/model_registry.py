"""Per-server model registry: versioned load, warm pool, atomic hot-swap.

The port of ``paddle_tpu/serving/model_registry.py``.  One
:class:`ModelManager` owns every model a process serves.  Each
``(name, version)`` is a :class:`ServedModel`, a Predictor plus its
:class:`~paddle_tpu_torch.serving.batcher.DynamicBatcher`, and a router
maps model name -> active version.  The hot swap (:meth:`ModelManager.swap`)
is the zero-downtime deploy primitive:

1. **load** version B next to the serving version A (its own scope and
   executor: A keeps serving untouched);
2. **warm** B's whole bucket ladder: one :meth:`Predictor.warm_start`
   per bucket size (the port has no compile cache: this prepares the
   executor's plans and checks the weights are in place);
3. **flip** the router atomically: requests arriving after the flip
   route to B, requests already queued on A stay on A;
4. **drain** A (every accepted request answered) and retire it.

No request is dropped during the flip.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batcher import BucketLadder, DynamicBatcher

# router states a ServedModel moves through (one-way)
LOADING = "LOADING"
SERVING = "SERVING"
DRAINING = "DRAINING"
RETIRED = "RETIRED"


class ServedModel:
    """One (model, version): predictor + batcher + lifecycle state."""

    def __init__(self, name: str, version: str, predictor,
                 batcher: DynamicBatcher):
        self.name = name
        self.version = str(version)
        self.predictor = predictor
        self.batcher = batcher
        self.state = LOADING
        self.loaded_ts = time.time()
        self.warm_info: Optional[dict] = None

    def snapshot(self) -> dict:
        out = {"version": self.version, "state": self.state,
               "loaded_ts": round(self.loaded_ts, 3),
               "buckets": list(self.batcher.ladder.sizes),
               "max_delay_ms": self.batcher.max_delay_ms,
               "max_queue_rows": self.batcher.max_queue_rows,
               "queue_delay_slo_ms": self.batcher.queue_delay_slo_ms,
               "max_seq_len": self.batcher.max_seq_len}
        if self.warm_info is not None:
            out["warm"] = self.warm_info
        out.update(self.batcher.stats.snapshot())
        return out


def ladder_feed_specs(predictor, ladder: BucketLadder,
                      sample_shapes: Optional[Dict[str, Sequence[int]]]
                      = None) -> List[Dict[str, tuple]]:
    """One warm_start feed-spec dict per bucket size, shapes derived
    from the program's static feed declarations
    (:meth:`Predictor.feed_specs_for_batch`); ``sample_shapes``
    overrides/fills feeds whose declarations have symbolic non-batch
    dims (padded sequence models)."""
    return [predictor.feed_specs_for_batch(b, sample_shapes)
            for b in ladder.sizes]


class ModelManager:
    """The server-side model table + router (module doc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[Tuple[str, str], ServedModel] = {}
        self._active: Dict[str, str] = {}        # name -> active version
        self._loading: set = set()   # (name, version) builds in flight

    # -- load / warm -------------------------------------------------------
    def load(self, name: str, version: str, model_dir: Optional[str] = None,
             predictor=None, config=None, warm: bool = True,
             buckets: Optional[Sequence[int]] = None,
             sample_shapes: Optional[Dict[str, Sequence[int]]] = None,
             activate: bool = False, **batcher_kw) -> ServedModel:
        """Load ``(name, version)`` from ``model_dir`` (or take a
        prebuilt ``predictor``), build its batcher, and warm the bucket
        ladder.  ``activate=True`` additionally flips the router (the
        first version of a model usually loads this way)."""
        version = str(version)
        key = (name, version)
        with self._lock:
            # reserve the key under ONE lock hold: two concurrent admin
            # loads of the same version must not both build (the loser's
            # batcher threads would leak when its insert is overwritten)
            if (key in self._models and
                    self._models[key].state != RETIRED) or \
                    key in self._loading:
                raise ValueError(f"model {name}@{version} already loaded")
            self._loading.add(key)
        try:
            if predictor is None:
                if not model_dir:
                    raise ValueError("load needs model_dir or predictor")
                from ..inference.predictor import (AnalysisConfig,
                                                   create_predictor)
                if config is None:
                    config = AnalysisConfig(model_dir)
                else:
                    config.set_model(model_dir)
                predictor = create_predictor(config)
            ladder = (buckets if isinstance(buckets, BucketLadder)
                      else BucketLadder(buckets))
            # warm BEFORE spinning up the batcher threads: a failed warm
            # (unresolvable feed shapes, bad specs) must not leak a
            # scheduler/completer pair parked on an empty queue
            warm_info = (self._warm(predictor, ladder, sample_shapes)
                         if warm else None)
            batcher = DynamicBatcher(predictor, name=f"{name}@{version}",
                                     buckets=ladder, **batcher_kw)
            sm = ServedModel(name, version, predictor, batcher)
            sm.warm_info = warm_info
            with self._lock:
                self._models[key] = sm
        finally:
            with self._lock:
                self._loading.discard(key)
        if activate:
            self.activate(name, version)
        return sm

    @staticmethod
    def _warm(predictor, ladder: BucketLadder, sample_shapes) -> dict:
        """Warm the whole bucket ladder: one :meth:`Predictor.warm_start`
        spec per bucket, so the first request of every bucket finds its
        plan built."""
        t0 = time.perf_counter()
        specs = ladder_feed_specs(predictor, ladder, sample_shapes)
        info = predictor.warm_start(specs)
        info["ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        info["buckets"] = list(ladder.sizes)
        return info

    # -- router ------------------------------------------------------------
    def activate(self, name: str, version: str) -> Optional[ServedModel]:
        """Atomically flip the router to ``version``; returns the
        previously active ServedModel (now DRAINING), or None."""
        version = str(version)
        old = None
        with self._lock:
            sm = self._models.get((name, version))
            if sm is None or sm.state in (DRAINING, RETIRED):
                raise KeyError(f"model {name}@{version} is not loaded")
            prev = self._active.get(name)
            self._active[name] = version
            sm.state = SERVING
            if prev is not None and prev != version:
                old = self._models.get((name, prev))
                if old is not None:
                    old.state = DRAINING
        return old

    def swap(self, name: str, version: str, model_dir: Optional[str] = None,
             predictor=None, config=None,
             buckets: Optional[Sequence[int]] = None,
             sample_shapes: Optional[Dict[str, Sequence[int]]] = None,
             drain_timeout: float = 30.0, **batcher_kw) -> dict:
        """The full hot-swap sequence: load+warm B, flip, drain+retire A.
        Serving continues on A until the flip; the flip is one dict
        write under the router lock."""
        t0 = time.perf_counter()
        sm = self.load(name, version, model_dir=model_dir,
                       predictor=predictor, config=config, warm=True,
                       buckets=buckets, sample_shapes=sample_shapes,
                       **batcher_kw)
        old = self.activate(name, version)
        drained = True
        if old is not None:
            drained = old.batcher.drain(timeout=drain_timeout)
            self.retire(name, old.version)
        return {"model": name, "version": version,
                "previous": old.version if old is not None else None,
                "drained": drained, "warm": sm.warm_info,
                "ms": round((time.perf_counter() - t0) * 1e3, 1)}

    def retire(self, name: str, version: str) -> None:
        """Close a drained version's batcher."""
        with self._lock:
            sm = self._models.get((name, str(version)))
            if sm is None:
                return
            if self._active.get(name) == sm.version:
                raise ValueError(
                    f"cannot retire the ACTIVE version {name}@{version}")
            sm.state = RETIRED
        sm.batcher.close()

    # -- serving -----------------------------------------------------------
    def _route(self, name: str) -> ServedModel:
        with self._lock:
            version = self._active.get(name)
            if version is None:
                raise KeyError(f"no active version for model {name!r}")
            return self._models[(name, version)]

    def serve_request(self, name: str, feed, tenant: Optional[str] = None):
        """Route and submit ONE request: ``(future, served_model)``.
        The ServedModel is the one the future will answer from: reply
        metadata (fetch names) must come from it, not from a re-route
        that a concurrent hot swap may have flipped."""
        sm = self._route(name)
        try:
            return sm.batcher.submit(feed, tenant=tenant), sm
        except RuntimeError as e:
            # lost the race with a hot swap: routed to the draining
            # version in the instant before its batcher closed; the
            # router has flipped by now, so ONE re-route answers on the
            # new version instead of dropping the request
            if "closed" not in str(e):
                raise
            sm = self._route(name)
            return sm.batcher.submit(feed, tenant=tenant), sm

    def submit(self, name: str, feed, tenant: Optional[str] = None):
        return self.serve_request(name, feed, tenant=tenant)[0]

    def infer(self, name: str, feed,
              timeout: Optional[float] = None,
              tenant: Optional[str] = None) -> List[np.ndarray]:
        return self.submit(name, feed,
                           tenant=tenant).result(timeout=timeout)

    def fetch_names(self, name: str) -> List[str]:
        return list(self._route(name).predictor.fetch_names)

    def active_version(self, name: str) -> Optional[str]:
        with self._lock:
            return self._active.get(name)

    def models(self) -> List[ServedModel]:
        with self._lock:
            return list(self._models.values())

    # -- observability -----------------------------------------------------
    def servingz(self) -> dict:
        """The /servingz payload: router + per-version gauges."""
        with self._lock:
            active = dict(self._active)
            models = dict(self._models)
        return {
            "active": active,
            "models": {f"{n}@{v}": sm.snapshot()
                       for (n, v), sm in sorted(models.items())},
        }

    def close(self) -> None:
        with self._lock:
            models = list(self._models.values())
            self._models.clear()
            self._active.clear()
        for sm in models:
            sm.state = RETIRED
            sm.batcher.close()


__all__ = ["DRAINING", "LOADING", "ModelManager", "RETIRED", "SERVING",
           "ServedModel", "ladder_feed_specs"]
