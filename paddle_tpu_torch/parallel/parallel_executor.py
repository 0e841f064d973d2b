"""ParallelExecutor: program execution over a device mesh.

The port of ``paddle_tpu/parallel/parallel_executor.py`` (``:1-516``;
reference: ``paddle/fluid/framework/parallel_executor.cc:58``,
``python/paddle/fluid/parallel_executor.py:32``).  The JAX package
lowers the one program once and jits it over a ``jax.sharding.Mesh``;
GSPMD places feeds and state by the mesh and inserts the collectives.
This first slice of the port's multi-device plane keeps the program
whole and reads the mesh as follows:

- :func:`make_mesh` builds a :class:`Mesh` of ``torch.device`` objects
  with named axes (``make_mesh``, ``:55-66``).  Devices may repeat: a
  mesh of four ``cuda:0`` entries is one card seen as four mesh
  positions, the counterpart of the reference tests' virtual CPU
  devices.
- The program runs once, on the mesh's first device, on the whole
  batch.  Over one device a ``dp``, ``mp`` or ``ep`` axis only places
  data, which leaves every result as GSPMD's single-device one; a mesh
  whose non-``sp`` axes span distinct devices raises
  ``NotImplementedError`` (data parallelism over distinct cards is a
  later slice, ROADMAP "Multiple devices"), never a silent replica.
- The ``sp`` axis is consumed by ``fused_attention impl="ring"``: the
  executor hands its mesh to every rule (``LowerContext.mesh``, the
  ``_mesh()`` hook), and the op cuts the sequence across the devices
  along ``sp`` (``kernels/attention.py: ring_attention``).
- ``GradientScaleStrategy`` rewrites the loss-gradient seed
  (``_prepare_program``, ``:262-298``): kCoeffNumDevice keeps the
  global mean; kOne multiplies the seed by the dp degree (grads sum, not
  average), once, with the reference's idempotence guard; kCustomized
  drops the seed op so the user feeds ``<loss>@GRAD``.
- A last partial batch of a fetch-only program is padded to the dp
  multiple and the padded rows are cut from the fetches
  (``_maybe_pad_partial_batch``, ``:116-155, 191-221``).

Not ported yet (ROADMAP): ``sharding_rules`` (refused when given),
expert parallelism, ``save_sharded_state``/``load_sharded_state``, the
divergence checksum and audit telemetry, ``multihost.py`` and
``scaling.py``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.executor import Executor, Scope, global_scope
from ..core.program import (OP_ROLE_ATTR, OpRole, Program,
                            default_main_program, grad_var_name)
from ..platform import get_device
from .strategy import BuildStrategy, ExecutionStrategy, GradientScaleStrategy

# the mesh axis the ring attention op consumes (its ``sp_axis`` default)
SP_AXIS = "sp"


class Mesh:
    """Devices in an array with one named axis a dimension: the port's
    counterpart of ``jax.sharding.Mesh`` (``devices``, ``axis_names``,
    ``shape`` as an ordered name -> size dict, ``size``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        at = [0] * self.devices.ndim
        at[i] = slice(None)
        return list(self.devices[tuple(at)])

    def spans_distinct(self, axis: str) -> bool:
        """Whether two positions along ``axis`` (all else equal) hold
        different devices."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return bool(np.any(arr != arr[:1]))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _as_device(d) -> torch.device:
    if hasattr(d, "torch_device"):
        d = d.torch_device()
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return get_device(d)
    return d


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The device mesh (the NCCLContextMap analogue,
    ``platform/nccl_helper.h:81``): ``mesh_shape`` name -> size over
    ``devices`` (``cuda:0`` alone when None; places, strings or
    ``torch.device``; repeats allowed); ``{"dp": len(devices)}`` when no
    shape is given."""
    devices = ([get_device()] if devices is None
               else [_as_device(d) for d in devices])
    if not mesh_shape:
        mesh_shape = {"dp": len(devices)}
    axes = list(mesh_shape)
    sizes = [int(mesh_shape[a]) for a in axes]
    n = int(np.prod(sizes))
    if n != len(devices):
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, have "
                         f"{len(devices)} (a device may be listed more "
                         f"than once)")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), axes)


class ParallelExecutor(Executor):
    """Runs one program over a device mesh (module doc); the reference's
    signature (``:80-111``).  ``use_cuda``, ``exec_strategy`` and
    ``trainer_id`` are parity arguments that change nothing; a non-empty
    ``build_strategy.sharding_rules`` or ``num_trainers > 1`` raises
    ``NotImplementedError``."""

    def __init__(
        self,
        use_cuda: bool = True,            # parity arg; places name devices
        loss_name: Optional[str] = None,
        main_program: Optional[Program] = None,
        share_vars_from: Optional["ParallelExecutor"] = None,
        exec_strategy: Optional[ExecutionStrategy] = None,
        build_strategy: Optional[BuildStrategy] = None,
        num_trainers: int = 1,
        trainer_id: int = 0,
        scope: Optional[Scope] = None,
        places: Optional[Sequence] = None,
    ):
        if num_trainers != 1:
            raise NotImplementedError(
                "ParallelExecutor: multi-process training (num_trainers > "
                "1, parallel/multihost.py) is not ported yet")
        self._build_strategy = build_strategy or BuildStrategy()
        if self._build_strategy.sharding_rules:
            raise NotImplementedError(
                "ParallelExecutor: BuildStrategy.sharding_rules (model "
                "parallelism over an mp axis) is not ported yet")
        self.mesh = make_mesh(self._build_strategy.mesh_shape, places)
        for axis in self.mesh.axis_names:
            if axis != SP_AXIS and self.mesh.spans_distinct(axis):
                raise NotImplementedError(
                    f"ParallelExecutor: mesh axis {axis!r} spans distinct "
                    f"devices ({self.mesh}); only the {SP_AXIS!r} axis "
                    f"(ring attention) may, until data parallelism over "
                    f"distinct devices is ported (ROADMAP, backlog "
                    f"'Multiple devices')")
        super().__init__(self.mesh.devices.flat[0])
        self._program = main_program or default_main_program()
        self._loss_name = loss_name
        self._scope = scope or global_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        self._dp_axis = ("dp" if "dp" in self.mesh.axis_names
                         else self.mesh.axis_names[0])
        self._scaled_programs: Dict[tuple, Program] = {}
        self._padded_batch: Optional[int] = None
        self._trains_cache: Optional[bool] = None

    # -- public API (reference parallel_executor.py:169 signature) ---------
    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy: bool = True, program=None, scope=None, **kwargs):
        feed = feed if feed is not None else (feed_dict or {})
        if program is None:
            # the padding policy belongs to the configured program
            feed, true_batch = self._maybe_pad_partial_batch(feed)
        else:
            true_batch = None
        outs = super().run(
            program=program if program is not None else self._program,
            feed=feed, fetch_list=fetch_list,
            scope=scope if scope is not None else self._scope,
            return_numpy=return_numpy)
        if true_batch is not None:
            # cut padding rows only from batch-aligned fetches: a var whose
            # declared leading dim is the batch (-1); a weight that happens
            # to be [pad_to, ...] keeps its rows
            names = [v.name if hasattr(v, "name") else str(v)
                     for v in (fetch_list or [])]
            blk = self._program.global_block

            def _batch_aligned(name):
                var = blk.var_or_none(name)
                return var is not None and len(var.shape) >= 1 \
                    and var.shape[0] == -1
            outs = [o[:true_batch]
                    if getattr(o, "ndim", 0) >= 1
                    and o.shape[0] == self._padded_batch
                    and (i >= len(names) or _batch_aligned(names[i]))
                    else o
                    for i, o in enumerate(outs)]
        return outs

    def _maybe_pad_partial_batch(self, feed):
        """Pad a last partial batch up to the dp multiple (repeating the
        last row; the reference rebalanced uneven batches,
        ``details/data_balance_op_handle.cc``).  Only for fetch-only
        programs: padding rows through a training step would bias the
        gradients, so those run the batch as it is.  ``run`` cuts the
        padded rows from the fetches."""
        dp = self.mesh.shape[self._dp_axis]
        batch_feeds = {k: v for k, v in feed.items()
                       if getattr(np.asarray(v), "ndim", 0) >= 1}
        sizes = {np.asarray(v).shape[0] for v in batch_feeds.values()}
        if len(sizes) != 1:
            return feed, None
        (b,) = sizes
        if b % dp == 0 or b == 0:
            return feed, None
        if self._program_trains():
            return feed, None
        pad_to = ((b + dp - 1) // dp) * dp
        padded = dict(feed)
        for k, v in batch_feeds.items():
            arr = np.asarray(v)
            padded[k] = np.concatenate(
                [arr, np.repeat(arr[-1:], pad_to - b, axis=0)], axis=0)
        self._padded_batch = pad_to
        return padded, b

    def _program_trains(self) -> bool:
        if self._trains_cache is None:
            self._trains_cache = any(
                op.attr(OP_ROLE_ATTR, 0) & (OpRole.Optimize | OpRole.Backward)
                for op in self._program.global_block.ops)
        return self._trains_cache

    # -- hooks (core/executor.py) -------------------------------------------
    def _mesh(self):
        return self.mesh

    def _prepare_program(self, program: Program, feed: Dict) -> Program:
        gs = self._build_strategy.gradient_scale_strategy
        if gs == GradientScaleStrategy.kCoeffNumDevice or \
                self._loss_name is None:
            return program
        # _uid, not id(): a collected program's reused address must never
        # hit another program's cached rewrite
        key = (program._uid, program._version)
        cached = self._scaled_programs.get(key)
        if cached is not None:
            return cached
        p = program.clone()
        blk = p.global_block
        loss_grad = grad_var_name(self._loss_name)
        for i, op in enumerate(blk.ops):
            if op.type == "fill_constant" and \
                    loss_grad in op.output_arg_names() and \
                    (op.attr(OP_ROLE_ATTR, 0) & OpRole.Loss):
                if op.attr("@loss_seed_scaled@", False):
                    # already rewritten (a clone of a prepared program):
                    # without this guard kOne would scale by dp^2
                    break
                if gs == GradientScaleStrategy.kOne:
                    # reference kOne: per-device seeds of 1 summed over the
                    # world -> the seed scaled by the dp degree
                    op.set_attr("value", float(op.attr("value", 1.0))
                                * self.mesh.shape[self._dp_axis])
                    op.set_attr("@loss_seed_scaled@", True)
                elif gs == GradientScaleStrategy.kCustomized:
                    if loss_grad not in feed:
                        raise RuntimeError(
                            f"GradientScaleStrategy.kCustomized requires "
                            f"feeding {loss_grad!r}")
                    blk.remove_op(i)
                break
        self._scaled_programs[key] = p
        return p

    @property
    def device_count(self) -> int:
        return self.mesh.size


__all__ = ["Mesh", "ParallelExecutor", "SP_AXIS", "make_mesh"]
