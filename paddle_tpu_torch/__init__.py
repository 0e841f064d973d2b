"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

It grows beside the JAX package, slice by slice, and imports nothing of
it.  Every TPU kernel on a ported path becomes a hand-written CUDA
kernel for Hopper (``kernels/csrc``), held against its plain PyTorch
version.  Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"`` (or ``CPUPlace()``).

Three paths are ported: the decode serving plane (``decode``);
training a Program — built with ``layers``, differentiated by
``append_backward``/``optimizer.minimize`` and run by
``Executor.run`` — as far as the Transformer (``models.transformer``)
on its ``fused_attention`` op::

    import paddle_tpu_torch as fluid
    exe = fluid.Executor()              # cuda:0
    exe.run(startup)
    loss, = exe.run(main, feed=..., fetch_list=[avg_cost])

(``Executor.run_steps`` runs K such steps over stacked feeds in one
call, and ``run`` defers its fetches, ``LazyFetch``, unless
``sync=True``); and serving a saved model, float32 or int8: ``io.save_inference_model``,
``inference.create_predictor`` (with ``AnalysisConfig.enable_int8()``)
and ``serving.ModelManager``'s dynamic batching.  Beam-search decoding
runs in both planes: a ``While`` program of ``beam_search`` steps
(machine translation's ``mode="infer"``, ``contrib.decoder``) and
``decode.PagedBeamDecoder`` over the paged KV cache.
``ParallelExecutor`` runs a program over a device mesh
(``parallel``), whose ``sp`` axis ``fused_attention impl="ring"``
consumes: sequence-parallel ring attention over the flash kernels.
"""
from __future__ import annotations

from . import platform  # noqa: F401
from . import ops  # noqa: F401  (registers the op rules)
from . import clip, initializer, regularizer  # noqa: F401
from . import layers, optimizer  # noqa: F401
from . import executor, framework  # noqa: F401
from .core import unique_name  # noqa: F401
from .core.backward import append_backward  # noqa: F401
from .core.executor import (  # noqa: F401
    Executor,
    LazyFetch,
    Scope,
    global_scope,
    scope_guard,
)
from .data_feeder import DataFeeder  # noqa: F401
from .lod_tensor import (  # noqa: F401
    LoDTensor, create_lod_tensor, create_random_int_lodtensor)
Tensor = LoDTensor  # reference __init__.py:51 alias
LoDTensorArray = list  # reference core type: a list of LoDTensors
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.program import (  # noqa: F401
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .param_attr import ParamAttr  # noqa: F401
from .platform import CPUPlace, CUDAPlace  # noqa: F401
from . import contrib, decode  # noqa: F401
from . import inference, io, serving  # noqa: F401
from .parallel import (  # noqa: F401
    BuildStrategy,
    ExecutionStrategy,
    ParallelExecutor,
)

__all__ = ["BuildStrategy", "CPUPlace", "CUDAPlace", "DataFeeder",
           "ExecutionStrategy", "Executor", "LazyFetch", "LoDTensor",
           "LoDTensorArray", "ParallelExecutor", "Tensor", "ParamAttr", "Program",
           "Scope", "append_backward", "contrib", "create_lod_tensor",
           "create_random_int_lodtensor", "decode",
           "default_main_program", "default_startup_program", "get_flags",
           "global_scope", "inference", "initializer", "io", "layers",
           "optimizer", "parallel", "platform", "serving",
           "program_guard", "scope_guard", "set_flags", "unique_name"]
