"""Build/execution strategies for parallel execution.

A copy of ``paddle_tpu/parallel/strategy.py`` (reference:
``paddle/fluid/framework/details/build_strategy.h:55`` for
ReduceStrategy and GradientScaleStrategy, ``execution_strategy.h:21``).
The JAX package reads them as sharding policies for its one jitted
program.  The port's ``ParallelExecutor`` reads ``mesh_shape`` and
``gradient_scale_strategy``, and refuses a non-empty ``sharding_rules``
(model parallelism is not ported).  The other fields are kept for
parity only and nothing in the port reads them: ``reduce_strategy`` and
``debug_graphviz_path``, and all of ``ExecutionStrategy``.  On a mesh
over one device the reduce strategy only places data, which changes no
result:

- ``kAllReduce``: parameters and optimizer state replicated over the
  data axis;
- ``kReduce``: optimizer state sharded over the data axis (ZeRO style).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class ReduceStrategy:
    kAllReduce = 0
    kReduce = 1


class GradientScaleStrategy:
    kCoeffNumDevice = 0
    kOne = 1
    kCustomized = 2


@dataclass
class BuildStrategy:
    reduce_strategy: int = ReduceStrategy.kAllReduce
    gradient_scale_strategy: int = GradientScaleStrategy.kCoeffNumDevice
    debug_graphviz_path: str = ""
    # extensions beyond the 2018 reference: named mesh axes and parameter
    # sharding rules (regex -> per-dim axis names) for tensor/model
    # parallelism on the same program
    mesh_shape: Optional[Dict[str, int]] = None          # e.g. {"dp": 8, "mp": 1}
    sharding_rules: List[Tuple[str, tuple]] = field(default_factory=list)
    # e.g. [(r".*ffn1\.w.*", (None, "mp")), (r".*embed.*", ("mp", None))]


@dataclass
class ExecutionStrategy:
    num_threads: int = 0
    use_cuda: bool = True  # parity field; the places name the devices
    allow_op_delay: bool = False
    num_iteration_per_drop_scope: int = 1
