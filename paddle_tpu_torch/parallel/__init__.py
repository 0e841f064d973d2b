from .parallel_executor import Mesh, ParallelExecutor, make_mesh  # noqa: F401
from .strategy import (  # noqa: F401
    BuildStrategy,
    ExecutionStrategy,
    GradientScaleStrategy,
    ReduceStrategy,
)
