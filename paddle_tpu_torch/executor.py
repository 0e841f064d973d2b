"""fluid.executor compatibility module (reference
python/paddle/fluid/executor.py:23 __all__): ``fluid.executor.Executor``
and ``fluid.executor.global_scope`` are common reference idioms."""
from .core.executor import (  # noqa: F401
    Executor,
    Scope,
    global_scope,
    scope_guard,
)

__all__ = ["Executor", "global_scope", "scope_guard"]
