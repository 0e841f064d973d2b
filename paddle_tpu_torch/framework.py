"""fluid.framework compatibility module (reference
python/paddle/fluid/framework.py:38 __all__): reference code addresses
Program/default_*_program/program_guard/name_scope through
``fluid.framework`` as often as through the top level — keep both
spellings working."""
from .core.program import (  # noqa: F401
    Block,
    Operator,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
    switch_main_program,
)

__all__ = [
    "Program",
    "default_startup_program",
    "default_main_program",
    "program_guard",
    "name_scope",
]
