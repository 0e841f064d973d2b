"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""
from __future__ import annotations

import collections
import contextlib

_counters: dict = collections.defaultdict(int)


def generate(key: str) -> str:
    _counters[key] += 1
    return f"{key}_{_counters[key] - 1}"


def reset() -> None:
    _counters.clear()


@contextlib.contextmanager
def guard(prefix: str = ""):
    """Isolate the counter namespace (used by Program.clone and tests)."""
    global _counters
    saved = _counters
    _counters = collections.defaultdict(int)
    try:
        yield
    finally:
        _counters = saved
