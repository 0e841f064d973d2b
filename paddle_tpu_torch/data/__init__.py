"""Data-path pieces of the PyTorch port.

So far only :mod:`native`, the ctypes loader of the native runtime
library whose framed-TCP half carries the transport's ``native``
backend.
"""
from . import native  # noqa: F401

__all__ = ["native"]
