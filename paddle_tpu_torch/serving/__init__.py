"""Serving plane of the PyTorch port: the typed rejections and the
bucket ladder (shared with the decode plane), the continuous dynamic
batcher and the versioned model manager with hot swap.

The wire server and client of the reference (``serving/server.py``,
``client.py``) wait for the port's distributed transport.
"""
from .batcher import (BucketLadder, Draining, DynamicBatcher,  # noqa: F401
                      Overloaded, RequestTooLong)
from .model_registry import ModelManager, ServedModel  # noqa: F401

__all__ = ["BucketLadder", "Draining", "DynamicBatcher", "ModelManager",
           "Overloaded", "RequestTooLong", "ServedModel"]
