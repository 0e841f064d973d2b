"""Serving plane of the PyTorch port: the typed rejections and the
bucket ladder (shared with the decode plane), the continuous dynamic
batcher, the versioned model manager with hot swap, and the wire:
:class:`ModelServer` (``INFER`` msg 21, ``SERVING_ADMIN`` msg 22,
registry leases, drain) and :class:`ServingClient` (static endpoints or
registry discovery, health-gated failover).
"""
from .batcher import (BucketLadder, Draining, DynamicBatcher,  # noqa: F401
                      Overloaded, RequestTooLong)
from .model_registry import ModelManager, ServedModel  # noqa: F401
from .server import ModelServer, ServingService  # noqa: F401
from .client import ServingClient  # noqa: F401

__all__ = ["BucketLadder", "Draining", "DynamicBatcher", "Overloaded",
           "RequestTooLong", "ModelManager", "ServedModel",
           "ModelServer", "ServingService", "ServingClient"]
