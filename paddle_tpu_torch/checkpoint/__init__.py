"""The checkpoint plane of the PyTorch port, in part.

Only :mod:`elastic`'s :class:`ElasticController` is ported: the fleet
supervisor's resize decisions from the registry's live health gauges.
The reference's sharded checkpoints (``manifest``, ``store``,
``reshard``, ``snapshot``) and the scope save/restore built on them
are not, so no name of theirs is exported here.
"""
from . import elastic  # noqa: F401
from .elastic import ElasticController  # noqa: F401

__all__ = ["ElasticController"]
