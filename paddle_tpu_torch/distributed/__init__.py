"""Distributed planes of the PyTorch port.

So far only :mod:`faults`, the chaos suite's fault injection (a copy of
``paddle_tpu/distributed/faults.py``), whose hooks the decode engine and
the serving batcher call.  The parameter-server stack, the transport
and the supervisor are still to port.
"""
from . import faults  # noqa: F401

__all__ = ["faults"]
