"""High-level API (reference python/paddle/fluid/contrib/): the port of
``paddle_tpu/contrib``, in part.  Only ``decoder`` is ported; the
trainer, inferencer, mixed-precision, quantize and introspection
modules are not yet."""
from . import decoder  # noqa: F401  (InitState/StateCell/*BeamDecoder)

__all__ = ["decoder"]
