"""Type system for the program IR.

TPU-native re-design of the reference's variable/type model
(``paddle/fluid/framework/framework.proto:104-181`` — VarType with
LOD_TENSOR / SELECTED_ROWS / LOD_TENSOR_ARRAY / READER / STEP_SCOPES, and
typed attributes on OpDesc).  Dtypes map onto numpy dtypes for the
host side.  ``bfloat16`` is an IR dtype of its own whether or not numpy
can hold it: its numpy dtype is ``ml_dtypes.bfloat16`` where that
package can be imported (it is the reference's fetch type), and there
is none otherwise (:data:`BFLOAT16_NP` is None, :func:`np_dtype`
raises).  It is never folded into float32; the executor moves bfloat16
values between host and device by their bits
(``core/executor.py: tensor_from_numpy``).
"""
from __future__ import annotations

import enum

import numpy as np

try:  # optional: numpy's bfloat16, where it is installed
    import ml_dtypes

    BFLOAT16_NP = np.dtype(ml_dtypes.bfloat16)
except ImportError:
    BFLOAT16_NP = None


class VarType(enum.IntEnum):
    """Variable container kinds (framework.proto:104 equivalents)."""

    DENSE_TENSOR = 0       # reference LOD_TENSOR; here: dense array (+ optional lengths)
    SELECTED_ROWS = 1      # sparse {rows, values} gradient for embeddings
    TENSOR_ARRAY = 2       # reference LOD_TENSOR_ARRAY: stacked per-step tensors
    STEP_SCOPES = 3        # control-flow carry bookkeeping
    READER = 4             # data pipeline endpoint
    RAW = 5                # opaque host object
    FEED_MINIBATCH = 6
    FETCH_LIST = 7


# Canonical dtype names (attribute values store these strings).
_DTYPES = {
    "bool": np.dtype("bool"),
    "int8": np.dtype("int8"),
    "uint8": np.dtype("uint8"),
    "int16": np.dtype("int16"),
    "int32": np.dtype("int32"),
    "int64": np.dtype("int64"),
    "float16": np.dtype("float16"),
    "bfloat16": BFLOAT16_NP,
    "float32": np.dtype("float32"),
    "float64": np.dtype("float64"),
}

_CANON = {v: k for k, v in _DTYPES.items() if v is not None}


def normalize_dtype(dtype) -> str:
    """Return the canonical string name for any dtype spelling."""
    if isinstance(dtype, str):
        if dtype in _DTYPES:
            return dtype
        return _CANON[np.dtype(dtype)]
    d = np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
    if d in _CANON:
        return _CANON[d]
    raise ValueError(f"unsupported dtype: {dtype!r}")


def np_dtype(name) -> np.dtype:
    """The numpy dtype of an IR dtype; ``bfloat16`` without
    ``ml_dtypes`` has none and raises."""
    d = _DTYPES[normalize_dtype(name)]
    if d is None:
        raise TypeError("numpy has no bfloat16 dtype here (ml_dtypes is "
                        "not installed): move bfloat16 values by their "
                        "bits (core/executor.py: tensor_from_numpy)")
    return d


def is_float(name) -> bool:
    return normalize_dtype(name) in ("float16", "bfloat16", "float32", "float64")


def is_int(name) -> bool:
    return normalize_dtype(name) in ("int8", "uint8", "int16", "int32", "int64")
