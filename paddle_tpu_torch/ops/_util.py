"""Dtype names of the program IR as torch dtypes."""
from __future__ import annotations

import torch

from ..core.types import normalize_dtype

_TORCH = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of an IR dtype name (any spelling)."""
    return _TORCH[normalize_dtype(name)]


__all__ = ["torch_dtype"]
