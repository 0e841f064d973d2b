"""uint32 counter hashes in int64 torch arithmetic.

The JAX package mixes its counter-based random bits in uint32, which
wraps.  PyTorch has no wrapping uint32 arithmetic, so these helpers
hold each value in an int64 tensor in [0, 2**32) and mask after every
step; :func:`mul32` splits a product into 16-bit halves so no int64
product overflows.  Used by the decode sampler's uniforms
(``decode/model.py``) and by the plain versions of the attention
dropout bits (``kernels/attention.py``), which the CUDA kernels
reproduce in native uint32.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

# odd multipliers of the attention dropout hashes (the JAX package's
# _tile_dropout / _hash_dropout)
ROW_MUL = 0x9E3779B1
COL_MUL = 0x85EBCA77
C3 = 0xC2B2AE3D
C4 = 0x27D4EB2F
C5 = 0x165667B1


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): split in 16-bit
    halves so no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def u32(x) -> torch.Tensor:
    """An int tensor's two's-complement bits as int64 in [0, 2**32)."""
    return x.long() & M32


def finalize(x: torch.Tensor) -> torch.Tensor:
    """The murmur3-style finalizer both dropout hashes end with."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_multiplier(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Finalize ``x``, take its top 24 bits as a uniform in [0, 1), keep
    where it is >= rate: float32 multiplier 1/(1-rate) or 0 (the JAX
    package's ``_finalize_dropout``)."""
    u = (finalize(x) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    # python scalars meet float32 tensors as float32 values
    return torch.where(u >= rate, 1.0 / (1.0 - rate), 0.0).to(torch.float32)


__all__ = ["C3", "C4", "C5", "COL_MUL", "M32", "ROW_MUL",
           "dropout_multiplier", "finalize", "mul32", "u32"]
