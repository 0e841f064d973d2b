"""The split-TF32 products of the redesigned kernels (K1-K3, K6, K7, K8b) in
plain PyTorch: the same arithmetic as ``csrc/tf32x3.cuh``, for the CPU
tests.

A float32 x is split into hi = tf32(x), rounded to nearest (ties away
from zero) at 10 explicit mantissa bits as ``cvt.rna.tf32.f32`` does,
and lo = x - hi truncated to TF32.  A product is lo_a * hi_b + hi_a * lo_b + hi_a *
hi_b, each term exact in float32 (11-bit significands), summed in
float32.  The card sums inside the tensor cores in its own order; that
is within the float32 rounding this model already carries.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (round to nearest, ties away from zero),
    still stored as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo): x = hi + lo + (what TF32 cannot hold of x - hi)."""
    hi = round_tf32(x)
    return hi, _truncate_tf32(x.float() - hi)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand split and three products summed (small
    terms first), as the kernels' ``mma3``."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 product (operands rounded to TF32): what the
    kernels must not do, the tests' control for their bounds."""
    return torch.matmul(round_tf32(a), round_tf32(b))


__all__ = ["matmul_tf32", "matmul_tf32x3", "round_tf32", "split_tf32"]
