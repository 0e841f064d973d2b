"""Initializers — emitted as ops into the startup program.

Reference: ``python/paddle/fluid/initializer.py`` (Constant/Uniform/Normal/
TruncatedNormal/Xavier/MSRA/NumpyArray, each appending a startup-program op).
The startup program is itself lowered and jitted; random initializer ops
draw from the threaded PRNG state, so initialization is reproducible from
``program.random_seed``.
"""
from __future__ import annotations

import math

import contextlib
import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def _fan_in_out(self, var):
        shape = var.shape
        if len(shape) < 2:
            return int(shape[0]) if shape else 1, int(shape[0]) if shape else 1
        receptive = 1
        for s in shape[2:]:
            receptive *= int(s)
        fan_in = int(shape[0]) * receptive if len(shape) > 2 else int(shape[0])
        fan_out = int(shape[1]) * receptive if len(shape) > 2 else int(shape[1])
        # conv filters are OIHW: O=out, I=in
        if len(shape) > 2:
            fan_in = int(shape[1]) * receptive
            fan_out = int(shape[0]) * receptive
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype, "value": self.value},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "min": self.low, "max": self.high, "seed": self.seed,
             "seed_name": var.name},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "mean": self.loc, "std": self.scale, "seed": self.seed,
             "seed_name": var.name},
        )


class TruncatedNormalInitializer(NormalInitializer):
    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "mean": self.loc, "std": self.scale, "seed": self.seed,
             "seed_name": var.name},
        )


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            "assign_value", {}, {"Out": [var.name]},
            {"shape": list(self.value.shape), "dtype": var.dtype,
             "values": self.value.reshape(-1).tolist()},
        )


class BilinearInitializer(Initializer):
    """Bilinear-upsampling kernel init for conv2d_transpose weights
    (reference initializer.py BilinearInitializer): with a [C_out, C_in,
    H, W] weight, every spatial slice becomes the standard bilinear
    interpolation kernel w[i, j] = (1 - |i/f - c|) * (1 - |j/f - c|),
    f = ceil(W/2), c = (2f - 1 - f%2) / (2f) — so a stride-f transposed
    conv initialized this way performs bilinear upsampling."""

    def __call__(self, var, block):
        shape = [int(d) for d in var.shape]
        if len(shape) != 4:
            raise ValueError("BilinearInitializer needs a 4-D weight")
        H, W = shape[2], shape[3]
        if H != W:
            raise ValueError(
                f"BilinearInitializer needs a square kernel, got "
                f"{H}x{W} (a rectangular bilinear kernel is not "
                "well-defined)")
        f = int(np.ceil(W / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        j = np.arange(W)
        i = np.arange(H)[:, None]
        kern = ((1 - np.abs(i / f - c))
                * (1 - np.abs(j / f - c))).astype("float32")
        # keep the startup program small: store the [H, W] kernel ONCE
        # and expand across [C_out, C_in] at lowering (an FCN-style
        # [21, 21, 64, 64] head would otherwise bake 1.8M duplicated
        # floats into the op attrs)
        block.append_op(
            "assign_value", {}, {"Out": [var.name + "@BILINEAR_KERN"]},
            {"shape": [1, 1, H, W], "dtype": var.dtype,
             "values": kern.reshape(-1).tolist()})
        block.create_var(name=var.name + "@BILINEAR_KERN",
                         dtype=var.dtype, shape=(1, 1, H, W))
        block.append_op(
            "expand", {"X": [var.name + "@BILINEAR_KERN"]},
            {"Out": [var.name]},
            {"expand_times": [shape[0], shape[1], 1, 1]})


def force_init_on_cpu():
    """Reference framework hint: whether initializers must run on CPU.
    The TPU executor stages all initialization through host arrays
    already, so this is always False (compat shim)."""
    return False


@contextlib.contextmanager
def init_on_cpu():
    """Reference context manager forcing CPU-side init — a no-op here
    (see force_init_on_cpu)."""
    yield


# reference-compatible aliases (initializer.py tail)
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
