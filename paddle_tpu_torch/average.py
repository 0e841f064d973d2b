"""fluid.average — pure-Python weighted averaging
(reference python/paddle/fluid/average.py:28; deprecated there in favor
of fluid.metrics, kept for API parity): ``paddle_tpu/average.py``,
copied unchanged."""
from __future__ import annotations

import warnings

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(v):
    return isinstance(v, (int, float)) or (
        isinstance(v, np.ndarray) and v.ndim == 0)


def _is_number_or_matrix(v):
    return _is_number(v) or isinstance(v, np.ndarray)


class WeightedAverage:
    """sum(value * weight) / sum(weight), accumulated host-side."""

    def __init__(self):
        warnings.warn(
            f"The {self.__class__.__name__} is deprecated, please use "
            "fluid.metrics.Accuracy instead.", Warning)
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            # Accept anything exposing __array__ — notably the LazyFetch
            # objects Executor.run returns by default (reading one here
            # flushes the pending batch, same as any other consumption).
            value = np.asarray(value)
            if value.dtype.kind not in "biufc":
                raise ValueError(
                    "The 'value' must be a number(int, float), a numpy "
                    "ndarray, or expose __array__.")
        if not _is_number(weight):
            raise ValueError("The 'weight' must be a number(int, float).")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
