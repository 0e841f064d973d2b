"""Parameter attributes (reference: python/paddle/fluid/param_attr.py)."""
from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(
        self,
        name: Optional[str] = None,
        initializer=None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        gradient_clip=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            a = ParamAttr()
            a.trainable = arg
            return a
        # an Initializer instance
        return ParamAttr(initializer=arg)


WeightNormParamAttr = ParamAttr  # placeholder parity alias
