"""Weight-decay regularizers appended as grad-rewrite ops.

Reference: ``python/paddle/fluid/regularizer.py`` — L1/L2 decay ops inserted
between backward and the optimizer pass.
"""
from __future__ import annotations

from .core.program import OP_ROLE_ATTR, OpRole
from .core.types import VarType


def _sparse_decay_var(param, grad, block, coeff, mode):
    """SelectedRows grad: decay only the touched rows (reference
    regularizer.py SelectedRows branch)."""
    decay = block.create_var(
        name=grad.name + "@" + mode.upper() + "DECAY", shape=param.shape,
        dtype=param.dtype, type=VarType.SELECTED_ROWS)
    block.append_op(
        "sparse_decay", {"Param": [param.name], "Grad": [grad.name]},
        {"Out": [decay.name]},
        {"coeff": coeff, "mode": mode, OP_ROLE_ATTR: OpRole.Backward})
    return decay


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        if grad.type == VarType.SELECTED_ROWS:
            return _sparse_decay_var(param, grad, block, self._coeff, "l2")
        decay = block.create_var(
            name=grad.name + "@L2DECAY", shape=param.shape, dtype=param.dtype)
        block.append_op(
            "scale", {"X": [param.name]}, {"Out": [decay.name]},
            {"scale": self._coeff, OP_ROLE_ATTR: OpRole.Backward})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        if grad.type == VarType.SELECTED_ROWS:
            return _sparse_decay_var(param, grad, block, self._coeff, "l1")
        sign = block.create_var(
            name=grad.name + "@L1SIGN", shape=param.shape, dtype=param.dtype)
        block.append_op(
            "sign", {"X": [param.name]}, {"Out": [sign.name]},
            {OP_ROLE_ATTR: OpRole.Backward})
        decay = block.create_var(
            name=grad.name + "@L1DECAY", shape=param.shape, dtype=param.dtype)
        block.append_op(
            "scale", {"X": [sign.name]}, {"Out": [decay.name]},
            {"scale": self._coeff, OP_ROLE_ATTR: OpRole.Backward})
        return decay


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if regularizer is None or grad is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = regularizer(param, grad, block)
        new_grad = block.create_var(
            name=grad.name + "@REG", shape=param.shape, dtype=param.dtype,
            type=grad.type)
        block.append_op(
            "sum", {"X": [grad.name, decay.name]}, {"Out": [new_grad.name]},
            {OP_ROLE_ATTR: OpRole.Backward})
        out.append((param, new_grad))
    return out


# reference aliases
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
