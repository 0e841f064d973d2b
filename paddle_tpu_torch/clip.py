"""Gradient clipping (reference: python/paddle/fluid/clip.py —
GradientClipByValue/ByNorm/ByGlobalNorm + op-injection pass)."""
from __future__ import annotations

from typing import List, Optional

from .core.program import OP_ROLE_ATTR, OpRole


class BaseGradientClipAttr:
    def _create_operators(self, param, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=grad.shape,
                               dtype=grad.dtype, type=grad.type)
        block.append_op("clip", {"X": [grad.name]}, {"Out": [out.name]},
                        {"min": self.min, "max": self.max,
                         OP_ROLE_ATTR: OpRole.Backward})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=grad.shape,
                               dtype=grad.dtype, type=grad.type)
        block.append_op("clip_by_norm", {"X": [grad.name]}, {"Out": [out.name]},
                        {"max_norm": self.clip_norm,
                         OP_ROLE_ATTR: OpRole.Backward})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Global-norm clipping: grad_i *= clip_norm / max(global_norm, clip_norm).

    Emitted as graph ops over all grads at once (reference clip.py:228);
    under data-parallel lowering the global norm is computed after the grad
    psum, matching the reference's post-allreduce clip placement.
    """

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process(self, params_grads):
        if not params_grads:
            return params_grads
        block = params_grads[0][1].block
        sq_names: List[str] = []
        for p, g in params_grads:
            sq = block.create_var(name=g.name + "@SQSUM", shape=(), dtype="float32")
            block.append_op("__global_norm_sq__", {"X": [g.name]},
                            {"Out": [sq.name]}, {OP_ROLE_ATTR: OpRole.Backward})
            sq_names.append(sq.name)
        total = block.create_var(name="@GLOBAL_NORM_SQ@" + params_grads[0][1].name,
                                 shape=(), dtype="float32")
        block.append_op("sum", {"X": sq_names}, {"Out": [total.name]},
                        {OP_ROLE_ATTR: OpRole.Backward})
        factor = block.create_var(name=total.name + "@FACTOR", shape=(),
                                  dtype="float32")
        block.append_op("__global_norm_factor__", {"X": [total.name]},
                        {"Out": [factor.name]},
                        {"clip_norm": self.clip_norm, OP_ROLE_ATTR: OpRole.Backward})
        out = []
        for p, g in params_grads:
            ng = block.create_var(name=g.name + "@CLIP", shape=g.shape,
                                  dtype=g.dtype, type=g.type)
            block.append_op("elementwise_mul", {"X": [g.name], "Y": [factor.name]},
                            {"Out": [ng.name]}, {OP_ROLE_ATTR: OpRole.Backward})
            out.append((p, ng))
        return out


_global_clip: Optional[BaseGradientClipAttr] = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    clips = [(p, g, getattr(p, "gradient_clip_attr", None) or _global_clip)
             for p, g in params_grads]
    if any(isinstance(c, GradientClipByGlobalNorm) for _, _, c in clips):
        gclip = next(c for _, _, c in clips if isinstance(c, GradientClipByGlobalNorm))
        return gclip.process(params_grads)
    out = []
    for p, g, c in clips:
        if c is None or g is None:
            out.append((p, g))
        else:
            out.append(c._create_operators(p, g))
    return out


def error_clip_callback(block, context):  # parity stub
    pass


ErrorClipByValue = GradientClipByValue  # simplified parity alias
