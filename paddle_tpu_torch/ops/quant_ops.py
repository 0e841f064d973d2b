"""Fake-quantization ops for quantization-aware training.

The port of ``paddle_tpu/ops/quant_ops.py`` (``fake_quantize_op.cc``:
abs_max, moving_average_abs_max and channel-wise; and
``fake_dequantize_op.cc``).  Quantize-dequantize in the forward, the
straight-through estimator in the backward (the gradient passes
unchanged), registered as explicit grad rules since round() has zero
derivative.  A QAT model the reference saved loads and runs on the port
in float32 with these ops in its graph; the ``quantize_int8`` pass folds
them out for int8 serving (``inference/passes.py``).
"""
from __future__ import annotations

import torch

from ..core.registry import register, register_grad


def _qdq(x, scale, bits):
    r = float((1 << (bits - 1)) - 1)
    scale = torch.clamp_min(scale.float(), 1e-8)
    q = torch.clamp(torch.round(x.float() / scale * r), -r, r)
    return (q * scale / r).to(x.dtype)


@register("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale = x.float().abs().amax()
    return {"Out": [_qdq(x, scale, bits)], "OutScale": [scale]}


@register_grad("fake_quantize_abs_max")
def _fake_quantize_abs_max_grad(ctx, ins, attrs):
    return {"X@GRAD": [ins["Out@GRAD"][0]]}  # straight-through


@register("fake_channel_wise_quantize_abs_max")
def _fake_cw_quantize(ctx, ins, attrs):
    """Per-output-channel (dim 0) scales: conv filter quantization."""
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale = x.float().abs().reshape(x.shape[0], -1).amax(dim=1)
    shaped = scale.reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": [_qdq(x, shaped, bits)], "OutScale": [scale]}


@register_grad("fake_channel_wise_quantize_abs_max")
def _fake_cw_quantize_grad(ctx, ins, attrs):
    return {"X@GRAD": [ins["Out@GRAD"][0]]}


@register("fake_quantize_moving_average_abs_max",
          no_grad_slots=("InScale", "InAccum", "InState"))
def _fake_quantize_mavg(ctx, ins, attrs):
    """Running abs-max scale (fake_quantize_op.cc moving_average path):
    state = rate·state + 1; accum = rate·accum + max|x|; scale =
    accum/state while training; the stored InScale in test mode.  The
    state vars are persistable ins/outs."""
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    rate = float(attrs.get("moving_rate", 0.9))
    cur = x.float().abs().amax()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    accum = (ins["InAccum"][0].reshape(()) if ins.get("InAccum") else zero)
    state = (ins["InState"][0].reshape(()) if ins.get("InState") else zero)
    if ctx.training and not attrs.get("is_test", False):
        state = rate * state + 1.0
        accum = rate * accum + cur
        scale = accum / torch.clamp_min(state, 1e-8)
    else:
        scale = (ins["InScale"][0].reshape(()) if ins.get("InScale")
                 else cur)
    return {"Out": [_qdq(x, scale, bits)],
            "OutScale": [scale.reshape(1)],
            "OutAccum": [accum.reshape(1)],
            "OutState": [state.reshape(1)]}


@register_grad("fake_quantize_moving_average_abs_max")
def _fake_quantize_mavg_grad(ctx, ins, attrs):
    return {"X@GRAD": [ins["Out@GRAD"][0]]}


@register("fake_dequantize_max_abs", no_grad_slots=("Scale",))
def _fake_dequantize(ctx, ins, attrs):
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(()).float()
    r = float(attrs.get("max_range", 127))
    return {"Out": [(x.float() * scale / r).to(x.dtype)]}
