"""Program-level inference passes: is_test stamping, fc+act fusion,
conv+bn folding, fc+RNN fusion, int8 calibration, add+act fusion.

The port of ``paddle_tpu/inference/passes.py`` (the reference's
``framework/ir/fc_fuse_pass.cc``, ``fc_lstm_fuse_pass.cc``,
``fc_gru_fuse_pass.cc``, ``fuse_elewise_add_act_pass.cc``,
``transpiler/inference_transpiler.py`` and the analysis predictor's
pass pipeline).  Each pass rewrites the Program the same way the
reference's does, op for op and attr for attr, so a program passed by
either package serializes to the same dict.  The passes that touch
weights (``fuse_conv_bn``, ``fuse_fc_lstm``/``fuse_fc_gru``'s summed
bias, ``quantize_int8``'s sidecars) work on host numpy copies of the
scope's tensors with the reference's numpy code and put the results back
as tensors on the device of the weight they came from.

``convert_to_nhwc`` rewrites conv/bn/pool chains channels-last with
boundary transposes, as the reference's layout pass.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import registry
from ..core.executor import _to_numpy, tensor_from_numpy
from ..core.program import Operator, Program
from ..kernels import quant as Q

__all__ = ["apply_is_test", "convert_to_nhwc", "fuse_conv_bn",
           "fuse_elewise_add_act", "fuse_fc_act", "fuse_fc_gru",
           "fuse_fc_lstm", "quantize_int8"]

# activations the fc fuser recognizes (fc_fuse_pass handles relu; any
# registered unary activation with a plain X -> Out contract)
_FUSABLE_ACTS = {"relu", "sigmoid", "tanh", "softmax", "gelu", "relu6",
                 "leaky_relu", "elu", "softplus", "swish"}


def _scope_array(scope, name):
    """A host numpy copy of the scope's value ``name``, or None."""
    v = scope.find_var(name) if scope is not None else None
    return None if v is None else np.asarray(_to_numpy(v))


def _scope_put(scope, name, arr, like=None) -> None:
    """Store host array ``arr`` under ``name`` as a tensor on the device
    of the scope value ``like`` (the CPU when there is none)."""
    ref = scope.find_var(like) if like is not None else None
    dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
    scope.set_var(name, tensor_from_numpy(np.array(arr, copy=True),
                                          device=dev))


def apply_is_test(program: Program) -> None:
    """Stamp is_test=True on every op that distinguishes train from test
    (the stateful ops, batch_norm, fused_attention, dropout): inference
    programs run in test mode (the NaiveExecutor contract)."""
    for block in program.blocks:
        for op in block.ops:
            base = op.type[:-5] if op.type.endswith("_grad") else op.type
            if registry.has(base) and registry.get(base).stateful:
                op.set_attr("is_test", True)
            if op.type in ("batch_norm", "fused_attention", "dropout"):
                op.set_attr("is_test", True)
    program._version += 1  # invalidate any cached plan


def _use_counts(program: Program, keep_vars=()) -> Dict[str, int]:
    """Input-use counts; ``keep_vars`` (fetch targets) count as external
    uses, so a fetched intermediate is never fused away."""
    uses: Dict[str, int] = {}
    for block in program.blocks:
        for op in block.ops:
            for n in op.input_arg_names():
                uses[n] = uses.get(n, 0) + 1
    for n in keep_vars:
        uses[n] = uses.get(n, 0) + 1
    return uses


def fuse_fc_act(program: Program, scope=None, keep_vars=()) -> int:
    """mul -> elementwise_add(bias) -> activation collapses into one
    ``fused_fc`` op (fc_fuse_pass.cc); the act-less mul+add pair too.
    Returns the number of fusions."""
    block = program.global_block
    uses = _use_counts(program, keep_vars)
    fused = 0
    i = 0
    while i < len(block.ops) - 1:
        op = block.ops[i]
        nxt = block.ops[i + 1]
        if (op.type == "mul" and nxt.type == "elementwise_add"
                and op.output("Out") == nxt.input("X")
                and uses.get(op.output("Out")[0], 0) == 1):
            act_op = block.ops[i + 2] if i + 2 < len(block.ops) else None
            has_act = (act_op is not None
                       and act_op.type in _FUSABLE_ACTS
                       and act_op.input("X") == nxt.output("Out")
                       and uses.get(nxt.output("Out")[0], 0) == 1)
            out = (act_op.output("Out") if has_act else nxt.output("Out"))
            attrs = {
                "x_num_col_dims": op.attr("x_num_col_dims", 1),
                "y_num_col_dims": op.attr("y_num_col_dims", 1),
                "axis": nxt.attr("axis", -1),
                "act": act_op.type if has_act else "",
                # activation attrs travel verbatim (leaky_relu alpha, ...)
                "act_attrs": dict(act_op.attrs) if has_act else {},
            }
            new = block.ops[i]
            new.type = "fused_fc"
            new.inputs = {"X": op.input("X"), "W": op.input("Y"),
                          "Bias": nxt.input("Y")}
            new.outputs = {"Out": out}
            new.attrs.update(attrs)
            del block.ops[i + 1:i + (3 if has_act else 2)]
            program._version += 1
            fused += 1
        i += 1
    return fused


def fuse_conv_bn(program: Program, scope, keep_vars=()) -> int:
    """conv2d -> batch_norm(is_test) folds the BN affine into the conv
    filter and a bias add (inference_transpiler.py _fuse_param):
    W' = W·γ/σ per out channel, b' = β − μ·γ/σ.  Writes the folded
    filter and bias into the scope; returns the number of folds.
    Shared (weight-tied) filters are skipped."""
    if scope is None:
        return 0
    block = program.global_block
    uses = _use_counts(program, keep_vars)
    folded = 0
    i = 0
    while i < len(block.ops) - 1:
        op = block.ops[i]
        nxt = block.ops[i + 1]
        if not (op.type == "conv2d" and nxt.type == "batch_norm"
                and nxt.input("X") == op.output("Output")
                and uses.get(op.output("Output")[0], 0) == 1):
            i += 1
            continue
        w_name = op.input("Filter")[0]
        if uses.get(w_name, 0) > 1:
            i += 1
            continue
        scale = _scope_array(scope, nxt.input("Scale")[0])
        bias = _scope_array(scope, nxt.input("Bias")[0])
        mean = _scope_array(scope, nxt.input("Mean")[0])
        var = _scope_array(scope, nxt.input("Variance")[0])
        eps = float(nxt.attr("epsilon", 1e-5))
        std = np.sqrt(var + eps)
        w = _scope_array(scope, w_name)
        _scope_put(scope, w_name, (w * (scale / std)[:, None, None, None]
                                   ).astype(w.dtype), like=w_name)
        # keyed by the BN's own scale var: unique even if filters repeat
        fold_bias_name = nxt.input("Scale")[0] + "@BN_FOLD_BIAS"
        fold_bias = (bias - mean * scale / std).astype(w.dtype)
        block.create_var(name=fold_bias_name, shape=fold_bias.shape,
                         dtype=str(w.dtype), persistable=True)
        _scope_put(scope, fold_bias_name, fold_bias, like=w_name)
        # the batch_norm op becomes the bias add (axis=1: per channel)
        nxt.type = "elementwise_add"
        nxt.inputs = {"X": op.output("Output"), "Y": [fold_bias_name]}
        nxt.outputs = {"Out": nxt.output("Y")}
        nxt.attrs = {"axis": 1}
        program._version += 1
        folded += 1
        i += 1
    return folded


# ---------------------------------------------------------------------------
# NHWC layout pass: NCHW conv/bn/pool chains become channels-last, with
# boundary transposes (opt-in: AnalysisConfig.add_pass("convert_to_nhwc"))
# ---------------------------------------------------------------------------

_LAYOUT_OPS = {"conv2d", "depthwise_conv2d", "pool2d", "batch_norm"}
# elementwise/activation ops that pass a layout through untouched when all
# their 4-D inputs share it (not prelu: its Alpha rides dim 1)
_LAYOUT_TRANSPARENT = {"relu", "relu6", "sigmoid", "tanh", "leaky_relu",
                       "elu", "swish", "gelu", "abs", "sqrt", "square",
                       "scale", "dropout", "elementwise_add",
                       "elementwise_sub", "elementwise_mul"}


def _nchw_shape(s):
    return (s[0], s[3], s[1], s[2])


def _nhwc_shape(s):
    return (s[0], s[2], s[3], s[1])


def _is_4d(var) -> bool:
    return var is not None and var.shape is not None and len(var.shape) == 4


def convert_to_nhwc(program: Program, scope=None, keep_vars=()) -> int:
    """Rewrite the layout-sensitive ops of the global block to
    ``data_layout="NHWC"`` (the reference's layout pass).  Filters stay
    OIHW, so the scope is untouched.  Walks the ops in order with the
    set of vars that hold NHWC values: an NCHW input of a layout op is
    transposed in (``<x>@NHWC``), a transparent op whose 4-D inputs are
    all NHWC passes the layout on (a per-channel 1-D bias add moves
    from axis 1 to axis 3), any other consumer of an NHWC var gets it
    transposed back (``<x>@NCHW``), and an NHWC ``keep_vars`` target is
    renamed ``<x>@NHWCVAL`` and transposed back into its own name.
    Returns the number of ops converted."""
    del scope
    block = program.global_block
    nhwc: set = set()
    new_ops = []
    converted = 0

    def transpose(src, axis, dst_name, dst_shape):
        dst = block.create_var(name=dst_name, dtype=block.var(src).dtype,
                               shape=dst_shape)
        new_ops.append(Operator(block, "transpose", {"X": [src]},
                                {"Out": [dst.name]}, {"axis": axis}))
        return dst.name

    def rename_in(op, old, new):
        op.inputs = {k: [new if n == old else n for n in v]
                     for k, v in op.inputs.items()}

    for op in block.ops:
        ins = op.input_arg_names()
        if (op.type in _LAYOUT_OPS
                and op.attr("data_layout", "NCHW") == "NCHW"):
            conv = "conv" in op.type
            xname = op.input("Input" if conv else "X")[0]
            xvar = block.var_or_none(xname)
            if not _is_4d(xvar):
                new_ops.append(op)
                continue
            if xname not in nhwc:
                t = transpose(xname, [0, 2, 3, 1], f"{xname}@NHWC",
                              _nhwc_shape(xvar.shape))
                rename_in(op, xname, t)
                nhwc.add(t)
            op.set_attr("data_layout", "NHWC")
            out = op.output("Output" if conv else (
                "Y" if op.type == "batch_norm" else "Out"))[0]
            ovar = block.var(out)
            ovar.shape = _nhwc_shape(ovar.shape)
            nhwc.add(out)
            converted += 1
            new_ops.append(op)
            continue
        if op.type in _LAYOUT_TRANSPARENT and ins and ins[0] in nhwc:
            ok = all(n in nhwc or not _is_4d(block.var_or_none(n))
                     for n in ins[1:])
            if (ok and op.type.startswith("elementwise")
                    and op.attr("axis", -1) == 1):
                yv = block.var_or_none(op.input("Y")[0])
                if yv is not None and yv.shape is not None \
                        and len(yv.shape) == 1:
                    op.set_attr("axis", 3)    # the channel bias rides last
                else:
                    ok = False
            if ok:
                for oname in op.output_arg_names():
                    ovar = block.var_or_none(oname)
                    if _is_4d(ovar):
                        ovar.shape = _nhwc_shape(ovar.shape)
                        nhwc.add(oname)
                new_ops.append(op)
                continue
        # an NCHW consumer of NHWC vars: transpose them back first
        for name in set(ins):
            if name in nhwc:
                back = transpose(name, [0, 3, 1, 2], f"{name}@NCHW",
                                 _nchw_shape(block.var(name).shape))
                rename_in(op, name, back)
        new_ops.append(op)

    for name in keep_vars:
        if name in nhwc:
            v = block.var(name)
            inner = block.create_var(name=f"{name}@NHWCVAL", dtype=v.dtype,
                                     shape=v.shape)
            for op in new_ops:
                op.outputs = {k: [inner.name if n == name else n
                                  for n in vs]
                              for k, vs in op.outputs.items()}
                rename_in(op, name, inner.name)
            v.shape = _nchw_shape(v.shape)
            new_ops.append(Operator(block, "transpose", {"X": [inner.name]},
                                    {"Out": [name]}, {"axis": [0, 3, 1, 2]}))
    block.ops[:] = new_ops
    program._version += 1
    return converted


# ---------------------------------------------------------------------------
# fc+RNN fusion (fc_lstm_fuse_pass.cc / fc_gru_fuse_pass.cc): the
# x-projection matmul (+ bias adds) feeding an lstm/gru collapses into
# the fusion_lstm / fusion_gru op
# ---------------------------------------------------------------------------

def _fuse_fc_rnn(program, scope, keep_vars, rnn_type, fused_type,
                 gate_mult):
    """Shared fc+lstm / fc+gru rewrite.  Pattern (use counts of 1 on the
    intermediates, LastH/LastC unused):

        mul(X, Wx)[x_num_col_dims=2] -> [elementwise_add(b)]{1,2} -> rnn

    becomes ``fused_type`` with the bias vectors summed into one
    [1, G·H] Bias param.  ``gate_mult`` (4 for lstm, 3 for gru) admits
    only true gate biases of length G·H."""
    block = program.global_block
    uses = _use_counts(program, keep_vars)
    fused = 0
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type != rnn_type:
            i += 1
            continue
        if op.attrs.get("use_pallas_kernel") is not None:
            i += 1
            continue
        # LastH/LastC must be dead (the fusion ops do not emit them)
        last_names = [n for slot in ("LastH", "LastC")
                      for n in op.output(slot)]
        if any(uses.get(n, 0) > 0 for n in last_names):
            i += 1
            continue
        # walk the Input producer chain: up to two bias adds, then the mul
        chain = []
        biases = []
        cur = op.input("Input")[0]
        j = i - 1
        mul_op = None
        while j >= 0 and len(chain) < 3:
            p = block.ops[j]
            if cur in p.output_arg_names():
                y_shape = tuple(block.var(p.input("Y")[0]).shape or ())
                H = (block.var(op.input("Weight")[0]).shape or (0,))[0]
                if (p.type == "elementwise_add"
                        and p.output("Out") == [cur]
                        and uses.get(cur, 0) == 1
                        and y_shape == (gate_mult * H,)
                        and p.attr("axis", -1) in (-1, 2)):
                    biases.append(p.input("Y")[0])
                    chain.append(p)
                    cur = p.input("X")[0]
                elif (p.type == "mul" and p.output("Out") == [cur]
                        and uses.get(cur, 0) == 1
                        and p.attr("x_num_col_dims", 1) == 2):
                    mul_op = p
                    chain.append(p)
                    break
                else:
                    break
            j -= 1
        if mul_op is None or not biases:
            i += 1
            continue
        bias_vals = [_scope_array(scope, n) for n in biases]
        if any(b is None for b in bias_vals):
            i += 1
            continue
        bias_vals = [b.reshape(-1) for b in bias_vals]
        total = bias_vals[0]
        for b in bias_vals[1:]:
            total = total + b
        bias_name = f"{op.output('Hidden')[0]}@FUSED_BIAS"
        block.create_var(name=bias_name, shape=(1, total.shape[0]),
                         dtype=str(total.dtype), persistable=True)
        _scope_put(scope, bias_name, total.reshape(1, -1), like=biases[0])

        ins = {"X": mul_op.input("X"), "WeightX": mul_op.input("Y"),
               "WeightH": op.input("Weight"), "Bias": [bias_name]}
        for slot in ("H0", "C0", "SeqLen"):
            if op.input(slot):
                ins[slot] = op.input(slot)
        xx = block.create_var(
            name=f"{op.output('Hidden')[0]}@XX",
            dtype=block.var(op.output("Hidden")[0]).dtype,
            shape=block.var(mul_op.output("Out")[0]).shape)
        outs = {"Hidden": op.output("Hidden"), "XX": [xx.name]}
        if rnn_type == "lstm":
            outs["Cell"] = op.output("Cell")
        op.type = fused_type
        op.inputs = ins
        op.outputs = outs
        for dead in chain:
            block.ops.remove(dead)
            i -= 1
        program._version += 1
        fused += 1
        # the rewrite removed ops and rewired inputs: refresh the counts
        uses = _use_counts(program, keep_vars)
        i += 1
    return fused


def fuse_fc_lstm(program: Program, scope=None, keep_vars=()) -> int:
    return _fuse_fc_rnn(program, scope, keep_vars, "lstm", "fusion_lstm", 4)


def fuse_fc_gru(program: Program, scope=None, keep_vars=()) -> int:
    return _fuse_fc_rnn(program, scope, keep_vars, "gru", "fusion_gru", 3)


# ---------------------------------------------------------------------------
# int8 serving calibration: scales from QAT fake-quant stats (or the
# weights' abs-max), mul/fused_fc ops stamped for K5
# (kernels/quant.py Int8Plan, consulted by core/lowering.py)
# ---------------------------------------------------------------------------

# the epilogue set of kernels/quant.py; a fused_fc with any other act
# (or act attrs) stays float32
_INT8_ACTS = {"", "relu", "sigmoid", "tanh", "gelu"}

_FAKE_QUANT_OPS = ("fake_quantize_abs_max",
                   "fake_channel_wise_quantize_abs_max",
                   "fake_quantize_moving_average_abs_max")


def quantize_int8(program: Program, scope, keep_vars=()) -> int:
    """Calibrate the program for int8 inference (AnalysisConfig
    ``enable_int8()``; run by create_predictor after the fusion passes).

    1. QAT fake-quant ops fold OUT of the graph: consumers rewire to the
       raw var, and a moving-average quantizer's running scale
       (``InScale``) becomes the consumer's static activation scale.
       abs_max quantizers are dynamic by design: their consumers
       quantize from the batch abs-max at dispatch.
    2. Every mul/fused_fc whose weight is a 2-D scope var gains the int8
       stamp: the weight is quantized now, per out channel, into
       ``<w>@INT8`` / ``<w>@INT8_SCALE`` sidecar vars (on the weight's
       device) plus the ``quant_int8``/``in_scale`` attrs.  The float32
       weight stays in the scope for the ops that keep their float32
       rule.

    Returns the number of ops calibrated."""
    block = program.global_block
    # -- 1) fold fake-quant ops, harvesting calibrated scales ----------
    in_scale_of: Dict[str, float] = {}
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type not in _FAKE_QUANT_OPS:
            i += 1
            continue
        out = op.output("Out")[0]
        if out in keep_vars:
            i += 1
            continue
        src = op.input("X")[0]
        scale = 0.0  # dynamic (batch abs-max at dispatch)
        if op.type == "fake_quantize_moving_average_abs_max" \
                and scope is not None and op.input("InScale"):
            sv = _scope_array(scope, op.input("InScale")[0])
            if sv is not None:
                scale = float(sv.reshape(-1)[0])
        for c in block.ops:
            if c is op:
                continue
            c.inputs = {slot: [src if n == out else n for n in names]
                        for slot, names in c.inputs.items()}
        in_scale_of[src] = scale
        del block.ops[i]
        program._version += 1

    # -- 2) stamp calibrated FC ops ------------------------------------
    count = 0
    for op in block.ops:
        if op.type not in ("mul", "fused_fc"):
            continue
        if op.attrs.get("quant_int8"):
            continue  # already calibrated (pass re-run)
        w_slot = "Y" if op.type == "mul" else "W"
        w_names = op.inputs.get(w_slot) or []
        if len(w_names) != 1 or scope is None:
            continue
        w_name = w_names[0]
        w = _scope_array(scope, w_name)
        if w is None or w.ndim != 2:
            continue
        if int(op.attrs.get("y_num_col_dims", 1)) != 1:
            continue
        act = op.attrs.get("act", "") or "" if op.type == "fused_fc" else ""
        # op_role rides every op's attrs; any OTHER act attr means the
        # epilogue cannot reproduce the activation exactly
        if act not in _INT8_ACTS or (
                op.type == "fused_fc"
                and any(k != "op_role"
                        for k in (op.attrs.get("act_attrs") or {}))):
            continue
        q, scales = Q.quantize_weight(w)
        qi_name = f"{w_name}@INT8"
        qs_name = f"{w_name}@INT8_SCALE"
        block.create_var(name=qi_name, shape=tuple(w.shape), dtype="int8",
                         persistable=True)
        block.create_var(name=qs_name, shape=(int(w.shape[1]),),
                         dtype="float32", persistable=True)
        _scope_put(scope, qi_name, q, like=w_name)
        _scope_put(scope, qs_name, scales, like=w_name)
        x_name = op.input("X")[0]
        in_scale = float(in_scale_of.get(x_name, 0.0))
        op.inputs["WInt8"] = [qi_name]
        op.inputs["WScale"] = [qs_name]
        op.attrs["quant_int8"] = True
        op.attrs["in_scale"] = in_scale
        program._version += 1
        count += 1
        Q.note_calibration({
            "op": op.type,
            "weight": w_name,
            "shape": [int(d) for d in w.shape],
            "act": act,
            "in_scale": in_scale,  # 0.0 = dynamic per dispatch
            "w_scale_min": float(scales.min()),
            "w_scale_max": float(scales.max()),
            "clip_fraction": Q.clip_fraction(q),
        })
    return count


# what the fused_elemwise_activation rule implements, attr-free
_ELEWISE_ACTS = {"relu", "sigmoid", "tanh"}


def fuse_elewise_add_act(program: Program, scope=None, keep_vars=()) -> int:
    """elementwise_add -> activation collapses into
    fused_elemwise_activation (fuse_elewise_add_act_pass.cc)."""
    block = program.global_block
    uses = _use_counts(program, keep_vars)
    fused = 0
    i = 0
    while i < len(block.ops) - 1:
        op, nxt = block.ops[i], block.ops[i + 1]
        if (op.type == "elementwise_add" and nxt.type in _ELEWISE_ACTS
                and nxt.input("X") == op.output("Out")
                and uses.get(op.output("Out")[0], 0) == 1):
            op.type = "fused_elemwise_activation"
            op.outputs = {"Out": nxt.output("Out")}
            op.attrs["functor_list"] = ["elementwise_add", nxt.type]
            del block.ops[i + 1]
            program._version += 1
            fused += 1
        i += 1
    return fused
