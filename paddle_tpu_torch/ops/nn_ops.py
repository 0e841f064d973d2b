"""Neural-net op rules: conv2d, depthwise_conv2d, pool2d, batch_norm,
layer_norm, norm, the losses, accuracy, the lstm and the gru, and the fused
ops of the inference passes (``fused_fc``, ``fusion_lstm``,
``fusion_gru``, ``fused_elemwise_activation``).

The port of the part of ``paddle_tpu/ops/nn_ops.py`` that the
Transformer's, the stacked LSTM's, DeepFM's, machine translation's and
the convolutional models' training programs, the fc/SGD drive and the
predictor use.  Statistics are taken in at least float32, as the
reference's ``_stat_dtype``.

Convolutions and pools run through torch's own (cuDNN on the card), as
the reference's run through XLA: no hand-written kernel lies on this
path.  An NHWC activation is permuted to an NCHW-shaped view, whose
strides are channels-last, so the library takes its NHWC kernels with
no copy; the result is permuted back, an NHWC tensor in NHWC memory.
The one copy is of an input that is not yet NHWC in memory: the
``transpose`` at a model's entry is a view of the NCHW feed, which the
first convolution lays out channels-last.  Filters are OIHW in both
layouts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import registry as _registry
from ..core.registry import register, register_grad
from ..kernels import rnn as _rnn
from ..observability import stats as _obs_stats
from .math_ops import relu


def _stat_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _nchw_view(x, layout):
    """An NCHW-shaped view of ``x``: for NHWC, of ``x`` laid out NHWC
    in memory (a copy only when it is not), so channels-last strides."""
    return x.contiguous().permute(0, 3, 1, 2) if layout == "NHWC" else x


def _from_nchw_view(y, layout):
    return y.permute(0, 2, 3, 1) if layout == "NHWC" else y


# ---------------------------------------------------------------------------
# conv / pool
# ---------------------------------------------------------------------------

@register("conv2d", no_grad_slots=())
def _conv2d(ctx, ins, attrs):
    """conv_op.cc: ``F.conv2d`` with strides, symmetric paddings,
    dilations and groups; the filter is OIHW whatever ``data_layout``.
    The reference computes NHWC's 7x7/s2 stem on at most 4 channels
    through a space-to-depth rewrite (a TPU lane trick with the same
    function); here it is the plain convolution."""
    x, w = ins["Input"][0], ins["Filter"][0]
    layout = attrs.get("data_layout", "NCHW")
    pads = _pair(attrs.get("paddings", [0, 0]))
    y = F.conv2d(_nchw_view(x, layout), w,
                 stride=_pair(attrs.get("strides", [1, 1])),
                 padding=pads, dilation=_pair(attrs.get("dilations", [1, 1])),
                 groups=attrs.get("groups", 1))
    return {"Output": [_from_nchw_view(y, layout)]}


@register("depthwise_conv2d", no_grad_slots=())
def _depthwise_conv2d(ctx, ins, attrs):
    """conv2d with one group per input channel (the channel dim of the
    op's layout)."""
    x = ins["Input"][0]
    c = x.shape[-1 if attrs.get("data_layout", "NCHW") == "NHWC" else 1]
    return _conv2d(ctx, ins, {**attrs, "groups": c})


@register("pool2d")
def _pool2d(ctx, ins, attrs):
    """pool_op.cc, max or avg, either layout.  Max pads with -inf; avg
    sums in at least float32 and casts back, dividing by the window's
    in-bounds count when ``exclusive`` and there is padding, by the
    window's size otherwise.  ``global_pooling`` takes the whole
    spatial extent; ``ceil_mode`` is not an attr of the op (the layer
    drops it, as the reference's)."""
    layout = attrs.get("data_layout", "NCHW")
    x = _nchw_view(ins["X"][0], layout)
    if attrs.get("global_pooling", False):
        ks, strides, pads = tuple(x.shape[2:]), tuple(x.shape[2:]), (0, 0)
    else:
        ks = _pair(attrs["ksize"])
        strides = _pair(attrs.get("strides", [1, 1]))
        pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("pooling_type", "max") == "max":
        y = F.max_pool2d(x, ks, strides, pads)
    else:
        exclusive = attrs.get("exclusive", True) and any(pads)
        y = F.avg_pool2d(x.to(_stat_dtype(x)), ks, strides, pads,
                         count_include_pad=not exclusive).to(x.dtype)
    return {"Out": [_from_nchw_view(y, layout)]}


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@register("batch_norm", no_grad_slots=("Mean", "Variance"))
def _batch_norm(ctx, ins, attrs):
    """batch_norm_op.cc with the reference's arithmetic.  Training
    takes one-pass batch statistics in at least float32, E[x] and
    max(E[x^2] - E[x]^2, 0) (the biased variance; not Welford, not two
    passes), and updates the running stats as ``old * momentum + batch
    * (1 - momentum)`` with that biased variance (``F.batch_norm`` would
    use the unbiased one).  ``is_test`` (the attr, or an inference
    executor) uses the running stats.  The per-channel factors
    ``inv_s = rsqrt(var + eps) * scale`` and ``shift = bias - mean *
    inv_s`` are computed in float32 and cast to the activation's dtype,
    and ``y = x * inv_s + shift`` runs in that dtype (two roundings in
    bfloat16, as the reference's).  SavedVariance is rsqrt(var + eps).
    The channel is dim 1 (NCHW, and 2-D inputs) or the last dim
    (NHWC)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or not ctx.training
    ch = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    bshape = [1] * x.dim()
    bshape[ch] = -1
    sdt = _stat_dtype(x)
    if is_test:
        use_mean, use_var = mean, var
        mean_out, var_out, saved_mean = mean, var, mean
    else:
        xf = x.to(sdt)
        use_mean = xf.mean(dim=axes)
        use_var = torch.clamp_min(
            (xf * xf).mean(dim=axes) - use_mean * use_mean, 0.0)
        mean_out = mean * momentum + use_mean * (1.0 - momentum)
        var_out = var * momentum + use_var * (1.0 - momentum)
        saved_mean = use_mean
    inv = torch.rsqrt(use_var.to(sdt) + eps)
    inv_s = inv * scale.to(sdt)
    shift = bias.to(sdt) - use_mean.to(sdt) * inv_s
    y = (x * inv_s.reshape(bshape).to(x.dtype)
         + shift.reshape(bshape).to(x.dtype))
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [inv]}


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """layer_norm_op.cc: normalize over dims [begin_norm_axis:], affine
    with flattened Scale/Bias."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    bshape = [1] * bna + list(x.shape[bna:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    lead = tuple(x.shape[:bna])
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


@register("norm")
def _norm(ctx, ins, attrs):
    """norm_op.cc: x over its L2 norm along ``axis`` (``layers.
    l2_normalize``); Norm is sqrt(sum(x^2) + epsilon), kept dims."""
    x = ins["X"][0]
    axis = attrs.get("axis", 1)
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                      + eps)
    return {"Out": [x / norm], "Norm": [norm]}


def _squeeze_label(label):
    if label.dim() >= 2 and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


@register("cross_entropy", no_grad_slots=("Label",))
def _cross_entropy(ctx, ins, attrs):
    """-log(p + 1e-8) of the label's probability (hard labels) or
    -sum(label * log(p + 1e-8)) (soft labels)."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(x + eps)).sum(dim=-1, keepdim=True)
    else:
        li = _squeeze_label(label).long()
        loss = -torch.log(x.gather(-1, li.unsqueeze(-1)) + eps)
    return {"Y": [loss]}


@register("softmax_with_cross_entropy", no_grad_slots=("Label",))
def _softmax_xent(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    lf = logits.to(_stat_dtype(logits))
    log_softmax = lf - torch.logsumexp(lf, dim=-1, keepdim=True)
    if attrs.get("soft_label", False):
        loss = -(label * log_softmax).sum(dim=-1, keepdim=True)
    else:
        li = _squeeze_label(label).long()
        picked = log_softmax.gather(-1, li.unsqueeze(-1))
        if attrs.get("ignore_index", -100) != -100:
            picked = picked * (li.unsqueeze(-1)
                               != attrs["ignore_index"]).to(picked.dtype)
        loss = -picked
    return {"Softmax": [log_softmax.exp().to(logits.dtype)],
            "Loss": [loss.to(logits.dtype)]}


@register("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.square(x - y)]}


@register("sigmoid_cross_entropy_with_logits", no_grad_slots=("Label",))
def _sce_logits(ctx, ins, attrs):
    """max(x, 0) - x * label + log1p(exp(-|x|)), elementwise; the max
    is ``torch.maximum``, whose gradient splits a tie as ``jnp.maximum``
    does."""
    x, label = ins["X"][0], ins["Label"][0]
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    return {"Out": [loss]}


@register("accuracy", no_grad_slots=("Out", "Indices", "Label"))
def _accuracy(ctx, ins, attrs):
    """accuracy_op.cc: the share of rows whose label is among the top-k
    Indices; Correct and Total are int32."""
    idx = ins["Indices"][0]
    label = _squeeze_label(ins["Label"][0])
    correct = (idx == label.unsqueeze(-1)).any(dim=-1)
    num_correct = correct.sum(dtype=torch.int32)
    total = torch.full((), idx.shape[0], dtype=torch.int32, device=idx.device)
    acc = num_correct.float() / total.float()
    return {"Accuracy": [acc], "Correct": [num_correct], "Total": [total]}


# ---------------------------------------------------------------------------
# lstm over a padded batch + length mask (gate order i, f, g, o)
# ---------------------------------------------------------------------------

def _length_mask(seq_len, B: int, T: int, dtype, device):
    if seq_len is None:
        return torch.ones(B, T, dtype=dtype, device=device)
    t = torch.arange(T, device=device)[None, :]
    return (t < seq_len[:, None]).to(dtype)


def _rnn_inputs(ins, n_gates: int, state_slots):
    """(xproj, w, one [B, H] initial state per slot (zeros when the op
    has none), mask [B, T] float32) of an lstm (4 gates) or gru (3) op."""
    xproj, w = ins["Input"][0], ins["Weight"][0]
    B, T, HN = xproj.shape
    H = HN // n_gates

    def state(slot):
        if ins.get(slot):
            return ins[slot][0].to(xproj.dtype).contiguous()
        return torch.zeros(B, H, dtype=xproj.dtype, device=xproj.device)

    seq_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    mask = _length_mask(seq_len, B, T, torch.float32, xproj.device)
    return (xproj, w.contiguous(), *map(state, state_slots), mask)


_routings = {}


def _count_routing(cell: str) -> None:
    """Add one to ``rnn.<cell>_scan_routings``: a top-level call the
    eligibility gate sent to the plain scan (a routing, as the
    reference's, not a fault fallback)."""
    c = _routings.get(cell)
    if c is None:
        c = _routings[cell] = _obs_stats.scope("rnn").counter(
            f"{cell}_scan_routings",
            "top-level calls the kernel's eligibility gate sent to the "
            "plain scan")
    c.inc()


def _use_kernel(ctx, attrs, lib: str, xproj) -> bool:
    """Whether the rule runs the fused cell ``lib`` (``lstm_fwd``,
    ``lstm_bwd``, ``gru_fwd``, ``gru_bwd``: K6/K7, K8a/K8b, their plain
    versions for CPU tensors) or the plain scan.  The reference's
    ``_rnn_pallas_eligible``, with the port's gate:

    - inside a control-flow sub-block the plain scan runs whatever the
      attr says: a sub-block is differentiated by autograd through its
      ops (``ops/control_flow_ops.py``), and autograd cannot see through
      a kernel launched by ctypes (the reference keeps its Pallas cells
      to the top-level block for the same reason);
    - an explicit ``use_pallas_kernel`` wins: False takes the plain
      scan, True the fused cell, which raises on a shape it cannot take;
    - otherwise a CUDA tensor takes the kernel when
      ``kernels/rnn.py: lstm_eligible``/``gru_eligible`` pass at this
      shape on this card (float32, every block resident), and the plain
      scan when they do not, counted as ``rnn.<cell>_scan_routings``."""
    if ctx is not None and getattr(ctx.block, "idx", 0) != 0:
        return False
    force = attrs.get("use_pallas_kernel", None)
    if force is not None:
        return bool(force)
    if xproj.device.type != "cuda":
        return True
    cell = lib.split("_")[0]
    B, T, HN = xproj.shape
    H = HN // (4 if cell == "lstm" else 3)
    cap = _rnn.kernel_capacity(lib, B, H, xproj.device)
    if (_rnn.lstm_eligible(B, T, H, xproj.dtype, cap, lib) if cell == "lstm"
            else _rnn.gru_eligible(B, T, H, xproj.dtype, cap, lib)):
        return True
    _count_routing(cell)
    return False


@register("lstm", no_grad_slots=("SeqLen",))
def _lstm(ctx, ins, attrs):
    """Fused LSTM over a padded batch (lstm_op.cc; the reference's
    ``_lstm``).  Inputs: Input [B, T, 4H] (x·Wx + b, made by the layer),
    Weight [H, 4H], optional H0/C0 [B, H] and SeqLen [B].  Outputs:
    Hidden and Cell [B, T, H], LastH and LastC [B, H].  ``is_reverse``
    flips the whole padded time axis, masked steps included; LastH/LastC
    are the states of the last step of the flipped (scan) order."""
    xproj, w, h0, c0, mask = _rnn_inputs(ins, 4, ("H0", "C0"))
    reverse = attrs.get("is_reverse", False)
    if reverse:
        xproj, mask = torch.flip(xproj, [1]), torch.flip(mask, [1])
    run = (_rnn.lstm_fused if _use_kernel(ctx, attrs, "lstm_fwd", xproj)
           else _rnn.lstm_ref)
    hs, cs = run(xproj.contiguous(), w, h0, c0, mask.contiguous())
    h_last, c_last = hs[:, -1], cs[:, -1]
    if reverse:
        hs, cs = torch.flip(hs, [1]), torch.flip(cs, [1])
    return {"Hidden": [hs], "Cell": [cs], "LastH": [h_last],
            "LastC": [c_last]}


@register_grad("lstm")
def _lstm_grad(ctx, ins, attrs):
    """Explicit lstm backward from the saved Hidden/Cell (no forward
    re-run): K7, or the plain backward when ``use_pallas_kernel`` is
    False.  Missing cotangents count as zeros; LastH/LastC cotangents
    fold into the last scan-domain step."""
    xproj, w, h0, c0, mask = _rnn_inputs(ins, 4, ("H0", "C0"))
    hs, cs = ins["Hidden"][0], ins["Cell"][0]

    def cot(slot):
        g = ins.get(slot)
        if g and g[0] is not None:
            return g[0].float()
        return None

    zeros = torch.zeros_like(hs, dtype=torch.float32)
    dhs = cot("Hidden@GRAD")
    dcs = cot("Cell@GRAD")
    dhs = zeros if dhs is None else dhs
    dcs = zeros if dcs is None else dcs
    if attrs.get("is_reverse", False):
        xproj, mask, hs, cs, dhs, dcs = (torch.flip(v, [1]) for v in
                                         (xproj, mask, hs, cs, dhs, dcs))
    last_h, last_c = cot("LastH@GRAD"), cot("LastC@GRAD")
    if last_h is not None:
        dhs = dhs.clone()
        dhs[:, -1] += last_h
    if last_c is not None:
        dcs = dcs.clone()
        dcs[:, -1] += last_c
    run = (_rnn.lstm_fused_grad if _use_kernel(ctx, attrs, "lstm_bwd", xproj)
           else _rnn.lstm_grad_ref)
    dxs, dw, dh0, dc0 = run(
        xproj.contiguous(), w, h0, c0, mask.contiguous(), hs.contiguous(),
        cs.contiguous(), dhs.contiguous(), dcs.contiguous())
    if attrs.get("is_reverse", False):
        dxs = torch.flip(dxs, [1])
    outs = {"Input@GRAD": [dxs], "Weight@GRAD": [dw]}
    if ins.get("H0"):
        outs["H0@GRAD"] = [dh0]
    if ins.get("C0"):
        outs["C0@GRAD"] = [dc0]
    return outs


# ---------------------------------------------------------------------------
# gru over a padded batch + length mask (gates update, reset, candidate)
# ---------------------------------------------------------------------------

@register("gru", no_grad_slots=("SeqLen",))
def _gru(ctx, ins, attrs):
    """Fused GRU over a padded batch (gru_op.cc; the reference's
    ``_gru``).  Inputs: Input [B, T, 3H] (x·Wx + b, made by the layer),
    Weight [H, 3H] as [update | reset | candidate], optional H0 [B, H]
    and SeqLen [B].  Outputs: Hidden [B, T, H] and LastH [B, H].
    ``is_reverse`` flips the whole padded time axis, masked steps
    included; LastH is the state of the last step of the flipped (scan)
    order."""
    xproj, w, h0, mask = _rnn_inputs(ins, 3, ("H0",))
    reverse = attrs.get("is_reverse", False)
    if reverse:
        xproj, mask = torch.flip(xproj, [1]), torch.flip(mask, [1])
    run = (_rnn.gru_fused if _use_kernel(ctx, attrs, "gru_fwd", xproj)
           else _rnn.gru_ref)
    hs = run(xproj.contiguous(), w, h0, mask.contiguous())
    h_last = hs[:, -1]
    if reverse:
        hs = torch.flip(hs, [1])
    return {"Hidden": [hs], "LastH": [h_last]}


@register_grad("gru")
def _gru_grad(ctx, ins, attrs):
    """Explicit gru backward from the saved Hidden (no forward re-run):
    K8b, or the plain backward when ``use_pallas_kernel`` is False or
    inside a sub-block.  A missing Hidden cotangent counts as zeros; a
    LastH cotangent folds into the last scan-domain step; H0@GRAD only
    when H0 is an input."""
    xproj, w, h0, mask = _rnn_inputs(ins, 3, ("H0",))
    hs = ins["Hidden"][0]
    g = ins.get("Hidden@GRAD")
    dhs = (g[0].float() if g and g[0] is not None
           else torch.zeros_like(hs, dtype=torch.float32))
    if attrs.get("is_reverse", False):
        xproj, mask, hs, dhs = (torch.flip(v, [1]) for v in
                                (xproj, mask, hs, dhs))
    g = ins.get("LastH@GRAD")
    if g and g[0] is not None:
        dhs = dhs.clone()
        dhs[:, -1] += g[0].float()
    run = (_rnn.gru_fused_grad if _use_kernel(ctx, attrs, "gru_bwd", xproj)
           else _rnn.gru_grad_ref)
    dxs, dw, dh0 = run(xproj.contiguous(), w, h0, mask.contiguous(),
                       hs.contiguous(), dhs.contiguous())
    if attrs.get("is_reverse", False):
        dxs = torch.flip(dxs, [1])
    outs = {"Input@GRAD": [dxs], "Weight@GRAD": [dw]}
    if ins.get("H0"):
        outs["H0@GRAD"] = [dh0]
    return outs


# ---------------------------------------------------------------------------
# the fused ops the inference passes emit (inference/passes.py)
# ---------------------------------------------------------------------------

@register("fused_fc")
def _fused_fc(ctx, ins, attrs):
    """mul + bias + activation in one op, emitted by ``fuse_fc_act``
    (fc_fuse_pass.cc).  Runs the registered ``mul``,
    ``elementwise_add`` and activation rules, so the fused op computes
    what the chain it replaced computed.  A ``fused_fc`` the
    ``quantize_int8`` pass stamped runs through K5 instead
    (``core/lowering.py``)."""
    out = _registry.get("mul").lower(
        ctx, {"X": ins["X"], "Y": ins["W"]},
        {"x_num_col_dims": attrs.get("x_num_col_dims", 1),
         "y_num_col_dims": attrs.get("y_num_col_dims", 1)})["Out"][0]
    if ins.get("Bias"):
        out = _registry.get("elementwise_add").lower(
            ctx, {"X": [out], "Y": ins["Bias"]},
            {"axis": attrs.get("axis", -1)})["Out"][0]
    act = attrs.get("act") or ""
    if act:
        out = _registry.get(act).lower(
            ctx, {"X": [out]}, dict(attrs.get("act_attrs") or {}))["Out"][0]
    return {"Out": [out]}


def _inference_attrs(ctx, attrs):
    """A fusion op in training takes the plain scan: it has no grad rule
    of its own and autograd differentiates it through its forward,
    which cannot see through a kernel launched by ctypes (the
    reference's ``jax.vjp`` cannot see through its Pallas cell either).
    In inference it keeps the kernel routing of ``_use_kernel``."""
    if ctx is not None and ctx.training:
        return {**attrs, "use_pallas_kernel": False}
    return attrs


@register("fusion_lstm", no_grad_slots=("SeqLen",))
def _fusion_lstm(ctx, ins, attrs):
    """fusion_lstm_op.cc: fc(x) + LSTM in one op, emitted by
    ``fuse_fc_lstm``.  X [B, T, M], WeightX [M, 4D], WeightH [D, 4D],
    Bias [1, 4D]; the ``lstm`` rule does the rest (K6 in inference)."""
    if attrs.get("use_peepholes", False):
        raise NotImplementedError(
            "fusion_lstm: use_peepholes=True (the [1, 7D] bias layout) is "
            "not ported; the in-scope models run peephole-free")
    xproj = torch.matmul(ins["X"][0], ins["WeightX"][0])
    if ins.get("Bias"):
        xproj = xproj + ins["Bias"][0].reshape(1, 1, -1)
    sub = {"Input": [xproj], "Weight": [ins["WeightH"][0]]}
    for slot in ("H0", "C0", "SeqLen"):
        if ins.get(slot):
            sub[slot] = ins[slot]
    out = _lstm(ctx, sub, _inference_attrs(ctx, attrs))
    return {"Hidden": out["Hidden"], "Cell": out["Cell"], "XX": [xproj]}


@register("fusion_gru", no_grad_slots=("SeqLen",))
def _fusion_gru(ctx, ins, attrs):
    """fusion_gru_op.cc: fc(x) + GRU in one op, emitted by
    ``fuse_fc_gru``; the ``gru`` rule does the rest (K8a in
    inference)."""
    xproj = torch.matmul(ins["X"][0], ins["WeightX"][0])
    if ins.get("Bias"):
        xproj = xproj + ins["Bias"][0].reshape(1, 1, -1)
    sub = {"Input": [xproj], "Weight": [ins["WeightH"][0]]}
    for slot in ("H0", "SeqLen"):
        if ins.get(slot):
            sub[slot] = ins[slot]
    out = _gru(ctx, sub, _inference_attrs(ctx, attrs))
    return {"Hidden": out["Hidden"], "XX": [xproj]}


@register("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """fused_elemwise_activation_op.cc: a binary op and a unary
    activation in one op, ``functor_list`` like ["elementwise_add",
    "relu"] (binary first) or ["relu", "elementwise_add"] (unary on Y
    first), emitted by ``fuse_elewise_add_act``."""
    x, y = ins["X"][0], ins["Y"][0]
    functors = [f.lower() for f in attrs["functor_list"]]
    axis = attrs.get("axis", -1)

    def binary(name, a, b):
        if b.dim() < a.dim() and axis != -1:
            b = b.reshape(tuple(b.shape) + (1,) * (a.dim() - b.dim() - axis))
        return {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
                "elementwise_mul": torch.mul}[name](a, b)

    def unary(name, a):
        if name == "scale":
            return a * attrs.get("scale", 1.0)
        return {"relu": relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh}[name](a)

    if functors[0].startswith("elementwise"):
        inter = binary(functors[0], x, y)
        out = unary(functors[1], inter)
    else:
        inter = unary(functors[0], y)
        out = binary(functors[1], x, inter)
    return {"Out": [out], "IntermediateOut": [inter]}
