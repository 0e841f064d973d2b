"""Low-precision serving: the fused-dequant int8 FC (K5) and the int8
KV-cache round trip.

The port of ``paddle_tpu/kernels/quant.py``.

- :func:`int8_fc` (K5, the reference's ``_fc_kernel``/``int8_fc``): one
  launch computes a calibrated FC layer as an int8 x int8 -> int32
  product with the dequant, bias and activation fused in its epilogue.
  Weights arrive quantized per out channel by the ``quantize_int8``
  pass (``inference/passes.py``, through :func:`quantize_weight`);
  activations are quantized per dispatch by :func:`_quantize_act`,
  with the scale the QAT statistics calibrated when there is one, else
  the batch abs-max, reduced on the device (no host sync).  CPU tensors
  take :func:`int8_fc_plain`; CUDA tensors launch
  ``csrc/int8_fc.cu`` on the current stream, or raise.  Each launch
  adds one to ``int8_fc.launches``.  K5 reads the weight K-major: the
  wrapper keeps each weight's K-major copy beside its [K, N] codes for
  as long as they live, made at the weight's first launch (counted as
  ``quant.kmajor_copies``), so a dispatch transposes no weight.
- :class:`Int8Plan` / :func:`plan_int8`: the ``core/lowering.py``
  peephole over the ``mul``/``fused_fc`` ops the pass stamped.  What
  the epilogue cannot compute (an act outside the set, act attrs other
  than ``op_role``, ``y_num_col_dims != 1``, an op stamped by half) is
  decided by an explicit check before the launch, counted as
  ``quant.lower_fallbacks``, and the op takes its float32 rule.  The
  reference's ``try``/``except`` fallbacks (``int8_fc`` returning None,
  ``Int8Plan.lower`` returning False on any fault) are not carried
  over: a build or launch failure raises.
- the KV helpers (:func:`kv_head_amax`, :func:`kv_quantize`,
  :func:`kv_dequantize`): ONE definition of the int8 round trip that
  the paged cache writers (:mod:`paddle_tpu_torch.decode.model`), the
  paged decode-attention kernel and its plain version use.
- ``/quantz``: :func:`note_calibration`, :func:`calibrations`,
  :func:`quantz`, :func:`quantz_text` and the ``quant.*`` counters.

Scale semantics everywhere (r=127): ``q = clip(round(x / s * 127),
-127, 127)`` and ``x ~= q * s / 127``, with ``s`` a float abs-max.
``torch.round`` rounds half to even, like ``jnp.round``, so codes match
the reference bit for bit.  A product of two such codes dequantizes
with ``(s_x * s_w[j]) / 127^2`` per out channel j.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..observability import stats as _obs_stats
from . import _build

__all__ = [
    "Int8Plan",
    "QMAX",
    "SCALE_EPS",
    "calibrations",
    "clip_fraction",
    "int8_fc",
    "int8_fc_plain",
    "kv_dequantize",
    "kv_head_amax",
    "kv_quantize",
    "note_calibration",
    "note_kv_cache",
    "plan_int8",
    "quantize_weight",
    "quantz",
    "quantz_text",
]

QMAX = 127
# scales never reach zero: an all-zero row quantizes to code 0 instead
# of dividing by zero
SCALE_EPS = 1e-8

# the activations the fused epilogue computes, by the C entry point's
# code; gelu is jax.nn.gelu's default, the tanh approximation
_EPILOGUE_ACTS = {"": 0, "relu": 1, "sigmoid": 2, "tanh": 3, "gelu": 4}

_LIB = "int8_fc"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# int8_fc(xq, wt, w_scale, sx, bias, out, M, N, K, act, device, stream)
_ARGS = [_PTR] * 6 + [_INT] * 5 + [_PTR]

# the quant.* counters of the stats registry, by name; /quantz reads them
_counters: Dict[str, "_obs_stats.Counter"] = {}


def _count(name: str) -> None:
    """Add one to ``quant.<name>`` in the stats registry."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = _obs_stats.scope("quant").counter(name)
    c.inc()


# ---------------------------------------------------------------------------
# calibration (pass time, numpy): per-out-channel weight quantization
# ---------------------------------------------------------------------------

def quantize_weight(w):
    """Quantize a 2-D [K, N] FC weight per OUT channel (per column):
    ``(q int8 [K, N], scales float32 [N])``, the column abs-max the
    epilogue's dequant factors out of ``x @ w``."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"int8 FC weight must be 2-D, got {w.shape}")
    scales = np.maximum(np.max(np.abs(w), axis=0), SCALE_EPS)
    q = np.clip(np.round(w / scales[None, :] * QMAX),
                -QMAX, QMAX).astype(np.int8)
    return q, scales.astype(np.float32)


def clip_fraction(q) -> float:
    """Fraction of codes at the clip boundary (|q| == 127): the /quantz
    saturation signal."""
    q = np.asarray(q)
    if q.size == 0:
        return 0.0
    return float(np.mean(np.abs(q.astype(np.int32)) >= QMAX))


# ---------------------------------------------------------------------------
# the fused-dequant int8 FC
# ---------------------------------------------------------------------------

def _quantize_act(x, in_scale):
    """Per-dispatch activation quantization: ``(xq int8, sx float32
    [1])``.  ``in_scale`` is the calibrated scale as a float32 tensor on
    x's device (or a number), or 0/None for the batch abs-max, a
    reduction on the device."""
    xf = x.float()
    if isinstance(in_scale, torch.Tensor):
        sx = in_scale.reshape(1).to(device=x.device, dtype=torch.float32)
    elif in_scale and in_scale > 0.0:
        sx = torch.tensor([in_scale], dtype=torch.float32, device=x.device)
    else:
        sx = torch.clamp_min(xf.abs().amax().reshape(1), SCALE_EPS)
    xq = torch.clamp(torch.round(xf / sx * QMAX), -QMAX, QMAX)
    return xq.to(torch.int8), sx


def _dequant_scale(sx, w_scale):
    """``(s_x * w_scale) / 127^2``, float32, rounded as the kernel and
    the reference round it: a true division (on the card torch divides
    by a Python scalar as a multiply by its reciprocal, one rounding
    off)."""
    num = sx * w_scale.float()
    return torch.div(num, torch.full_like(num, QMAX * QMAX))


def _epilogue(acc, dq, bias, act: str):
    """``act(acc * dq + b)`` in float32, in the reference's order."""
    b = bias.float() if bias is not None else torch.zeros_like(dq)
    out = acc * dq + b
    if act == "relu":
        return torch.relu(out)
    if act == "sigmoid":
        return torch.sigmoid(out)
    if act == "tanh":
        return torch.tanh(out)
    if act == "gelu":
        return F.gelu(out, approximate="tanh")
    return out


def int8_fc_plain(x, w_q, w_scale, in_scale=0.0, bias=None, act: str = ""):
    """Plain K5 (``_fc_kernel`` after ``_quantize_act``): float32 [M, N].

    The int32 accumulation of the reference's kernel is taken exactly:
    the codes are multiplied in float64, whose 53-bit mantissa holds
    every partial sum (|sum| <= 127^2 K), and the total is rounded to
    float32 once, as the kernel's int32 -> float32 conversion does.
    The reference's XLA twin ``int8_fc_xla`` sums in float32 instead,
    exact only while |sum| < 2^24."""
    if act not in _EPILOGUE_ACTS:
        raise ValueError(f"int8_fc: act {act!r} is not in the epilogue set "
                         f"{sorted(_EPILOGUE_ACTS)}")
    xq, sx = _quantize_act(x, in_scale)
    acc = torch.matmul(xq.double(), w_q.double()).float()
    return _epilogue(acc, _dequant_scale(sx, w_scale), bias, act)


# w_q -> (its version counter when copied, w_q^T contiguous)
_KMAJOR = WeakIdKeyDictionary()


def _kmajor(w_q):
    """``w_q``'s K-major copy [N, K], the operand K5 reads: made at the
    weight's first launch and again only if ``w_q`` is written in place,
    each copy counted as ``quant.kmajor_copies``."""
    kept = _KMAJOR.get(w_q)
    if kept is None or kept[0] != w_q._version:
        kept = _KMAJOR[w_q] = (w_q._version, w_q.t().contiguous())
        _count("kmajor_copies")
    return kept[1]


def _kernel_fn():
    fn = getattr(_build.load(_LIB), _LIB)
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    return fn


def _raise_launch(err: int):
    fn = getattr(_build.load(_LIB), f"{_LIB}_error_string")
    fn.argtypes = [_INT]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{_LIB} launch failed: {fn(err).decode()} "
                       f"(cudaError {err})")


def int8_fc(x, w_q, w_scale, in_scale=0.0, bias=None, act: str = ""):
    """Fused-dequant int8 FC (module doc): float32 [M, N].

    ``x`` float [M, K]; ``w_q`` int8 [K, N]; ``w_scale`` float32 [N];
    ``in_scale`` the calibrated activation scale (a number or a float32
    tensor on x's device), 0 for the batch abs-max; ``bias`` float32
    [N] or None; ``act`` one of "", relu, sigmoid, tanh, gelu.  CPU
    tensors take :func:`int8_fc_plain`; CUDA tensors launch K5 on the
    current stream (on ``w_q``'s kept K-major copy), or raise."""
    if x.device.type == "cpu":
        return int8_fc_plain(x, w_q, w_scale, in_scale, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"int8_fc: unsupported device {x.device}")
    if act not in _EPILOGUE_ACTS:
        raise ValueError(f"int8_fc: act {act!r} is not in the epilogue set "
                         f"{sorted(_EPILOGUE_ACTS)}")
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"int8_fc: needs x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    M, K = x.shape
    N = w_q.shape[1]
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8_fc: w_q must be int8, got {w_q.dtype}")
    if tuple(w_scale.shape) != (N,) or w_scale.dtype != torch.float32:
        raise ValueError(f"int8_fc: w_scale must be float32 [{N}], got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    if bias is not None and (tuple(bias.shape) != (N,)
                             or bias.dtype != torch.float32):
        raise ValueError(f"int8_fc: bias must be float32 [{N}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    for name, t in (("w_q", w_q), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"int8_fc: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"int8_fc: {name} must be contiguous")
    xq, sx = _quantize_act(x, in_scale)
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    if M and N:
        stream = _build.current_stream(x)
        err = _kernel_fn()(xq.contiguous().data_ptr(),
                           _kmajor(w_q).data_ptr(), w_scale.data_ptr(),
                           sx.data_ptr(),
                           bias.data_ptr() if bias is not None else None,
                           out.data_ptr(), M, N, K, _EPILOGUE_ACTS[act],
                           x.device.index, stream)
        if err != 0:
            _raise_launch(err)
        int8_fc.launches += 1
        _count("matmul_launches")
    return out


int8_fc.launches = 0


# ---------------------------------------------------------------------------
# block-level peephole over calibrated mul / fused_fc ops
# ---------------------------------------------------------------------------

_SCALES: Dict[tuple, torch.Tensor] = {}


def _routing_reason(op):
    """Why a fully stamped op must keep its float32 rule, or None."""
    if op.type == "fused_fc":
        act = op.attrs.get("act", "") or ""
        # op_role is bookkeeping every op carries, not an act parameter
        if any(k != "op_role" for k in (op.attrs.get("act_attrs") or {})):
            return "act attrs outside the epilogue"
    else:
        act = ""
    if act not in _EPILOGUE_ACTS:
        return f"act {act!r} outside the epilogue"
    if int(op.attrs.get("y_num_col_dims", 1)) != 1:
        return "y_num_col_dims != 1"
    return None


class Int8Plan:
    """Peephole plan for a block: the ops the ``quantize_int8`` pass
    stamped (``quant_int8`` attr + WInt8/WScale sidecar inputs) that the
    epilogue can compute lower through :func:`int8_fc`.

    ``core/lowering.py`` asks ``covers(pos)`` per op and calls
    ``lower(pos, env)``, which fills the op's output into ``env``."""

    def __init__(self, positions):
        self._pos = dict(positions)  # block-op index -> op

    def covers(self, pos: int) -> bool:
        return pos in self._pos

    @staticmethod
    def _in_scale(op, device):
        """The op's calibrated scale as a float32 tensor on ``device``
        (made once per value and device, so a dispatch copies no scalar
        to the card), or 0.0 for the batch abs-max."""
        v = float(op.attrs.get("in_scale", 0.0))
        if v <= 0.0:
            return 0.0
        key = (v, str(device))
        t = _SCALES.get(key)
        if t is None:
            t = _SCALES[key] = torch.tensor([v], dtype=torch.float32,
                                            device=device)
        return t

    def lower(self, pos: int, env: dict) -> bool:
        op = self._pos[pos]
        bias = act = None
        if op.type == "fused_fc":
            bias = env[op.inputs["Bias"][0]].reshape(-1)
            act = op.attrs.get("act", "") or ""
        x = env[op.inputs["X"][0]]
        w_q = env[op.inputs["WInt8"][0]]
        w_scale = env[op.inputs["WScale"][0]]
        xnc = int(op.attrs.get("x_num_col_dims", 1))
        lead = tuple(int(d) for d in x.shape[:xnc])
        xm = x.reshape((int(np.prod(lead)) if lead else 1, -1))
        out = int8_fc(xm, w_q, w_scale, self._in_scale(op, x.device), bias,
                      act or "")
        env[op.outputs["Out"][0]] = out.reshape(lead + (int(w_q.shape[1]),))
        return True


def plan_int8(block):
    """Scan ``block`` for calibrated ops: an :class:`Int8Plan`, or None.
    An op qualifies only with the whole stamp (the attr and both sidecar
    inputs) and an epilogue that can compute it; a stamped op that does
    not qualify keeps its float32 rule, counted as
    ``quant.lower_fallbacks``."""
    positions = []
    for pos, op in enumerate(block.ops):
        if op.type not in ("mul", "fused_fc"):
            continue
        stamp = (bool(op.attrs.get("quant_int8")),
                 bool(op.inputs.get("WInt8")), bool(op.inputs.get("WScale")))
        if not any(stamp):
            continue
        if not all(stamp) or _routing_reason(op) is not None:
            _count("lower_fallbacks")
            continue
        positions.append((pos, op))
    return Int8Plan(positions) if positions else None


# ---------------------------------------------------------------------------
# KV-cache int8 round trip: ONE definition of the scale semantics
# ---------------------------------------------------------------------------

def kv_head_amax(rows: torch.Tensor) -> torch.Tensor:
    """Per-head abs-max of KV rows [..., H, D] -> [..., H] (the scale a
    block stores for each head)."""
    return torch.clamp_min(rows.float().abs().amax(dim=-1), SCALE_EPS)


def kv_quantize(rows: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Quantize KV rows [..., H, D] with per-head scales [..., H] ->
    int8 codes (the storage form of the paged cache)."""
    s = torch.clamp_min(scales.float(), SCALE_EPS)[..., None]
    q = torch.round(rows.float() / s * QMAX)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def kv_dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Dequantize int8 KV codes [..., H, D] with per-head scales
    [..., H] -> f32 rows."""
    s = torch.clamp_min(scales.float(), SCALE_EPS)[..., None]
    return q.float() * s / QMAX


# ---------------------------------------------------------------------------
# /quantz observability payload
# ---------------------------------------------------------------------------

# per-layer calibration records appended by the quantize_int8 pass
# (bounded; the page shows the latest per weight name)
_CALIB: List[dict] = []
_CALIB_CAP = 256
# KV caches noted by name: dtype and bytes a block
_KV_INFO: Dict[str, dict] = {}


def note_calibration(rec: dict) -> None:
    _CALIB.append(dict(rec))
    del _CALIB[:-_CALIB_CAP]


def calibrations() -> List[dict]:
    return list(_CALIB)


def note_kv_cache(name: str, info: dict) -> None:
    _KV_INFO[name] = dict(info)


def quantz() -> dict:
    """The /quantz payload: per-layer calibration records (scales, clip
    fractions), the quant.* counters and every noted KV cache."""
    latest: Dict[str, dict] = {}
    for rec in _CALIB:
        latest[str(rec.get("weight", len(latest)))] = rec
    return {
        "calibrated_layers": list(latest.values()),
        "counters": {k: c.value for k, c in _counters.items()},
        "kv_caches": {k: dict(v) for k, v in _KV_INFO.items()},
    }


def quantz_text() -> str:
    """Human rendering of :func:`quantz` (the ``?text=1`` form)."""
    z = quantz()
    lines = ["== int8 calibration =="]
    if not z["calibrated_layers"]:
        lines.append("  (no calibrated layers)")
    for rec in z["calibrated_layers"]:
        lines.append(
            "  {op:<10} w={weight}  shape={shape}  act={act!r}  "
            "in_scale={in_scale:.6g}  w_scale=[{lo:.4g}, {hi:.4g}]  "
            "clip={clip:.4%}".format(
                op=rec.get("op", "?"), weight=rec.get("weight", "?"),
                shape=rec.get("shape"), act=rec.get("act", ""),
                in_scale=float(rec.get("in_scale", 0.0)),
                lo=float(rec.get("w_scale_min", 0.0)),
                hi=float(rec.get("w_scale_max", 0.0)),
                clip=float(rec.get("clip_fraction", 0.0))))
    lines.append("== quant.* counters ==")
    if not z["counters"]:
        lines.append("  (none)")
    for k in sorted(z["counters"]):
        lines.append(f"  {k:<24} {z['counters'][k]}")
    lines.append("== quantized KV caches ==")
    if not z["kv_caches"]:
        lines.append("  (none)")
    for name in sorted(z["kv_caches"]):
        info = z["kv_caches"][name]
        lines.append("  {n}: dtype={d}  blocks={b}  "
                     "bytes/block={bb}  pool={p}".format(
                         n=name, d=info.get("dtype"),
                         b=info.get("num_blocks"),
                         bb=info.get("bytes_per_block"),
                         p=info.get("pool_bytes")))
    return "\n".join(lines) + "\n"
