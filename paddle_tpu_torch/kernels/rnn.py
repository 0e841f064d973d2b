"""Fused LSTM and GRU: the whole-sequence forward and backward of the
``lstm`` and ``gru`` ops.

The port of ``paddle_tpu/kernels/rnn.py`` (``_lstm_fwd_kernel``/
``lstm_fused``, ``_lstm_bwd_kernel``/``lstm_fused_grad``,
``_gru_fwd_kernel``/``gru_fused`` and ``_gru_bwd_kernel``/
``gru_fused_grad``).  Everything is batch-major: xproj [B, T, nH]
(x·Wx + b; LSTM gates in the order i, f, g, o, n = 4; GRU gates
[update | reset | candidate], n = 3), the recurrent weight w [H, nH],
the initial state h0 (and the LSTM's c0) [B, H], the length mask
[B, T] (1.0 = a live step), and the states hs (and cs) [B, T, H].

- :func:`lstm_ref`, :func:`lstm_grad_ref`, :func:`gru_ref` and
  :func:`gru_grad_ref` are the plain PyTorch versions: time loops with
  the exact math of the reference kernels.  States are carried in
  float32; a masked step passes them through unchanged; the backward
  recomputes the gates from hs[t-1] (h0 at t = 0) and folds (1 - m)
  into the carries, so gradients flow straight through masked steps.
  They are what the CPU runs and what the kernels are held against on
  the card.
- :func:`lstm_fused`, :func:`lstm_fused_grad`, :func:`gru_fused` and
  :func:`gru_fused_grad` take the plain versions for CPU tensors and
  launch the hand-written CUDA kernels ``csrc/lstm_fwd.cu`` (K6),
  ``csrc/lstm_bwd.cu`` (K7), ``csrc/gru_fwd.cu`` (K8a) and
  ``csrc/gru_bwd.cu`` (K8b) for CUDA tensors.  There is no fallback: a
  CUDA tensor goes to the kernel, and a shape the kernel cannot hold, a
  build failure or a launch failure raises.  Each launch adds one to
  the wrapper's ``launches``.

K7 runs in three launches (``csrc/lstm_bwd.cu``): the gates of every
step in one GEMM, the serial recurrence (dh_prev only) and dW in one
product.  :func:`lstm_grad_phases` is the same decomposition in plain
PyTorch, for the tests.

K6 runs as K7's recurrence does (``csrc/lstm_fwd.cu``): batch groups of
rows with a barrier each, W for 16 units a block in shared memory (8
past H=512, where 16 units' W no longer fits), the live rows' h_{t-1}
packed and multiplied in split TF32 on the tensor cores.

K8a runs as K6's recurrence does (``csrc/gru_fwd.cu``), with two group
barriers a step: h_{t-1} . w_uz gives u and r, then (r ⊙ h_{t-1}) . w_c
the candidate, each product over the group's live rows in split TF32,
with w's columns for the block's 16 units (8 past H=896) in shared
memory.

K8b runs as K7 does (``csrc/gru_bwd.cu``): the gates of every step in two
GEMMs, the recurrence in batch groups of rows with the block's 16 units'
rows of w (8 units' past H=896) in shared memory and two group barriers
a step (drh = db . w_c^T, then da . w_uz^T), and dw in one split
product.
:func:`gru_grad_phases` is the same decomposition in plain PyTorch, for
the tests.

The reference's ``lstm_supported``/``gru_supported`` gates (H % 128,
B % 8) follow TPU tiles and are not carried over.  The kernels take any
float32 B, T, H >= 1 whose persistent blocks can all be resident on the
card at once (ceil(H/16) for K6's, K7's, K8a's and K8b's recurrences,
whose batch groups run side by side as far as the card holds them and in
turn beyond that, and ceil(H/8) for K6 past H=512 and K8a and K8b past
H=896: up to H=1056 on an H100's 132 SMs) at the kernel's shared memory
a block, and raise ``ValueError`` naming the limit otherwise.  The
port's own gates, :func:`lstm_eligible` and :func:`gru_eligible`, say
which shapes those are, from the card's resident-block capacity at the
kernel's shared memory a block (:func:`kernel_capacity`); the ``lstm`` and
``gru`` ops route what fails them to the plain scan
(``ops/nn_ops.py: _use_kernel``), as the reference routes what its gates
refuse to its XLA scan.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_FWD, _BWD = "lstm_fwd", "lstm_bwd"
_GRU_FWD, _GRU_BWD = "gru_fwd", "gru_bwd"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FWD_ARGS = [_PTR] * 8 + [_INT] * 4 + [_PTR]
_BWD_ARGS = [_PTR] * 14 + [_INT] * 4 + [_PTR]
_GRU_FWD_ARGS = [_PTR] * 7 + [_INT] * 4 + [_PTR]
_GRU_BWD_ARGS = [_PTR] * 11 + [_INT] * 4 + [_PTR]
# hidden units one block of the recurrences owns (lstm_fwd.cu,
# lstm_bwd.cu, gru_fwd.cu, gru_bwd.cu); K6 takes 8 past H = _FWD_WIDE_H
# and K8a and K8b past H = _GRU_WIDE_H, where 16 units' W no longer fits
# a block's shared memory
_UNITS = 16
_FWD_WIDE_H = 512
_GRU_WIDE_H = 896
# codes the C entry points return besides a cudaError_t
_SMEM_OVER, _NOT_RESIDENT = -1, -2


def _gates(x_t, h, w, matmul=torch.matmul):
    """[B, 4H] pre-activations -> post-activation (i, f, g, o), float32."""
    H = h.shape[-1]
    pre = x_t.float() + matmul(h.to(w.dtype), w).float()
    return (torch.sigmoid(pre[:, :H]), torch.sigmoid(pre[:, H:2 * H]),
            torch.tanh(pre[:, 2 * H:3 * H]), torch.sigmoid(pre[:, 3 * H:]))


def lstm_ref(xproj, w, h0, c0, mask, matmul=torch.matmul):
    """Plain LSTM forward (``_lstm_fwd_kernel``): (hs, cs) [B, T, H].
    ``matmul`` is the recurrent product (``kernels/_tf32.py:
    matmul_tf32x3`` models K6's split TF32, for the tests)."""
    T = xproj.shape[1]
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(T):
        i, f, g, o = _gates(xproj[:, t], h, w, matmul)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[:, t, None].float()
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        hs.append(h.to(xproj.dtype))
        cs.append(c.to(xproj.dtype))
    return torch.stack(hs, 1), torch.stack(cs, 1)


def lstm_grad_ref(xproj, w, h0, c0, mask, hs, cs, dhs, dcs):
    """Plain LSTM backward (``_lstm_bwd_kernel``): (dxproj [B, T, 4H],
    dw [H, 4H], dh0 [B, H], dc0 [B, H])."""
    B, T, H4 = xproj.shape
    H = H4 // 4
    dev = xproj.device
    dh = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dc = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dw = torch.zeros(H, H4, dtype=torch.float32, device=dev)
    wt = w.float().t()
    dxs = [None] * T
    for t in reversed(range(T)):
        c_prev = (c0 if t == 0 else cs[:, t - 1]).float()
        h_prev = (h0 if t == 0 else hs[:, t - 1]).float()
        i, f, g, o = _gates(xproj[:, t], h_prev, w)
        c_t = cs[:, t].float()
        m = mask[:, t, None].float()
        dh_total = dhs[:, t].float() + dh
        dc_total = dcs[:, t].float() + dc
        dh_new = m * dh_total
        dc_new = m * dc_total
        tc = torch.tanh(c_t)
        do = dh_new * tc
        dc_new = dc_new + dh_new * o * (1.0 - tc * tc)
        di, df, dg = dc_new * g, dc_new * c_prev, dc_new * i
        dc = dc_new * f + (1.0 - m) * dc_total
        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dxs[t] = dgates.to(xproj.dtype)
        dh = torch.matmul(dgates, wt) + (1.0 - m) * dh_total
        dw = dw + torch.matmul(h_prev.t(), dgates)
    return (torch.stack(dxs, 1), dw.to(w.dtype), dh.to(xproj.dtype),
            dc.to(xproj.dtype))


def lstm_grad_phases(xproj, w, h0, c0, mask, hs, cs, dhs, dcs,
                     rows: int = 32, splits: int = 2, matmul=torch.matmul):
    """:func:`lstm_grad_ref`'s function in K7's three launches, for the
    tests (the card path never calls it): (A) the post-activation gates
    of every (row, step) from one product over the B*T rows; (B) the
    reverse recurrence per batch group of ``rows`` rows, dh_prev =
    dgates . W^T + the masked pass-through, with no product for a group
    whose rows are all masked at a step; (C) dW = Hprev^T . dgates as
    one product over the B*T rows, in ``splits`` K-wise parts summed in
    order.  ``matmul`` is every product (``kernels/_tf32.py:
    matmul_tf32x3`` models the kernel's split TF32)."""
    B, T, H4 = xproj.shape
    H = H4 // 4
    f = lambda x: x.float()  # noqa: E731
    hprev = torch.cat([f(h0)[:, None], f(hs)[:, :-1]], 1).reshape(B * T, H)
    pre = matmul(hprev, f(w)).reshape(B, T, H4) + f(xproj)
    gates = torch.cat([torch.sigmoid(pre[..., :2 * H]),
                       torch.tanh(pre[..., 2 * H:3 * H]),
                       torch.sigmoid(pre[..., 3 * H:])], -1)
    dx = torch.zeros(B, T, H4, dtype=torch.float32, device=xproj.device)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=xproj.device)
    dc0 = torch.empty_like(dh0)
    wt = f(w).t()
    for b0 in range(0, B, rows):
        g = slice(b0, min(B, b0 + rows))
        dh = torch.zeros_like(dh0[g])
        dc = torch.zeros_like(dh)
        for t in reversed(range(T)):
            i, fg, gg, o = gates[g, t].split(H, -1)
            c_prev = f(c0[g]) if t == 0 else f(cs[g, t - 1])
            m = f(mask[g, t, None])
            dh_total = f(dhs[g, t]) + dh
            dc_total = f(dcs[g, t]) + dc
            dh_new = m * dh_total
            tc = torch.tanh(f(cs[g, t]))
            dc_new = m * dc_total + dh_new * o * (1.0 - tc * tc)
            dc = dc_new * fg + (1.0 - m) * dc_total
            dgates = torch.cat([dc_new * gg * i * (1.0 - i),
                                dc_new * c_prev * fg * (1.0 - fg),
                                dc_new * i * (1.0 - gg * gg),
                                dh_new * tc * o * (1.0 - o)], -1)
            dx[g, t] = torch.where(m != 0, dgates, torch.zeros_like(dgates))
            pass_ = (1.0 - m) * dh_total
            dh = (matmul(dx[g, t], wt) + pass_ if bool((m != 0).any())
                  else pass_)
        dh0[g], dc0[g] = dh, dc
    k = B * T
    edges = [k * s // splits for s in range(splits + 1)]
    dgf = dx.reshape(k, H4)
    dw = None
    for s in range(splits):
        part = matmul(hprev[edges[s]:edges[s + 1]].t(),
                      dgf[edges[s]:edges[s + 1]])
        dw = part if dw is None else dw + part
    return (dx.to(xproj.dtype), dw.to(w.dtype), dh0.to(xproj.dtype),
            dc0.to(xproj.dtype))


def _units(lib: str, H: int) -> int:
    """Hidden units one block of ``lib`` owns at hidden size H: 16 for
    K6 up to H=512 and 8 past it, 16 for K8a and K8b up to H=896 and 8
    past it, 16 for K7's recurrence."""
    if lib == _BWD:
        return _UNITS
    wide = _FWD_WIDE_H if lib == _FWD else _GRU_WIDE_H
    return _UNITS if H <= wide else _UNITS // 2


def _blocks(lib: str, H: int) -> int:
    """Persistent blocks the kernel library ``lib`` needs resident at
    once: ceil(H / units a block) (:func:`_units`): one batch group's,
    and more run side by side when the card holds more blocks."""
    return -(-H // _units(lib, H))


def lstm_eligible(B: int, T: int, H: int, dtype, capacity: int,
                  lib: str = _FWD) -> bool:
    """Whether the LSTM kernel ``lib`` (``lstm_fwd``, K6, or
    ``lstm_bwd``, K7) takes this shape: float32, non-empty, and its
    persistent blocks (one batch group's: ceil(H/16), for K6 ceil(H/8)
    past H=512) within
    ``capacity``, the blocks of that kernel the
    card holds at once at this shape (SM count x blocks per SM with the
    kernel's shared memory a block; 0 when a block may not have that
    much).  Pure: the card's number comes from :func:`kernel_capacity`,
    or from the caller."""
    return (dtype == torch.float32 and min(B, T, H) >= 1
            and _blocks(lib, H) <= capacity)


def gru_eligible(B: int, T: int, H: int, dtype, capacity: int,
                 lib: str = _GRU_FWD) -> bool:
    """Whether the GRU kernel ``lib`` (``gru_fwd``, K8a, or ``gru_bwd``,
    K8b) takes this shape: float32, non-empty, and its persistent blocks
    within ``capacity`` (:func:`lstm_eligible`'s meaning): one batch
    group's ceil(H/16) for K8a's and K8b's recurrences, ceil(H/8) past
    H=896."""
    return (dtype == torch.float32 and min(B, T, H) >= 1
            and _blocks(lib, H) <= capacity)


_capacity = {}


def kernel_capacity(lib: str, B: int, H: int, device) -> int:
    """The blocks of the kernel library ``lib`` (one of ``lstm_fwd``,
    ``lstm_bwd``, ``gru_fwd``, ``gru_bwd``) the CUDA ``device`` holds at
    once at batch B and hidden size H, from the occupancy query with the
    kernel's shared memory a block (``*_smem_bytes``); 0 when a block
    may not have that much.  Cached per shape and device; builds the
    library at first use."""
    key = (lib, int(B), int(H), device.index)
    n = _capacity.get(key)
    if n is None:
        cap = getattr(_build.load(lib), f"{lib}_capacity")
        cap.argtypes = [_INT, _INT, _INT]
        cap.restype = _INT
        n = cap(B, H, device.index)
        if n < 0:
            raise RuntimeError(f"{lib} occupancy query failed "
                               f"(cudaError {-n})")
        _capacity[key] = n
    return n


def _kernel_fn(lib: str, argtypes):
    fn = getattr(_build.load(lib), lib)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _smem_bytes(lib: str, B: int, H: int) -> int:
    fn = getattr(_build.load(lib), f"{lib}_smem_bytes")
    fn.argtypes = [_INT, _INT]
    fn.restype = _INT
    return fn(B, H)


def _raise_launch(lib: str, err: int, B: int, H: int):
    if err == _SMEM_OVER:
        raise ValueError(
            f"{lib} kernel: B={B}, H={H} needs {_smem_bytes(lib, B, H)} "
            "bytes of shared memory a block, more than the card allows")
    if err == _NOT_RESIDENT:
        what = f"ceil(H/{_units(lib, H)})"
        raise ValueError(
            f"{lib} kernel: B={B}, H={H} needs {_blocks(lib, H)} "
            f"blocks resident at once ({what}, "
            f"{_smem_bytes(lib, B, H)} bytes of shared memory a block), "
            "more than the card holds")
    fn = getattr(_build.load(lib), f"{lib}_error_string")
    fn.argtypes = [_INT]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{lib} launch failed: {fn(err).decode()} "
                       f"(cudaError {err})")


def _check(cell: str, n_gates: int, xproj, w, mask, states,
           **extra) -> None:
    """What the kernels take; anything else raises (no fallback).
    ``states`` are the [B, H] initial states, ``extra`` the [B, T, H]
    ones."""
    tensors = {"xproj": xproj, "w": w, "mask": mask, **states, **extra}
    for name, t in tensors.items():
        if t.device != xproj.device:
            raise ValueError(f"{name} is on {t.device}, xproj on "
                             f"{xproj.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{cell} kernel: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{cell} kernel: {name} must be contiguous")
    if xproj.dim() != 3 or xproj.shape[2] % n_gates:
        raise ValueError(f"xproj must be [B, T, {n_gates}H], got "
                         f"{tuple(xproj.shape)}")
    B, T, HN = xproj.shape
    H = HN // n_gates
    if B < 1 or T < 1 or H < 1:
        raise ValueError(f"empty {cell} input {tuple(xproj.shape)}")
    want = {"w": (H, HN), "mask": (B, T)}
    want.update({n: (B, H) for n in states})
    want.update({n: (B, T, H) for n in extra})
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{cell} kernel: {name} must be {list(shape)}, "
                             f"got {list(tensors[name].shape)}")


def lstm_fused(xproj, w, h0, c0, mask):
    """Whole-sequence LSTM forward (module doc): (hs, cs) [B, T, H].

    CPU tensors take :func:`lstm_ref`; CUDA tensors launch K6 on the
    current stream, or raise."""
    if xproj.device.type == "cpu":
        return lstm_ref(xproj, w, h0, c0, mask)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_fused: unsupported device {xproj.device}")
    _check("lstm", 4, xproj, w, mask, {"h0": h0, "c0": c0})
    B, T, H4 = xproj.shape
    H = H4 // 4
    hs = torch.empty(B, T, H, dtype=torch.float32, device=xproj.device)
    cs = torch.empty_like(hs)
    words = getattr(_build.load(_FWD), "lstm_fwd_sync_words")
    words.argtypes = [_INT, _INT]
    words.restype = _INT
    # the batch groups' barriers (zeroed by lstm_fwd)
    barrier = torch.empty(words(B, H), dtype=torch.int32,
                          device=xproj.device)
    fn = _kernel_fn(_FWD, _FWD_ARGS)
    stream = _build.current_stream(xproj)
    err = fn(xproj.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
             mask.data_ptr(), hs.data_ptr(), cs.data_ptr(),
             barrier.data_ptr(), B, T, H, xproj.device.index, stream)
    if err != 0:
        _raise_launch(_FWD, err, B, H)
    lstm_fused.launches += 1
    return hs, cs


def lstm_fused_grad(xproj, w, h0, c0, mask, hs, cs, dhs, dcs):
    """Backward of :func:`lstm_fused` from the saved hs/cs and the
    cotangents dhs/dcs [B, T, H]: (dxproj, dw, dh0, dc0).

    CPU tensors take :func:`lstm_grad_ref`; CUDA tensors launch K7 on
    the current stream, or raise."""
    if xproj.device.type == "cpu":
        return lstm_grad_ref(xproj, w, h0, c0, mask, hs, cs, dhs, dcs)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_fused_grad: unsupported device "
                         f"{xproj.device}")
    _check("lstm", 4, xproj, w, mask, {"h0": h0, "c0": c0}, hs=hs, cs=cs,
           dhs=dhs, dcs=dcs)
    B, T, H4 = xproj.shape
    H = H4 // 4
    dxproj = torch.empty_like(xproj)
    dw = torch.empty_like(w)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    words = getattr(_build.load(_BWD), "lstm_bwd_sync_words")
    words.argtypes = [_INT, _INT]
    words.restype = _INT
    # the recurrence's group barriers and dW's split flags (zeroed by
    # lstm_bwd); the gates of every step live in dxproj's own buffer
    barrier = torch.empty(words(B, H), dtype=torch.int32,
                          device=xproj.device)
    fn = _kernel_fn(_BWD, _BWD_ARGS)
    stream = _build.current_stream(xproj)
    err = fn(xproj.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
             mask.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
             dcs.data_ptr(), dxproj.data_ptr(), dw.data_ptr(),
             dh0.data_ptr(), dc0.data_ptr(), barrier.data_ptr(), B, T, H,
             xproj.device.index, stream)
    if err != 0:
        _raise_launch(_BWD, err, B, H)
    lstm_fused_grad.launches += 1
    return dxproj, dw, dh0, dc0


lstm_fused.launches = 0
lstm_fused_grad.launches = 0


# ---------------------------------------------------------------------------
# GRU: gates [update | reset | candidate]; the candidate's product takes
# r ⊙ h, so h_t = u ⊙ h + (1 - u) ⊙ tanh(x_c + (r ⊙ h) @ w_c)
# ---------------------------------------------------------------------------

def _gru_gates(x_t, h, w, matmul=torch.matmul):
    """Post-activation (u, r, c) of one step, float32."""
    H = h.shape[-1]
    a = x_t[:, :2 * H].float() + matmul(h.to(w.dtype), w[:, :2 * H]).float()
    u, r = torch.sigmoid(a[:, :H]), torch.sigmoid(a[:, H:])
    b = x_t[:, 2 * H:].float() + matmul((r * h).to(w.dtype),
                                        w[:, 2 * H:]).float()
    return u, r, torch.tanh(b)


def gru_ref(xproj, w, h0, mask, matmul=torch.matmul):
    """Plain GRU forward (``_gru_fwd_kernel``): hs [B, T, H].
    ``matmul`` is both recurrent products (``kernels/_tf32.py:
    matmul_tf32x3`` models K8a's split TF32, for the tests)."""
    h = h0.float()
    hs = []
    for t in range(xproj.shape[1]):
        u, _, c = _gru_gates(xproj[:, t], h, w, matmul)
        h_new = u * h + (1.0 - u) * c
        m = mask[:, t, None].float()
        h = m * h_new + (1.0 - m) * h
        hs.append(h.to(xproj.dtype))
    return torch.stack(hs, 1)


def gru_grad_ref(xproj, w, h0, mask, hs, dhs):
    """Plain GRU backward (``_gru_bwd_kernel``): (dxproj [B, T, 3H],
    dw [H, 3H], dh0 [B, H])."""
    B, T, H3 = xproj.shape
    H = H3 // 3
    dev = xproj.device
    dh = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dw = torch.zeros(H, H3, dtype=torch.float32, device=dev)
    wd = w.float()
    w_uz, w_c = wd[:, :2 * H], wd[:, 2 * H:]
    dxs = [None] * T
    for t in reversed(range(T)):
        h_prev = (h0 if t == 0 else hs[:, t - 1]).float()
        u, r, c = _gru_gates(xproj[:, t], h_prev, w)
        m = mask[:, t, None].float()
        dh_total = dhs[:, t].float() + dh
        din = m * dh_total
        du = din * (h_prev - c)
        dh_prev = din * u + (1.0 - m) * dh_total
        db = din * (1.0 - u) * (1.0 - c * c)
        drh = torch.matmul(db, w_c.t())
        dr = drh * h_prev
        dh_prev = dh_prev + drh * r
        da = torch.cat([du * u * (1.0 - u), dr * r * (1.0 - r)], dim=-1)
        dh = dh_prev + torch.matmul(da, w_uz.t())
        dxs[t] = torch.cat([da, db], dim=-1).to(xproj.dtype)
        dw = dw + torch.cat([torch.matmul(h_prev.t(), da),
                             torch.matmul((r * h_prev).t(), db)], dim=-1)
    return torch.stack(dxs, 1), dw.to(w.dtype), dh.to(xproj.dtype)


def gru_grad_phases(xproj, w, h0, mask, hs, dhs, rows: int = 32,
                    splits: int = 2, matmul=torch.matmul):
    """:func:`gru_grad_ref`'s function in K8b's three launches, for the
    tests (the card path never calls it): (A) the gates of every (row,
    step) from two products over the B*T rows, h_prev . w_uz (u, r) and
    (r ⊙ h_prev) . w_c (c); (B) the reverse recurrence per batch group of
    ``rows`` rows, drh = db . w_c^T then dh_prev = da . w_uz^T + the
    pass-through parts, with no product for a group whose rows are all
    masked at a step; (C) dw = [Hprev^T . da | RH^T . db] as one product
    over the B*T rows, in ``splits`` K-wise parts summed in order.
    ``matmul`` is every product (``kernels/_tf32.py: matmul_tf32x3``
    models the kernel's split TF32)."""
    B, T, H3 = xproj.shape
    H = H3 // 3
    f = lambda x: x.float()  # noqa: E731
    wd = f(w)
    hprev = torch.cat([f(h0)[:, None], f(hs)[:, :-1]], 1).reshape(B * T, H)
    x = f(xproj).reshape(B * T, H3)
    uz = torch.sigmoid(matmul(hprev, wd[:, :2 * H]) + x[:, :2 * H])
    rh = uz[:, H:] * hprev
    c = torch.tanh(matmul(rh, wd[:, 2 * H:]) + x[:, 2 * H:])
    gates = torch.cat([uz, c], -1).reshape(B, T, H3)
    hp_all = hprev.reshape(B, T, H)
    dx = torch.zeros(B, T, H3, dtype=torch.float32, device=xproj.device)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=xproj.device)
    wc_t, wuz_t = wd[:, 2 * H:].t(), wd[:, :2 * H].t()
    for b0 in range(0, B, rows):
        g = slice(b0, min(B, b0 + rows))
        dh = torch.zeros_like(dh0[g])
        for t in reversed(range(T)):
            u, r, cc = gates[g, t].split(H, -1)
            hp = hp_all[g, t]
            m = f(mask[g, t, None])
            dh_total = f(dhs[g, t]) + dh
            din = m * dh_total
            du = din * (hp - cc)
            pass_ = din * u + (1.0 - m) * dh_total
            db = din * (1.0 - u) * (1.0 - cc * cc)
            if not bool((m != 0).any()):
                dh = dh_total
                continue
            drh = matmul(db, wc_t)
            pass_ = pass_ + drh * r
            da = torch.cat([du * u * (1.0 - u), drh * hp * r * (1.0 - r)], -1)
            live = m != 0
            dx[g, t] = torch.where(live, torch.cat([da, db], -1),
                                   torch.zeros_like(dx[g, t]))
            dh = torch.where(live, matmul(dx[g, t][:, :2 * H], wuz_t) + pass_,
                             dh_total)
        dh0[g] = dh
    k = B * T
    edges = [k * s // splits for s in range(splits + 1)]
    dxf = dx.reshape(k, H3)
    rh = rh.reshape(k, H)
    dw = None
    for s in range(splits):
        e = slice(edges[s], edges[s + 1])
        part = torch.cat([matmul(hprev[e].t(), dxf[e, :2 * H]),
                          matmul(rh[e].t(), dxf[e, 2 * H:])], -1)
        dw = part if dw is None else dw + part
    return dx.to(xproj.dtype), dw.to(w.dtype), dh0.to(xproj.dtype)


def gru_fused(xproj, w, h0, mask):
    """Whole-sequence GRU forward (module doc): hs [B, T, H].

    CPU tensors take :func:`gru_ref`; CUDA tensors launch K8a on the
    current stream, or raise."""
    if xproj.device.type == "cpu":
        return gru_ref(xproj, w, h0, mask)
    if xproj.device.type != "cuda":
        raise ValueError(f"gru_fused: unsupported device {xproj.device}")
    _check("gru", 3, xproj, w, mask, {"h0": h0})
    B, T, H3 = xproj.shape
    H = H3 // 3
    hs = torch.empty(B, T, H, dtype=torch.float32, device=xproj.device)
    # r ⊙ h_{t-1} of the step's live rows, for the candidate's product
    rh = torch.empty(B, H, dtype=torch.float32, device=xproj.device)
    words = getattr(_build.load(_GRU_FWD), "gru_fwd_sync_words")
    words.argtypes = [_INT, _INT]
    words.restype = _INT
    # the batch groups' barriers (zeroed by gru_fwd)
    barrier = torch.empty(words(B, H), dtype=torch.int32,
                          device=xproj.device)
    fn = _kernel_fn(_GRU_FWD, _GRU_FWD_ARGS)
    stream = _build.current_stream(xproj)
    err = fn(xproj.data_ptr(), w.data_ptr(), h0.data_ptr(), mask.data_ptr(),
             hs.data_ptr(), rh.data_ptr(), barrier.data_ptr(), B, T, H,
             xproj.device.index, stream)
    if err != 0:
        _raise_launch(_GRU_FWD, err, B, H)
    gru_fused.launches += 1
    return hs


def gru_fused_grad(xproj, w, h0, mask, hs, dhs):
    """Backward of :func:`gru_fused` from the saved hs and the cotangent
    dhs [B, T, H]: (dxproj, dw, dh0).

    CPU tensors take :func:`gru_grad_ref`; CUDA tensors launch K8b on the
    current stream, or raise."""
    if xproj.device.type == "cpu":
        return gru_grad_ref(xproj, w, h0, mask, hs, dhs)
    if xproj.device.type != "cuda":
        raise ValueError(f"gru_fused_grad: unsupported device "
                         f"{xproj.device}")
    _check("gru", 3, xproj, w, mask, {"h0": h0}, hs=hs, dhs=dhs)
    B, T, H3 = xproj.shape
    H = H3 // 3
    dxproj = torch.empty_like(xproj)
    dw = torch.empty_like(w)
    dh0 = torch.empty_like(h0)
    # r ⊙ h_{t-1} of every (row, step), recomputed by the gates' launch
    rh = torch.empty(B, T, H, dtype=torch.float32, device=xproj.device)
    words = getattr(_build.load(_GRU_BWD), "gru_bwd_sync_words")
    words.argtypes = [_INT, _INT]
    words.restype = _INT
    # the gates' grid barrier, the recurrence's group barriers and dw's
    # split flags (zeroed by gru_bwd); the gates of every step live in
    # dxproj's own buffer
    barrier = torch.empty(words(B, H), dtype=torch.int32,
                          device=xproj.device)
    fn = _kernel_fn(_GRU_BWD, _GRU_BWD_ARGS)
    stream = _build.current_stream(xproj)
    err = fn(xproj.data_ptr(), w.data_ptr(), h0.data_ptr(), mask.data_ptr(),
             hs.data_ptr(), dhs.data_ptr(), dxproj.data_ptr(), dw.data_ptr(),
             dh0.data_ptr(), rh.data_ptr(), barrier.data_ptr(), B, T, H,
             xproj.device.index, stream)
    if err != 0:
        _raise_launch(_GRU_BWD, err, B, H)
    gru_fused_grad.launches += 1
    return dxproj, dw, dh0


gru_fused.launches = 0
gru_fused_grad.launches = 0

__all__ = ["gru_eligible", "gru_fused",
           "gru_fused_grad", "gru_grad_phases", "gru_grad_ref", "gru_ref", "kernel_capacity",
           "lstm_eligible", "lstm_fused", "lstm_fused_grad", "lstm_grad_phases",
           "lstm_grad_ref",
           "lstm_ref"]
