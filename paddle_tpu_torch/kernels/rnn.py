"""Fused LSTM: the whole-sequence forward and backward of the ``lstm`` op.

The port of the LSTM half of ``paddle_tpu/kernels/rnn.py``
(``_lstm_fwd_kernel``/``lstm_fused`` and ``_lstm_bwd_kernel``/
``lstm_fused_grad``).  Everything is batch-major: xproj [B, T, 4H]
(x·Wx + b, gates in the order i, f, g, o), the recurrent weight w
[H, 4H], the initial state h0/c0 [B, H], the length mask [B, T] (1.0 =
a live step), and the states hs/cs [B, T, H].

- :func:`lstm_ref` and :func:`lstm_grad_ref` are the plain PyTorch
  versions: time loops with the exact math of the reference kernels.
  h and c are carried in float32; a masked step passes h and c through
  unchanged; the backward recomputes the gates from hs[t-1] (h0 at
  t = 0) and folds (1 - m) into the carries, so gradients flow straight
  through masked steps.  They are what the CPU runs and what the
  kernels are held against on the card.
- :func:`lstm_fused` and :func:`lstm_fused_grad` take the plain versions
  for CPU tensors and launch the hand-written CUDA kernels
  ``csrc/lstm_fwd.cu`` (K6) and ``csrc/lstm_bwd.cu`` (K7) for CUDA
  tensors.  There is no fallback: a CUDA tensor goes to the kernel, and
  a shape the kernel cannot hold, a build failure or a launch failure
  raises.  Each launch adds one to the wrapper's ``launches``.

The reference's ``lstm_supported`` gate (H % 128, B % 8) follows TPU
tiles and is not carried over: the kernels take any B, T, H >= 1 whose
grid can be resident on the card at once, and raise ``ValueError``
naming the limit otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_FWD, _BWD = "lstm_fwd", "lstm_bwd"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FWD_ARGS = [_PTR] * 8 + [_INT] * 4 + [_PTR]
_BWD_ARGS = [_PTR] * 14 + [_INT] * 4 + [_PTR]
# codes the C entry points return besides a cudaError_t
_SMEM_OVER, _NOT_RESIDENT = -1, -2


def _gates(x_t, h, w):
    """[B, 4H] pre-activations -> post-activation (i, f, g, o), float32."""
    H = h.shape[-1]
    pre = x_t.float() + torch.matmul(h.to(w.dtype), w).float()
    return (torch.sigmoid(pre[:, :H]), torch.sigmoid(pre[:, H:2 * H]),
            torch.tanh(pre[:, 2 * H:3 * H]), torch.sigmoid(pre[:, 3 * H:]))


def lstm_ref(xproj, w, h0, c0, mask):
    """Plain LSTM forward (``_lstm_fwd_kernel``): (hs, cs) [B, T, H]."""
    T = xproj.shape[1]
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(T):
        i, f, g, o = _gates(xproj[:, t], h, w)
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
        raise ValueError(
            f"{lib} kernel: H={H} needs {-(-H // 4)} blocks resident at "
            f"once (4 hidden units each, {_smem_bytes(lib, B, H)} bytes "
            "of shared memory a block), more than the card holds")
    fn = getattr(_build.load(lib), f"{lib}_error_string")
    fn.argtypes = [_INT]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{lib} launch failed: {fn(err).decode()} "
                       f"(cudaError {err})")


def _check(xproj, w, h0, c0, mask, **extra) -> None:
    """What the kernels take; anything else raises (no fallback)."""
    tensors = {"xproj": xproj, "w": w, "h0": h0, "c0": c0, "mask": mask,
               **extra}
    for name, t in tensors.items():
        if t.device != xproj.device:
            raise ValueError(f"{name} is on {t.device}, xproj on "
                             f"{xproj.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"lstm kernel: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm kernel: {name} must be contiguous")
    if xproj.dim() != 3 or xproj.shape[2] % 4:
        raise ValueError(f"xproj must be [B, T, 4H], got "
                         f"{tuple(xproj.shape)}")
    B, T, H4 = xproj.shape
    H = H4 // 4
    if B < 1 or T < 1 or H < 1:
        raise ValueError(f"empty lstm input {tuple(xproj.shape)}")
    want = {"w": (H, H4), "h0": (B, H), "c0": (B, H), "mask": (B, T)}
    want.update({n: (B, T, H) for n in extra})
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"lstm kernel: {name} must be {list(shape)}, "
                             f"got {list(tensors[name].shape)}")


def lstm_fused(xproj, w, h0, c0, mask):
    """Whole-sequence LSTM forward (module doc): (hs, cs) [B, T, H].

    CPU tensors take :func:`lstm_ref`; CUDA tensors launch K6 on the
    current stream, or raise."""
    if xproj.device.type == "cpu":
        return lstm_ref(xproj, w, h0, c0, mask)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_fused: unsupported device {xproj.device}")
    _check(xproj, w, h0, c0, mask)
    B, T, H4 = xproj.shape
    H = H4 // 4
    hs = torch.empty(B, T, H, dtype=torch.float32, device=xproj.device)
    cs = torch.empty_like(hs)
    barrier = torch.empty(1, dtype=torch.int32, device=xproj.device)
    fn = _kernel_fn(_FWD, _FWD_ARGS)
    stream = torch.cuda.current_stream(xproj.device).cuda_stream
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
    _check(xproj, w, h0, c0, mask, hs=hs, cs=cs, dhs=dhs, dcs=dcs)
    B, T, H4 = xproj.shape
    H = H4 // 4
    dxproj = torch.empty_like(xproj)
    dw = torch.empty_like(w)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    barrier = torch.empty(1, dtype=torch.int32, device=xproj.device)
    fn = _kernel_fn(_BWD, _BWD_ARGS)
    stream = torch.cuda.current_stream(xproj.device).cuda_stream
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

__all__ = ["lstm_fused", "lstm_fused_grad", "lstm_grad_ref", "lstm_ref"]
