"""Paged decode attention: the decode plane's hot op.

The port of ``decode_attention`` and ``paged_attention_xla`` from
``paddle_tpu/kernels/attention.py``.  One query token per decode slot
attends over that slot's K/V, which live in fixed-size cache blocks
found through the slot's row of ``block_tables``.

- :func:`paged_attention_ref` is the plain PyTorch version: gather the
  slot's blocks, dequantize them when the cache is int8, masked softmax.
  It is what the CPU runs and what the kernel is held against on the
  card.
- :func:`decode_attention` takes the plain version for CPU tensors and
  launches the hand-written CUDA kernel ``csrc/paged_decode_attn.cu``
  for CUDA tensors.  There is no fallback: a CUDA tensor goes to the
  kernel, and a build or launch failure raises.  Each call adds one
  to ``decode_attention.launches``, also where a long table is cut into
  context splits (:func:`decode_splits`) and a second launch merges
  them.

Flash attention (``flash_attention``, ``_pallas_fwd``/``_pallas_bwd``
and ``mha_xla`` in the reference) is the training path's hot op:

- :func:`flash_attention_ref` and :func:`flash_attention_bwd_ref` are
  the plain PyTorch versions of the forward (out and the base-2 LSE)
  and the backward (dq, dk, dv).  They compute over the reference's
  padded frame, so the dropout bits and the rows whose keys are all
  masked match ``_pallas_fwd``/``_pallas_bwd``.  On bfloat16 inputs
  they round to bfloat16 where the reference's kernels do (the
  pre-scaled q, p tile by tile against the running max, the ones-lane
  mass, ds, p * drop); out, dq, dk, dv are bfloat16, the LSE float32.
- :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq` and
  :func:`flash_attention_bwd_dkv` take those plain versions for CPU
  tensors and launch CUDA kernels for CUDA tensors, or raise: float32
  q, k, v go to ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``,
  bfloat16 ones to ``csrc/flash_attn_fwd_bf16.cu`` and
  ``csrc/flash_attn_bwd_bf16.cu``; each launch, of either dtype, adds
  one to the wrapper's ``launches``.
- :func:`flash_attention` is one ``torch.autograd.Function`` over the
  three: the forward saves (q, k, v, mask, seed, out, lse), so the
  backward launches only the two backward kernels.  ``delta = rowsum(dO
  * O)`` comes from K2 (``flash_attention_bwd_dq(delta=None, out=out)``):
  the bfloat16 kernel computes it for its own rows and hands it to K3;
  for float32 (and on the CPU) the wrapper takes it by a float32 torch
  reduction, :func:`flash_attention_delta`.
- :func:`mha_ref` is the port of ``mha_xla`` (the plain softmax chain
  with the ``_hash_dropout`` bits), the op's ``impl="xla"``.

Ring attention (``ring_attention``/``_ring_flash``, K11 of the
reference, ``paddle_tpu/kernels/attention.py:694-935``) runs K1–K3 over
the shard pairs of a sequence cut across a list of devices, one launch
a hop on each distinct device: :func:`ring_hops` lays out the hops'
pair tables, and the ring entries of the three kernels
(:func:`flash_attention_fwd_ring`, :func:`flash_attention_bwd_dq_ring`,
:func:`flash_attention_bwd_dkv_ring`) run every pair of a table on the
whole tensors, a shard being a row offset, with the log2-mass merge and
the float32 gradient sums in their epilogues (each pair's output and
gradients rounded to q's dtype first, as the reference's pairs are).
:func:`ring_attention_ref` is the plain ring: the pair-by-pair walk over
the plain pair functions with the merges and sums in torch ops, as the
reference composes its Pallas launchers with ``jnp``.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from ._hash import C3, C4, C5, COL_MUL, M32, ROW_MUL, dropout_multiplier, \
    mul32, u32

NEG_INF = -1e30
# int8 KV dequant factor: quantized cache blocks store
# round(x / s * 127) codes (the kernels/quant.py convention), so
# x ~= code * s / 127
_INV_QMAX = 1.0 / 127.0

_KERNEL = "paged_decode_attn"
# head_dim ceiling of the kernel (32 lanes x 8 registers)
MAX_HEAD_DIM = 256


def paged_attention_ref(q, k_cache, v_cache, block_tables, context_lens,
                        sm_scale=None, k_scale=None, v_scale=None):
    """Plain PyTorch paged decode attention.

    q: [S, H, D]; k_cache/v_cache: [N_blocks, bs, H, D] (one layer);
    block_tables: [S, MB] int; context_lens: [S] int → [S, H, D].
    With ``k_scale``/``v_scale`` ([N_blocks, H] f32, the int8 cache's
    scale pools) the gathered codes are dequantized ``code * s/127``
    before the softmax.  Positions ≥ context_len score ``NEG_INF``."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    S, H, D = q.shape
    bs = k_cache.shape[1]
    MB = block_tables.shape[1]
    bt = block_tables.long()
    k = k_cache[bt]                              # [S, MB, bs, H, D]
    v = v_cache[bt]
    if k_scale is not None:
        k = k.float() * (k_scale[bt][:, :, None, :, None] * _INV_QMAX)
        v = v.float() * (v_scale[bt][:, :, None, :, None] * _INV_QMAX)
    k = k.reshape(S, MB * bs, H, D)
    v = v.reshape(S, MB * bs, H, D)
    s = torch.einsum("shd,sthd->sht", q.float(), k.float()) * sm_scale
    pos = torch.arange(MB * bs, device=q.device)
    s = s.masked_fill(pos[None, None, :] >= context_lens[:, None, None],
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("sht,sthd->shd", p, v.float()).to(q.dtype)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# paged_decode_attn_split: q, k/v caches, k/v scales, tables, lengths,
# out, partials; S, H, D, bs, MB, quantized; sm_scale; splits, device;
# stream
_SPLIT_ARGS = [_PTR] * 9 + [_INT] * 6 + [ctypes.c_float] + [_INT] * 2 + [_PTR]


def _kernel_fn():
    fn = _build.load(_KERNEL).paged_decode_attn_split
    if fn.argtypes is None:
        fn.argtypes = _SPLIT_ARGS
        fn.restype = ctypes.c_int
    return fn


_splits = {}


def decode_splits(S: int, H: int, D: int, bs: int, MB: int,
                  quantized: bool, device) -> int:
    """Context splits the kernel takes at this shape on the CUDA
    ``device`` (``paged_decode_attn_splits``): 1 for a table whose K rows
    of a head take at most 64 KB (256 positions of float32 at D=64, 1,024
    of int8), else two blocks an SM, each split at least 64 KB of K.
    Cached per shape."""
    key = (S, H, D, bs, MB, bool(quantized), device.index)
    n = _splits.get(key)
    if n is None:
        fn = _build.load(_KERNEL).paged_decode_attn_splits
        fn.argtypes = [_INT] * 7
        fn.restype = _INT
        n = _splits[key] = fn(S, H, D, bs, MB, int(quantized), device.index)
    return n


def _error_string(code: int) -> str:
    fn = _build.load(_KERNEL).paged_decode_attn_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def _check_inputs(q, k_cache, v_cache, block_tables, context_lens,
                  k_scale, v_scale) -> None:
    """What the kernel takes; anything else raises (no fallback)."""
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "context_lens": context_lens}
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention kernel: {name} must be "
                             "contiguous")
    want_cache = torch.int8 if quantized else torch.float32
    if q.dtype != torch.float32:
        raise TypeError(f"decode_attention kernel: q must be float32, "
                        f"got {q.dtype}")
    if k_cache.dtype != want_cache or v_cache.dtype != want_cache:
        raise TypeError(
            f"decode_attention kernel: caches must be {want_cache} "
            f"{'(with scales)' if quantized else '(no scales)'}, got "
            f"{k_cache.dtype}/{v_cache.dtype}")
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise TypeError("decode_attention kernel: scales must be float32")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("decode_attention kernel: block_tables and "
                        "context_lens must be int32")
    S, H, D = q.shape
    N, bs = k_cache.shape[:2]
    if k_cache.shape != (N, bs, H, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if quantized and (k_scale.shape != (N, H) or v_scale.shape != (N, H)):
        raise ValueError(f"scale pools must be [{N}, {H}]")
    if block_tables.dim() != 2 or block_tables.shape[0] != S or \
            context_lens.shape != (S,):
        raise ValueError("block_tables must be [S, MB] and context_lens "
                         "[S]")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")


def decode_attention(q, k_cache, v_cache, block_tables, context_lens,
                     sm_scale=None, k_scale=None, v_scale=None):
    """Paged decode attention (module doc).

    q: [S, H, D] f32; k_cache/v_cache: [N_blocks, block_tokens, H, D]
    for ONE layer, f32 or int8; block_tables: [S, MB] int32 block ids per
    slot; context_lens: [S] int32 valid tokens per slot (positions ≥
    context_len masked); ``k_scale``/``v_scale``: [N_blocks, H] f32
    per-block-per-head abs-max pools of an int8 cache.  Returns
    [S, H, D].

    CPU tensors take :func:`paged_attention_ref`; CUDA tensors launch
    the kernel on the current stream, or raise."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_cache, v_cache, block_tables,
                                   context_lens, sm_scale,
                                   k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_inputs(q, k_cache, v_cache, block_tables, context_lens,
                  k_scale, v_scale)
    S, H, D = q.shape
    bs, MB = k_cache.shape[1], block_tables.shape[1]
    quantized = k_scale is not None
    out = torch.empty_like(q)
    splits = decode_splits(S, H, D, bs, MB, quantized, q.device)
    # each split's unnormalized acc [S, H, D], then its m and l [S, H]
    part = (torch.empty(splits * S * H * (D + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    stream = _build.current_stream(q)
    err = _kernel_fn()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, S, H, D, bs, MB,
        int(quantized), float(sm_scale), splits, q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attn launch failed: "
                           f"{_error_string(err)} (cudaError {err})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634  # the kernels run softmax in exp2 units
FLASH_MAX_HEAD_DIM = 128     # 4 lanes x 32 registers per row


def resolve_blocks(Tq: int, Tk: int) -> Tuple[int, int]:
    """The reference's logical tile sizes (``_resolve_blocks`` with its
    defaults): they fix which tiles a causal row visits and key the
    dropout bits, whatever tiling a kernel computes on."""
    bq = 1024 if Tq >= 1024 else (512 if Tq >= 512 else 128)
    bk = 1024 if Tk >= 1024 else (512 if Tk >= 512 else 128)
    return bq, bk


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _scale_log2(sm_scale: float) -> float:
    """float32(sm_scale * log2 e): the q pre-scale of every kernel."""
    return float(torch.tensor(sm_scale * LOG2E, dtype=torch.float32))


def _visits(Tq: int, Tk: int, causal: bool, device):
    """(key_end [Tq], row_begin [Tk]): the forward and dq visit keys
    [0, key_end[row]); dk/dv visit rows [row_begin[key], Tq).  Both
    follow the reference's logical tiles (its causal tile skipping and
    the clamped ``_first_qb``)."""
    bq, bk = resolve_blocks(Tq, Tk)
    nqb, nkb = -(-Tq // bq), -(-Tk // bk)
    rows = torch.arange(Tq, device=device)
    keys = torch.arange(Tk, device=device)
    if not causal:
        return (torch.full((Tq,), nkb * bk, device=device),
                torch.zeros(Tk, dtype=torch.long, device=device))
    last = torch.clamp(((rows // bq + 1) * bq - 1) // bk, max=nkb - 1)
    first = torch.clamp((keys // bk) * bk // bq, max=nqb - 1)
    return (last + 1) * bk, first * bq


def _bf16(x):
    """x rounded to bfloat16, back in float32."""
    return x.to(torch.bfloat16).float()


def _padded_scores(q, k, kv_mask, causal: bool, sm_scale: float,
                   matmul=None):
    """Scores in exp2 units over the reference's padded key frame
    [B, H, Tq, Tk_p]: masked keys, padding keys and causal positions
    score the finite NEG_INF.  ``matmul`` (default an exact float32
    einsum) takes the product.  A bfloat16 q is pre-scaled in float32
    and rounded back to bfloat16 before the product (``_scaled_q``)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    _, bk = resolve_blocks(Tq, Tk)
    Tk_p = _round_up(Tk, bk)
    qs = q.float() * _scale_log2(sm_scale)
    if q.dtype == torch.bfloat16:
        qs = _bf16(qs)
    s = (torch.einsum("bhqd,bhkd->bhqk", qs, k.float()) if matmul is None
         else matmul(qs, k.float().transpose(-1, -2)))
    s = torch.nn.functional.pad(s, (0, Tk_p - Tk), value=NEG_INF)
    valid = torch.zeros(B, Tk_p, dtype=torch.bool, device=q.device)
    valid[:, :Tk] = True if kv_mask is None else kv_mask > 0
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    if causal:
        kpos = torch.arange(Tk_p, device=q.device)
        qpos = torch.arange(Tq, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    return s


def tile_dropout_ref(seed, B: int, H: int, Tq: int, Tk: int, rate: float,
                     device) -> torch.Tensor:
    """The reference's ``_tile_dropout`` bits for every (row, key) of
    the padded frame: [B, H, Tq, Tk_p] float32 multipliers, hashed from
    (seed, batch*head, q-tile, k-tile, row and column in the tile)."""
    bq, bk = resolve_blocks(Tq, Tk)
    Tk_p = _round_up(Tk, bk)
    rows = torch.arange(Tq, dtype=torch.int64, device=device)
    cols = torch.arange(Tk_p, dtype=torch.int64, device=device)
    bh = torch.arange(B * H, dtype=torch.int64,
                      device=device).reshape(B, H, 1, 1)
    x = mul32(rows % bq, ROW_MUL)[:, None] ^ mul32(cols % bk, COL_MUL)[None]
    s = (torch.zeros((), dtype=torch.int64, device=device) if seed is None
         else u32(seed.reshape(-1)[0]))
    salt = (s + mul32(bh, C3) + mul32(rows // bq, C4)[:, None]
            + mul32(cols // bk, C5)[None]) & M32
    return dropout_multiplier(x ^ salt, rate)


def flash_attention_ref(q, k, v, kv_mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0, seed=None, matmul=None):
    """Plain flash-attention forward: (out [B, H, Tq, D], lse [B*H, Tq]
    base 2, +1e30 where the softmax mass is 0), as ``_pallas_fwd``.
    ``matmul`` takes both products (default exact float32 einsums; the
    tests pass ``kernels/_tf32.py: matmul_tf32x3``, K1's arithmetic).
    bfloat16 inputs take :func:`_flash_fwd_bf16`."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(D))
    s = _padded_scores(q, k, kv_mask, causal, sm_scale, matmul)
    if q.dtype == torch.bfloat16:
        return _flash_fwd_bf16(s, v, causal, dropout_rate, seed)
    key_end, _ = _visits(Tq, Tk, causal, q.device)
    visit = torch.arange(s.shape[-1], device=q.device)[None] < key_end[:, None]
    m = s.masked_fill(~visit, -math.inf).amax(dim=-1, keepdim=True)
    p = torch.where(visit, torch.exp2(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    if dropout_rate > 0.0:
        p = p * tile_dropout_ref(seed, B, H, Tq, Tk, dropout_rate, q.device)
    out = (torch.einsum("bhqk,bhkd->bhqd", p[..., :Tk], v.float())
           if matmul is None else matmul(p[..., :Tk], v.float()))
    out = out / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log2(torch.clamp(l, min=1e-30)),
                      torch.full((), 1e30, device=q.device))
    return out.to(q.dtype), lse.reshape(B * H, Tq)


def _flash_fwd_bf16(s, v, causal: bool, dropout_rate: float, seed):
    """The forward on bfloat16 inputs from its scores ``s``, rounding
    where ``_flash_fwd_kernel`` rounds: the online softmax walks the
    reference's logical k-tiles, and each tile's p (against the running
    max, times the dropout multiplier in float32) is rounded to
    bfloat16 before P . V.  The softmax mass l sums the unrounded p, or
    the rounded p where the reference carries it in V's ones lane (D <
    128 and no dropout, ``_lane_pack_ok``).  out is bfloat16, the LSE
    float32."""
    B, H, Tq, Tk_p = s.shape
    Tk, D = v.shape[2], v.shape[3]
    _, bk = resolve_blocks(Tq, Tk)
    key_end, _ = _visits(Tq, Tk, causal, s.device)
    drop = (tile_dropout_ref(seed, B, H, Tq, Tk, dropout_rate, s.device)
            if dropout_rate > 0.0 else None)
    ones_lane = D < 128 and drop is None
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, Tk_p - Tk))
    m = torch.full((B, H, Tq, 1), NEG_INF, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, Tq, D, device=s.device)
    for k0 in range(0, Tk_p, bk):
        vis = (k0 < key_end)[:, None]
        st = s[..., k0:k0 + bk]
        m_new = torch.where(vis, torch.maximum(m, st.amax(-1, keepdim=True)),
                            m)
        p = torch.exp2(st - m_new)
        alpha = torch.exp2(m - m_new)
        pb = _bf16(p if drop is None else p * drop[..., k0:k0 + bk])
        mass = (pb if ones_lane else p).sum(-1, keepdim=True)
        l = torch.where(vis, l * alpha + mass, l)
        acc = torch.where(vis, acc * alpha + pb @ vf[..., k0:k0 + bk, :],
                          acc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log2(torch.clamp(l, min=1e-30)),
                      torch.full((), 1e30, device=s.device))
    return out.to(torch.bfloat16), lse.reshape(B * H, Tq)


def flash_attention_delta(out, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, [B*H, Tq] (computed outside the
    backward kernels, as the reference does)."""
    B, H, Tq, _ = out.shape
    return (do.float() * out.float()).sum(dim=-1).reshape(B * H, Tq)


def _bwd_ref(q, k, v, kv_mask, lse, delta, do, causal, sm_scale,
             dropout_rate, seed, want_dq: bool, want_dkv: bool,
             matmul=None):
    """The plain backward; ``matmul`` takes its five products (default
    exact float32 einsums; the tests pass ``kernels/_tf32.py:
    matmul_tf32x3``, K2's and K3's arithmetic).  On bfloat16 inputs it
    rounds where ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``
    do: the pre-scaled q (:func:`_padded_scores`), ds before ds . K and
    ds^T . q, and p * drop before its product with dO; lse and delta
    stay float32."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if matmul is None:
        def matmul(a, b):
            return torch.einsum("bhij,bhjk->bhik", a, b)
    s = _padded_scores(q, k, kv_mask, causal, sm_scale, matmul)[..., :Tk]
    p = torch.exp2(s - lse.reshape(B, H, Tq, 1))
    dp = matmul(do.float(), v.float().transpose(-1, -2))
    drop = None
    if dropout_rate > 0.0:
        drop = tile_dropout_ref(seed, B, H, Tq, Tk, dropout_rate,
                                q.device)[..., :Tk]
        dp = dp * drop
    ds = p * (dp - delta.reshape(B, H, Tq, 1))
    rnd = _bf16 if q.dtype == torch.bfloat16 else (lambda x: x)
    ds = rnd(ds)
    key_end, row_begin = _visits(Tq, Tk, causal, q.device)
    zero = torch.zeros((), device=q.device)
    dq = dk = dv = None
    if want_dq:
        vis = torch.arange(Tk, device=q.device)[None] < key_end[:, None]
        dq = matmul(torch.where(vis, ds, zero), k.float()) * sm_scale
        dq = dq.to(q.dtype)
    if want_dkv:
        vis = torch.arange(Tq, device=q.device)[:, None] >= row_begin[None]
        pd = rnd(p if drop is None else p * drop)
        dv = matmul(torch.where(vis, pd, zero).transpose(-1, -2),
                    do.float()).to(v.dtype)
        dk = matmul(torch.where(vis, ds, zero).transpose(-1, -2),
                    q.float()) * sm_scale
        dk = dk.to(k.dtype)
    return dq, dk, dv


def flash_attention_bwd_ref(q, k, v, kv_mask, out, lse, do,
                            causal: bool = False,
                            sm_scale: Optional[float] = None,
                            dropout_rate: float = 0.0, seed=None,
                            delta=None, matmul=None):
    """Plain flash-attention backward: (dq, dk, dv), as ``_pallas_bwd``.
    ``lse`` is the forward's [B*H, Tq]; ``delta`` ([B*H, Tq]) defaults to
    rowsum(dO * O); ``matmul`` as in :func:`_bwd_ref`."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    if delta is None:
        delta = flash_attention_delta(out, do)
    return _bwd_ref(q, k, v, kv_mask, lse, delta, do, causal, sm_scale,
                    dropout_rate, seed, True, True, matmul)


# the kernels' libraries and entry points by q's dtype: float32 (split
# TF32 products) and bfloat16 (bf16 products, f32 sums)
_FLASH_LIBS = {
    torch.float32: dict(fwd=("flash_attn_fwd", "flash_attn_fwd"),
                        dq=("flash_attn_bwd", "flash_attn_bwd_dq"),
                        dkv=("flash_attn_bwd", "flash_attn_bwd_dkv"),
                        fwd_ring=("flash_attn_fwd", "flash_attn_fwd_ring"),
                        dq_ring=("flash_attn_bwd", "flash_attn_bwd_dq_ring"),
                        dkv_ring=("flash_attn_bwd",
                                  "flash_attn_bwd_dkv_ring")),
    torch.bfloat16: dict(fwd=("flash_attn_fwd_bf16", "flash_attn_fwd_bf16"),
                         dq=("flash_attn_bwd_bf16", "flash_attn_bwd_dq_bf16"),
                         dkv=("flash_attn_bwd_bf16",
                              "flash_attn_bwd_dkv_bf16"),
                         fwd_ring=("flash_attn_fwd_bf16",
                                   "flash_attn_fwd_bf16_ring"),
                         dq_ring=("flash_attn_bwd_bf16",
                                  "flash_attn_bwd_dq_bf16_ring"),
                         dkv_ring=("flash_attn_bwd_bf16",
                                   "flash_attn_bwd_dkv_bf16_ring")),
}
_PTR = ctypes.c_void_p
_FWD_ARGS = [_PTR] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + \
    [ctypes.c_int] * 3 + [_PTR]
_DQ_ARGS = [_PTR] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + \
    [ctypes.c_int] * 3 + [_PTR]
# the bfloat16 K2 also takes O and the buffer it writes delta to (both
# null where delta is given)
_DQ_BF16_ARGS = [_PTR] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + \
    [ctypes.c_int] * 3 + [_PTR]
_DKV_ARGS = [_PTR] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + \
    [ctypes.c_int] * 3 + [_PTR]


def _flash_fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _raise_launch(lib: str, name: str, err: int):
    fn = getattr(_build.load(lib), f"{lib}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{name} launch failed: {fn(err).decode()} "
                       f"(cudaError {err})")


def _check_flash(q, k, v, kv_mask, seed, **extra) -> None:
    """What the flash kernels take; anything else raises (no fallback).
    q, k, v (and dO, out, dq, dk, dv) share one dtype, float32 or
    bfloat16; the mask, lse, delta and the ring's accumulators are
    float32, the seed (and the ring's seed grid) int32."""
    if q.dtype not in _FLASH_LIBS:
        raise TypeError(f"flash attention kernel: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    tensors = {"q": q, "k": k, "v": v, **extra}
    if kv_mask is not None:
        tensors["kv_mask"] = kv_mask
    if seed is not None:
        tensors["seed"] = seed
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        want = (torch.int32 if name in ("seed", "seeds") else
                q.dtype if name in ("q", "k", "v", "do", "out", "dq", "dk",
                                    "dv")
                else torch.float32)
        if t.dtype != want:
            raise TypeError(f"flash attention kernel: {name} must be "
                            f"{want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be "
                             "contiguous")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, Tq, D], got {tuple(q.shape)}")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if kv_mask is not None and kv_mask.shape != (B, Tk):
        raise ValueError(f"kv_mask must be [B, Tk] = [{B}, {Tk}], got "
                         f"{tuple(kv_mask.shape)}")
    if seed is not None and seed.numel() != 1:
        raise ValueError("the dropout seed is one int32 value")
    if D > FLASH_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernels' "
                         f"{FLASH_MAX_HEAD_DIM}")
    if Tq == 0 or Tk == 0:
        raise ValueError("empty sequence")


def _common(q, k, causal, sm_scale, dropout_rate):
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    bq, bk = resolve_blocks(Tq, Tk)
    rate = float(dropout_rate or 0.0)
    keep = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    return (B, H, Tq, Tk, D, int(bool(causal)), _scale_log2(sm_scale),
            rate, keep, bq, bk)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_bwd_shapes(q, lse, delta, do, out=None) -> None:
    B, H, Tq, _ = q.shape
    if do.shape != q.shape or (out is not None and out.shape != q.shape) \
            or lse.numel() != B * H * Tq or \
            (delta is not None and delta.numel() != B * H * Tq):
        raise ValueError("do (and out) must match q; lse and delta hold "
                         "B*H*Tq values")


def flash_attention_fwd(q, k, v, kv_mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0, seed=None):
    """Flash-attention forward: (out [B, H, Tq, D], lse [B*H, Tq]).

    q: [B, H, Tq, D], k/v: [B, H, Tk, D] float32 or bfloat16; kv_mask:
    [B, Tk] 1/0 float32 or None; seed: int32 tensor of one value (the
    dropout seed) or None.  out has q's dtype, lse is float32.  CPU
    tensors take :func:`flash_attention_ref`; CUDA tensors launch
    ``flash_attn_fwd`` (float32) or ``flash_attn_fwd_bf16`` on the
    current stream, or raise."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_mask, causal, sm_scale,
                                   dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_flash(q, k, v, kv_mask, seed)
    B, H, Tq, Tk, D, c, sl2, rate, keep, bq, bk = _common(
        q, k, causal, sm_scale, dropout_rate)
    out = torch.empty_like(q)
    lse = torch.empty(B * H, Tq, dtype=torch.float32, device=q.device)
    lib, name = _FLASH_LIBS[q.dtype]["fwd"]
    fn = _flash_fn(lib, name, _FWD_ARGS)
    stream = _build.current_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
             _ptr(seed), out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D, c,
             sl2, rate, keep, bq, bk, q.device.index, stream)
    if err != 0:
        _raise_launch(lib, name, err)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, kv_mask, lse, delta, do,
                           causal: bool = False,
                           sm_scale: Optional[float] = None,
                           dropout_rate: float = 0.0, seed=None, out=None):
    """dq of flash attention from the forward's ``lse`` and ``delta``
    ([B*H, Tq] each).  CPU tensors take the plain version; CUDA tensors
    launch ``flash_attn_bwd_dq`` (float32) or ``flash_attn_bwd_dq_bf16``,
    or raise.

    With ``delta=None`` the forward's output ``out`` is required and the
    call returns ``(dq, delta)``: the bfloat16 kernel computes delta =
    rowsum(dO * O) for its own rows and writes it out for K3; for float32
    and on the CPU it is :func:`flash_attention_delta`."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    want_delta = delta is None
    if want_delta and out is None:
        raise ValueError("flash_attention_bwd_dq: delta=None needs the "
                         "forward's out")
    if q.device.type == "cpu":
        if want_delta:
            delta = flash_attention_delta(out, do)
        dq = _bwd_ref(q, k, v, kv_mask, lse, delta, do, causal, sm_scale,
                      dropout_rate, seed, True, False)[0]
        return (dq, delta) if want_delta else dq
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    bf16 = q.dtype == torch.bfloat16
    if want_delta and not bf16:
        delta = flash_attention_delta(out, do)
    # the bfloat16 kernel reads out in place of delta
    extra = dict(out=out) if delta is None else dict(delta=delta)
    _check_flash(q, k, v, kv_mask, seed, lse=lse, do=do, **extra)
    _check_bwd_shapes(q, lse, delta, do, out if delta is None else None)
    B, H, Tq, Tk, D, c, sl2, rate, keep, bq, bk = _common(
        q, k, causal, sm_scale, dropout_rate)
    dq = torch.empty_like(q)
    lib, name = _FLASH_LIBS[q.dtype]["dq"]
    stream = _build.current_stream(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            _ptr(seed), do.data_ptr(), lse.data_ptr())
    tail = (B, H, Tq, Tk, D, c, sl2, float(sm_scale), rate, keep, bq, bk,
            q.device.index, stream)
    if bf16:
        own = delta is None   # the kernel computes delta from out
        if own:
            delta = torch.empty(B * H, Tq, dtype=torch.float32,
                                device=q.device)
        fn = _flash_fn(lib, name, _DQ_BF16_ARGS)
        err = fn(*args, None if own else delta.data_ptr(),
                 out.data_ptr() if own else None,
                 delta.data_ptr() if own else None, dq.data_ptr(), *tail)
    else:
        fn = _flash_fn(lib, name, _DQ_ARGS)
        err = fn(*args, delta.data_ptr(), dq.data_ptr(), *tail)
    if err != 0:
        _raise_launch(lib, name, err)
    flash_attention_bwd_dq.launches += 1
    return (dq, delta) if want_delta else dq


def flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do,
                            causal: bool = False,
                            sm_scale: Optional[float] = None,
                            dropout_rate: float = 0.0, seed=None):
    """(dk, dv) of flash attention (as :func:`flash_attention_bwd_dq`);
    CUDA tensors launch ``flash_attn_bwd_dkv`` (float32) or
    ``flash_attn_bwd_dkv_bf16``, or raise."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        _, dk, dv = _bwd_ref(q, k, v, kv_mask, lse, delta, do, causal,
                             sm_scale, dropout_rate, seed, False, True)
        return dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_flash(q, k, v, kv_mask, seed, lse=lse, delta=delta, do=do)
    _check_bwd_shapes(q, lse, delta, do)
    B, H, Tq, Tk, D, c, sl2, rate, keep, bq, bk = _common(
        q, k, causal, sm_scale, dropout_rate)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib, name = _FLASH_LIBS[q.dtype]["dkv"]
    fn = _flash_fn(lib, name, _DKV_ARGS)
    # the float32 kernel holds its q tile pre-scaled; the bfloat16 one
    # takes dk from the unscaled q, as the reference does
    dk_scale = (float(sm_scale) / sl2 if q.dtype == torch.float32
                else float(sm_scale))
    stream = _build.current_stream(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
             _ptr(seed), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, D, c, sl2,
             dk_scale, rate, keep, bq, bk, q.device.index, stream)
    if err != 0:
        _raise_launch(lib, name, err)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Forward K1; backward K2 and K3 on the saved (q, k, v, mask, seed,
    out, lse), with no re-run of the forward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, causal, sm_scale,
                dropout_rate):
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal, sm_scale,
                                       dropout_rate, seed)
        ctx.save_for_backward(q, k, v, kv_mask, seed, out, lse)
        ctx.args = (causal, sm_scale, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, seed, out, lse = ctx.saved_tensors
        causal, sm_scale, rate = ctx.args
        do = do.contiguous()
        dq, delta = flash_attention_bwd_dq(q, k, v, kv_mask, lse, None, do,
                                           causal, sm_scale, rate, seed,
                                           out=out)
        dk, dv = flash_attention_bwd_dkv(q, k, v, kv_mask, lse, delta, do,
                                         causal, sm_scale, rate, seed)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed=None):
    """Differentiable flash attention (module doc): q [B, H, Tq, D],
    k/v [B, H, Tk, D], kv_mask [B, Tk] 1/0 or None, dropout_seed an
    int32 tensor of one value (vary it per step) or None."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    return FlashAttentionFn.apply(q, k, v, kv_mask, dropout_seed,
                                  bool(causal), float(sm_scale),
                                  float(dropout_rate or 0.0))


# ---------------------------------------------------------------------------
# ring attention: sequence-parallel over a mesh axis
# ---------------------------------------------------------------------------

RING_PAIR_SALT = (1000003, 7919)  # distinct odd primes per (q, kv) shard


def _pair_seed(seed0, q_idx, kv_idx) -> torch.Tensor:
    """The per-(q-shard, kv-shard) dropout seed of
    ``paddle_tpu/kernels/attention.py:699-707``: ``seed0 + q_idx * a +
    kv_idx * b`` in int32, with its wraparound (computed in int64 and
    wrapped to a signed int32).  ``q_idx``/``kv_idx`` are ints or int
    tensors that broadcast; the result is int32 on ``seed0``'s device."""
    a, b = RING_PAIR_SALT
    dev = seed0.device
    s = (seed0.reshape(()).long()
         + torch.as_tensor(q_idx, device=dev).long() * a
         + torch.as_tensor(kv_idx, device=dev).long() * b)
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).int()


def _mass_lse(lse):
    """The kernels' empty-row sentinel (+1e30) -> the merge's identity
    (-1e30, log2 of zero probability mass)."""
    return lse.masked_fill(lse > 1e29, NEG_INF)


def _kernel_lse(lse):
    """Inverse of :func:`_mass_lse`, for handing the merged LSE back to
    the backward kernels."""
    return lse.masked_fill(lse < -1e29, 1e30)


def _merge_partial(o_a, lse_a, o_p, lse_p):
    """Merge two normalized partial attentions by their log2 masses (the
    flash-decoding combine): out = sum_i o_i * 2^(lse_i - lse_tot)."""
    lse_t = torch.logaddexp2(lse_a, lse_p)
    o_t = o_a * torch.exp2(lse_a - lse_t) + o_p * torch.exp2(lse_p - lse_t)
    return o_t, lse_t


def _shards(x, dim: int, devices) -> list:
    """``x`` cut into ``len(devices)`` contiguous pieces along ``dim``,
    piece i on ``devices[i]`` (None stays None)."""
    if x is None:
        return [None] * len(devices)
    n = x.shape[dim] // len(devices)
    return [x.narrow(dim, i * n, n).to(d, non_blocking=True).contiguous()
            for i, d in enumerate(devices)]


def _hop(xs, devices) -> list:
    """One step round the ring: position i takes position i - 1's value,
    copied to its device (no copy where the devices repeat)."""
    sp = len(devices)
    return [None if xs[i - 1] is None
            else xs[i - 1].to(devices[i], non_blocking=True)
            for i in range(sp)]


def _on(device):
    """Device guard for one shard's work: torch's current device (and
    its current stream) is the shard's while its pair runs, and is
    restored after, whatever device the kernel's launcher selected."""
    device = torch.device(device)
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _gather(xs, dim: int, device):
    return torch.cat([x.to(device, non_blocking=True) for x in xs], dim=dim)


def _seed_grid(seed0, sp: int) -> torch.Tensor:
    """The [sp, sp] pair-seed grid on ``seed0``'s device: (i, j) holds
    q shard i's and kv shard j's :func:`_pair_seed`."""
    idx = torch.arange(sp, device=seed0.device)
    return _pair_seed(seed0, idx[:, None], idx[None]).contiguous()


def _pair_seeds(seed0, devices) -> list:
    """Row i of the [sp, sp] pair-seed grid, on ``devices[i]``."""
    grid = _seed_grid(seed0, len(devices))
    return [row.to(d) for row, d in zip(grid, devices)]


def _ring_check(q, k, devices) -> None:
    sp = len(devices)
    if sp < 1:
        raise ValueError("ring attention needs at least one device")
    if q.shape[2] % sp or k.shape[2] % sp:
        raise ValueError(f"ring attention over {sp} shards: Tq={q.shape[2]}"
                         f" and Tk={k.shape[2]} must be multiples of {sp}")
    if any(torch.device(d).type != q.device.type for d in devices):
        raise ValueError(f"ring devices {devices} are not all of q's "
                         f"device type ({q.device.type})")
    if k.device != q.device:
        raise ValueError(f"k is on {k.device}, q on {q.device}: the ring "
                         f"takes whole tensors on one device")


def _ring_forward(q, k, v, kv_mask, seed, devices, causal, sm_scale, rate,
                  pair_fwd):
    """``_ring_fwd`` (``paddle_tpu/kernels/attention.py:797-849``) with
    ``pair_fwd`` for each (q-shard, kv-shard) pair: (out [B, H, T, D] on
    q's device, merged lse [B, H, T] in log2-mass form)."""
    sp = len(devices)
    B, H, T, _ = q.shape
    S = T // sp
    qs, ks, vs = (_shards(x, 2, devices) for x in (q, k, v))
    ms = _shards(kv_mask, 1, devices)
    seeds = _pair_seeds(seed, devices)

    def pair(i, kc, vc, mc, j, c):
        out, lse = pair_fwd(qs[i], kc, vc, mc, c, sm_scale, rate,
                            seeds[i][j:j + 1])
        return out.float(), _mass_lse(lse.reshape(B, H, S, 1))

    o, lse = [None] * sp, [None] * sp
    for i in range(sp):
        with _on(devices[i]):
            o[i], lse[i] = pair(i, ks[i], vs[i], ms[i], i, causal)
    kc, vc, mc = ks, vs, ms
    for t in range(1, sp):
        kc, vc, mc = (_hop(x, devices) for x in (kc, vc, mc))
        for i in range(sp):
            j = (i - t) % sp
            if causal and j > i:   # above the diagonal: no launch
                continue
            with _on(devices[i]):
                o_p, lse_p = pair(i, kc[i], vc[i], mc[i], j, False)
                o[i], lse[i] = _merge_partial(o[i], lse[i], o_p, lse_p)
    return (_gather(o, 2, q.device).to(q.dtype),
            _gather(lse, 2, q.device)[..., 0])


def _ring_backward(q, k, v, kv_mask, seed, out, lse, do, devices, causal,
                   sm_scale, rate, pair_dq, pair_dkv):
    """``_ring_vjp_bwd`` (``paddle_tpu/kernels/attention.py:858-932``):
    every pair runs ``pair_dq``/``pair_dkv`` with the GLOBAL lse (back in
    kernel form) and delta, so its probabilities are the global softmax's;
    dq accumulates on its shard, dk/dv in float32 travel with their K/V
    shard (the diagonal first, then the hops) and come home after one
    more hop."""
    sp = len(devices)
    B, H, T, _ = q.shape
    S = T // sp
    qs, ks, vs, os_, dos = (_shards(x, 2, devices)
                            for x in (q, k, v, out, do))
    ms = _shards(kv_mask, 1, devices)
    lses = [_kernel_lse(x).reshape(B * H, S)
            for x in _shards(lse, 2, devices)]
    # delta depends only on (do, out): one per q shard, for every pair
    deltas = []
    for d, o_i, do_i in zip(devices, os_, dos):
        with _on(d):
            deltas.append(flash_attention_delta(o_i, do_i))
    seeds = _pair_seeds(seed, devices)

    def pair(i, kc, vc, mc, j, c):
        args = (qs[i], kc, vc, mc, lses[i], deltas[i], dos[i], c, sm_scale,
                rate, seeds[i][j:j + 1])
        dq = pair_dq(*args)
        dk, dv = pair_dkv(*args)
        return dq.float(), dk.float(), dv.float()

    dq, dk, dv = [None] * sp, [None] * sp, [None] * sp
    for i in range(sp):
        with _on(devices[i]):
            dq[i], dk[i], dv[i] = pair(i, ks[i], vs[i], ms[i], i, causal)
    kc, vc, mc = ks, vs, ms
    for t in range(1, sp):
        kc, vc, mc, dk, dv = (_hop(x, devices) for x in (kc, vc, mc, dk, dv))
        for i in range(sp):
            j = (i - t) % sp
            if causal and j > i:
                continue
            with _on(devices[i]):
                dq_p, dk_p, dv_p = pair(i, kc[i], vc[i], mc[i], j, False)
                dk[i], dv[i], dq[i] = (dk[i] + dk_p, dv[i] + dv_p,
                                       dq[i] + dq_p)
    # one more hop brings each shard's dk/dv accumulator home
    dk, dv = _hop(dk, devices), _hop(dv, devices)
    return (_gather(dq, 2, q.device).to(q.dtype),
            _gather(dk, 2, k.device).to(k.dtype),
            _gather(dv, 2, v.device).to(v.dtype))


def _plain_dq(*args):
    return _bwd_ref(*args, True, False)[0]


def _plain_dkv(*args):
    return _bwd_ref(*args, False, True)[1:]


# ---- the hop route: one launch of each kernel a hop on each device -------

# a pair's flags in a hop table (csrc/flash_attn_common.cuh, Ring): the
# causal diagonal, the first hop (the accumulators are written, not
# read), and the last pair of its q shard (K1's out and lse, K2's dq are
# written in their final form) or of its kv shard (K3's dk, dv)
RING_CAUSAL, RING_FIRST, RING_LAST_Q, RING_LAST_KV = 1, 2, 4, 8
RING_MAX_PAIRS = 64     # pairs a launch's table holds (kRingMaxPairs)
RING_MAX_SHARDS = 4096  # a shard index takes 12 bits of a table entry


def ring_hops(devices, causal: bool) -> list:
    """The hop route's launches: for each hop t = 0 .. sp - 1 a list of
    ``(device, pairs)``, one entry for each distinct device (in the order
    they first appear in ``devices``) that holds the q shard of a pair of
    that hop.  ``pairs`` are ``(i, j, flags)`` in the reference's order,
    q shard i ascending: at hop t, q shard i meets kv shard j = (i - t)
    mod sp, and under ``causal`` a pair above the diagonal (j > i) is
    left out.  Pure Python on ``torch.device`` objects: no tensor."""
    devices = [torch.device(d) for d in devices]
    sp = len(devices)
    places = list(dict.fromkeys(devices))
    hops = []
    for t in range(sp):
        by = {d: [] for d in places}
        for i in range(sp):
            j = (i - t) % sp
            if causal and j > i:
                continue
            f = RING_FIRST if t == 0 else 0
            if causal and t == 0:
                f |= RING_CAUSAL
            if t == (i if causal else sp - 1):
                f |= RING_LAST_Q
            if t == (sp - 1 - j if causal else sp - 1):
                f |= RING_LAST_KV
            by[devices[i]].append((i, j, f))
        hops.append([(d, p) for d, p in by.items() if p])
    return hops


def _rows(x, i: int, n: int, dim: int = 2):
    """Shard i's rows of a whole tensor: ``n`` rows along ``dim`` from i*n."""
    return x.narrow(dim, i * n, n)


def _pair_inputs(q, k, v, kv_mask, seeds, i, j, Sq, Sk):
    """Pair (i, j)'s shards as contiguous copies, for the plain entries."""
    return (_rows(q, i, Sq).contiguous(), _rows(k, j, Sk).contiguous(),
            _rows(v, j, Sk).contiguous(),
            None if kv_mask is None else _rows(kv_mask, j, Sk, 1).contiguous(),
            seeds[i, j:j + 1])


def _fwd_ring_plain(q, k, v, kv_mask, seeds, pairs, o_acc, lse_acc, out,
                    sm_scale, rate):
    """The plain K1 ring entry: each pair of the table through
    :func:`flash_attention_ref`, its output widened to float32 and merged
    into shard i's accumulators by :func:`_merge_partial`."""
    B, H, Tq, _ = q.shape
    sp = seeds.shape[0]
    Sq, Sk = Tq // sp, k.shape[2] // sp
    lse4 = lse_acc.view(B, H, Tq, 1)
    for i, j, f in pairs:
        qi, kj, vj, mj, sd = _pair_inputs(q, k, v, kv_mask, seeds, i, j, Sq, Sk)
        o_p, lse_p = flash_attention_ref(qi, kj, vj, mj,
                                         bool(f & RING_CAUSAL), sm_scale,
                                         rate, sd)
        o_t = o_p.float()
        lse_t = _mass_lse(lse_p.reshape(B, H, Sq, 1))
        o_a, l_a = _rows(o_acc, i, Sq), _rows(lse4, i, Sq)
        if not f & RING_FIRST:
            o_t, lse_t = _merge_partial(o_a.contiguous(), l_a.contiguous(),
                                        o_t, lse_t)
        if f & RING_LAST_Q:
            _rows(out, i, Sq).copy_(o_t.to(out.dtype))
            l_a.copy_(_kernel_lse(lse_t))
        else:
            o_a.copy_(o_t)
            l_a.copy_(lse_t)


def _sum_into(acc, dst, part, first: bool, last: bool) -> None:
    """acc += part in float32 (acc = part on the first hop); on the last,
    the sum goes to ``dst`` in its dtype instead."""
    total = part if first else acc.contiguous() + part
    (dst if last else acc).copy_(total.to(dst.dtype) if last else total)


def _dq_ring_plain(q, k, v, kv_mask, seeds, pairs, lse, delta, do, dq_acc,
                   dq, sm_scale, rate, out):
    """The plain K2 ring entry: each pair's dq by :func:`_bwd_ref` (q's
    dtype), widened and summed into shard i's rows of ``dq_acc``; with
    ``out`` each pair's delta rows are written first (K2's own delta)."""
    Tq = q.shape[2]
    sp = seeds.shape[0]
    Sq, Sk = Tq // sp, k.shape[2] // sp
    for i, j, f in pairs:
        qi, kj, vj, mj, sd = _pair_inputs(q, k, v, kv_mask, seeds, i, j, Sq, Sk)
        doi = _rows(do, i, Sq).contiguous()
        if out is not None:
            _rows(delta, i, Sq, 1).copy_(
                flash_attention_delta(_rows(out, i, Sq).contiguous(), doi))
        dq_p = _bwd_ref(qi, kj, vj, mj, _rows(lse, i, Sq, 1).contiguous(),
                        _rows(delta, i, Sq, 1).contiguous(), doi,
                        bool(f & RING_CAUSAL), sm_scale, rate, sd, True,
                        False)[0]
        _sum_into(_rows(dq_acc, i, Sq), _rows(dq, i, Sq), dq_p.float(),
                  bool(f & RING_FIRST), bool(f & RING_LAST_Q))


def _dkv_ring_plain(q, k, v, kv_mask, seeds, pairs, lse, delta, do, dk_acc,
                    dv_acc, dk, dv, sm_scale, rate):
    """The plain K3 ring entry: each pair's dk, dv by :func:`_bwd_ref`,
    widened and summed into kv shard j's rows of the accumulators."""
    Tq = q.shape[2]
    sp = seeds.shape[0]
    Sq, Sk = Tq // sp, k.shape[2] // sp
    for i, j, f in pairs:
        qi, kj, vj, mj, sd = _pair_inputs(q, k, v, kv_mask, seeds, i, j, Sq, Sk)
        _, dk_p, dv_p = _bwd_ref(qi, kj, vj, mj,
                                 _rows(lse, i, Sq, 1).contiguous(),
                                 _rows(delta, i, Sq, 1).contiguous(),
                                 _rows(do, i, Sq).contiguous(),
                                 bool(f & RING_CAUSAL), sm_scale, rate, sd,
                                 False, True)
        for acc, dst, part in ((dk_acc, dk, dk_p), (dv_acc, dv, dv_p)):
            _sum_into(_rows(acc, j, Sk), _rows(dst, j, Sk), part.float(),
                      bool(f & RING_FIRST), bool(f & RING_LAST_KV))


def _ring_words(pairs):
    """A hop table as the kernels read it: i | j << 12 | flags << 24."""
    if not 0 < len(pairs) <= RING_MAX_PAIRS:
        raise ValueError(f"a ring launch takes 1 to {RING_MAX_PAIRS} pairs, "
                         f"got {len(pairs)}")
    return (ctypes.c_uint32 * len(pairs))(
        *(i | j << 12 | f << 24 for i, j, f in pairs))


def _check_ring(q, k, v, kv_mask, seeds, pairs, **extra):
    """What the ring entries take: the whole tensors of
    :func:`_check_flash` (lse, delta [B*H, Tq]; accumulators and outputs
    of q's or k's shape), an int32 [sp, sp] seed grid, a table of pairs
    of shards below sp."""
    _check_flash(q, k, v, kv_mask, None, seeds=seeds, **extra)
    B, H, Tq, D = q.shape
    sp = seeds.shape[0]
    if seeds.shape != (sp, sp) or not 0 < sp < RING_MAX_SHARDS:
        raise ValueError(f"the pair seeds are an [sp, sp] grid with sp < "
                         f"{RING_MAX_SHARDS}, got {tuple(seeds.shape)}")
    if Tq % sp or k.shape[2] % sp:
        raise ValueError(f"Tq={Tq} and Tk={k.shape[2]} must be multiples of "
                         f"sp={sp}")
    for name, t in extra.items():
        want = (B * H * Tq if name in ("lse", "lse_acc", "delta") else
                k.numel() if name in ("dk", "dv", "dk_acc", "dv_acc")
                else q.numel())
        if t.numel() != want:
            raise ValueError(f"ring entry: {name} holds {t.numel()} values, "
                             f"not {want}")
    if any(not (0 <= i < sp and 0 <= j < sp) for i, j, _ in pairs):
        raise ValueError(f"a pair's shards lie outside 0..{sp - 1}: {pairs}")


def _ring_common(q, k, seeds, sm_scale, rate):
    """(B, H, sp, Sq, Sk, D, scale_log2, rate, keep, bq, bk) of a ring
    launch: the pairs' shard lengths and their logical tiles."""
    B, H, Tq, D = q.shape
    sp = seeds.shape[0]
    Sq, Sk = Tq // sp, k.shape[2] // sp
    bq, bk = resolve_blocks(Sq, Sk)
    rate = float(rate or 0.0)
    keep = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    return B, H, sp, Sq, Sk, D, _scale_log2(sm_scale), rate, keep, bq, bk


_FWD_RING_ARGS = [_PTR] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + \
    [ctypes.c_int] * 3 + [_PTR, ctypes.c_int, _PTR]
_BWD_RING_ARGS = [_PTR] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + \
    [ctypes.c_int] * 3 + [_PTR, ctypes.c_int, _PTR]


def flash_attention_fwd_ring(q, k, v, kv_mask, seeds, pairs, o_acc, lse_acc,
                             out, sm_scale: float, dropout_rate: float = 0.0):
    """One hop of ring attention's forward: K1 on every pair ``(i, j,
    flags)`` of ``pairs`` (:func:`ring_hops`), q shard i of the whole q
    [B, H, Tq, D] against kv shard j of the whole k, v [B, H, Tk, D] and
    kv_mask [B, Tk] (shards of Tq / sp and Tk / sp rows, sp =
    ``seeds.shape[0]``; the pair's dropout seed is ``seeds[i, j]``).  Each
    pair's output, rounded to q's dtype, merges into shard i's rows of
    the float32 ``o_acc`` [B, H, Tq, D] and ``lse_acc`` [B*H, Tq] (log2
    masses) in place; the first hop writes them, and a q shard's last
    pair writes ``out`` (q's dtype; for float32 it may be ``o_acc``
    itself) and ``lse_acc`` in the kernels' form (+1e30 for an empty row).

    CPU tensors take the plain loop :func:`_fwd_ring_plain`; CUDA tensors
    launch ``flash_attn_fwd_ring`` or ``flash_attn_fwd_bf16_ring`` once,
    or raise.  Each launch adds one to ``flash_attention_fwd.launches``."""
    if q.device.type == "cpu":
        return _fwd_ring_plain(q, k, v, kv_mask, seeds, pairs, o_acc,
                               lse_acc, out, sm_scale, dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_ring(q, k, v, kv_mask, seeds, pairs, o_acc=o_acc,
                lse_acc=lse_acc, out=out)
    B, H, sp, Sq, Sk, D, sl2, rate, keep, bq, bk = _ring_common(
        q, k, seeds, sm_scale, dropout_rate)
    lib, name = _FLASH_LIBS[q.dtype]["fwd_ring"]
    fn = _flash_fn(lib, name, _FWD_RING_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
             seeds.data_ptr(), o_acc.data_ptr(), lse_acc.data_ptr(),
             out.data_ptr(), B, H, sp, Sq, Sk, D, sl2, rate, keep, bq, bk,
             len(pairs), ctypes.cast(_ring_words(pairs), _PTR),
             q.device.index, _build.current_stream(q))
    if err != 0:
        _raise_launch(lib, name, err)
    flash_attention_fwd.launches += 1


def flash_attention_bwd_dq_ring(q, k, v, kv_mask, seeds, pairs, lse, delta,
                                do, dq_acc, dq, sm_scale: float,
                                dropout_rate: float = 0.0, out=None):
    """One hop of ring attention's dq: K2 on every pair of ``pairs`` (as
    :func:`flash_attention_fwd_ring`) with the ring's merged ``lse`` and
    ``delta`` ([B*H, Tq], the kernels' form); each pair's dq, rounded to
    q's dtype, is added in float32 to shard i's rows of ``dq_acc`` (the
    first hop writes them), and a q shard's last pair writes ``dq`` in
    q's dtype (for float32 ``dq`` may be ``dq_acc``).  With ``out`` (the
    bfloat16 route's first hop) the pairs write their shard's rows of
    ``delta`` = rowsum(dO * O) before using them.

    CPU tensors take :func:`_dq_ring_plain`; CUDA tensors launch
    ``flash_attn_bwd_dq_ring`` or ``flash_attn_bwd_dq_bf16_ring`` once,
    or raise.  Each launch adds one to ``flash_attention_bwd_dq.launches``."""
    if q.device.type == "cpu":
        return _dq_ring_plain(q, k, v, kv_mask, seeds, pairs, lse, delta, do,
                              dq_acc, dq, sm_scale, dropout_rate, out)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    bf16 = q.dtype == torch.bfloat16
    if out is not None and not bf16:
        raise ValueError("the float32 K2 reads delta; pass out=None")
    extra = dict(out=out) if out is not None else {}
    _check_ring(q, k, v, kv_mask, seeds, pairs, lse=lse, delta=delta, do=do,
                dq_acc=dq_acc, dq=dq, **extra)
    B, H, sp, Sq, Sk, D, sl2, rate, keep, bq, bk = _ring_common(
        q, k, seeds, sm_scale, dropout_rate)
    lib, name = _FLASH_LIBS[q.dtype]["dq_ring"]
    fn = _flash_fn(lib, name, _BWD_RING_ARGS)
    own = out is not None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
             seeds.data_ptr(), do.data_ptr(), lse.data_ptr(),
             None if own else delta.data_ptr(), _ptr(out),
             delta.data_ptr() if own else None, dq_acc.data_ptr(),
             dq.data_ptr(), B, H, sp, Sq, Sk, D, sl2, float(sm_scale), rate,
             keep, bq, bk, len(pairs), ctypes.cast(_ring_words(pairs), _PTR),
             q.device.index, _build.current_stream(q))
    if err != 0:
        _raise_launch(lib, name, err)
    flash_attention_bwd_dq.launches += 1


def flash_attention_bwd_dkv_ring(q, k, v, kv_mask, seeds, pairs, lse, delta,
                                 do, dk_acc, dv_acc, dk, dv, sm_scale: float,
                                 dropout_rate: float = 0.0):
    """One hop of ring attention's dk, dv: K3 on every pair of ``pairs``
    (as :func:`flash_attention_bwd_dq_ring`); each pair's dk and dv,
    rounded to k's dtype, are added in float32 to kv shard j's rows of
    ``dk_acc`` and ``dv_acc`` [B, H, Tk, D] (the first hop writes them),
    and a kv shard's last pair writes ``dk``, ``dv`` in k's dtype.

    CPU tensors take :func:`_dkv_ring_plain`; CUDA tensors launch
    ``flash_attn_bwd_dkv_ring`` or ``flash_attn_bwd_dkv_bf16_ring`` once,
    or raise.  Each launch adds one to ``flash_attention_bwd_dkv.launches``."""
    if q.device.type == "cpu":
        return _dkv_ring_plain(q, k, v, kv_mask, seeds, pairs, lse, delta,
                               do, dk_acc, dv_acc, dk, dv, sm_scale,
                               dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_ring(q, k, v, kv_mask, seeds, pairs, lse=lse, delta=delta, do=do,
                dk_acc=dk_acc, dv_acc=dv_acc, dk=dk, dv=dv)
    B, H, sp, Sq, Sk, D, sl2, rate, keep, bq, bk = _ring_common(
        q, k, seeds, sm_scale, dropout_rate)
    lib, name = _FLASH_LIBS[q.dtype]["dkv_ring"]
    fn = _flash_fn(lib, name, _BWD_RING_ARGS)
    # as flash_attention_bwd_dkv: the float32 kernel's q tile is pre-scaled
    dk_scale = (float(sm_scale) / sl2 if q.dtype == torch.float32
                else float(sm_scale))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
             seeds.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk_acc.data_ptr(), dv_acc.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, H, sp, Sq, Sk, D, sl2, dk_scale,
             rate, keep, bq, bk, len(pairs),
             ctypes.cast(_ring_words(pairs), _PTR), q.device.index,
             _build.current_stream(q))
    if err != 0:
        _raise_launch(lib, name, err)
    flash_attention_bwd_dkv.launches += 1


class _Frames:
    """The hop route's tensors on each distinct device of the ring, whole
    size, a shard addressed by its rows: on q's device (home) the whole
    tensors themselves, elsewhere tensors of their size that hold the rows
    of the shards copied there.  On one device (a mesh that repeats one
    card) nothing is copied."""

    def __init__(self, devices, home):
        self.devices = list(devices)
        self.home = home
        self.places = list(dict.fromkeys(self.devices))

    def holding(self, x, dim: int):
        """``x`` on every place: itself at home; elsewhere a tensor of its
        size holding the rows of the shards whose devices are there."""
        if x is None:
            return {d: None for d in self.places}
        n = x.shape[dim] // len(self.devices)
        out = {}
        for d in self.places:
            if d == x.device:
                out[d] = x
                continue
            f = torch.empty(x.shape, dtype=x.dtype, device=d)
            for i, di in enumerate(self.devices):
                if di == d:
                    _rows(f, i, n, dim).copy_(_rows(x, i, n, dim),
                                              non_blocking=True)
            out[d] = f
        return out

    def new(self, shape, dtype, home=None):
        """Uninitialised tensors on every place (``home`` at home)."""
        return {d: home if home is not None and d == self.home else
                torch.empty(shape, dtype=dtype, device=d)
                for d in self.places}

    def gather(self, frames, n: int, dim: int, where) -> torch.Tensor:
        """The home tensor, with shard i's rows copied in from
        ``where[i]``'s frame where that is not home."""
        dst = frames[self.home] if self.home in frames else None
        if dst is None:
            ref = next(iter(frames.values()))
            dst = torch.empty(ref.shape, dtype=ref.dtype, device=self.home)
        for i, d in enumerate(where):
            if d != self.home:
                _rows(dst, i, n, dim).copy_(_rows(frames[d], i, n, dim),
                                            non_blocking=True)
        return dst


def _ring_places(q, devices):
    """The ring's devices as ``torch.device`` objects, a bare ``cuda``
    taken as the current card."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return tuple(out)


def _fetch(frames, have, devices, i, j, n_of, dims, place):
    """Before pair (i, j) runs on ``place``: kv shard j's rows of each
    frame in ``frames`` copied there from the ring's previous position
    (devices[i - 1]), where ``place`` does not hold them yet."""
    if j in have[place]:
        return
    src = devices[i - 1]
    for fr, n, dim in zip(frames, n_of, dims):
        if fr[place] is not None:
            _rows(fr[place], j, n, dim).copy_(_rows(fr[src], j, n, dim),
                                              non_blocking=True)
    have[place].add(j)


def _kv_held(fr, devices, k):
    """Which kv shards each place holds at the start: all of them at
    home (the whole k), else those of its own positions."""
    return {d: set(range(len(devices))) if d == k.device
            else {i for i, di in enumerate(devices) if di == d}
            for d in fr.places}


def _ring_hop_forward(q, k, v, kv_mask, seed, devices, causal, sm_scale,
                      rate):
    """Ring attention's forward by the hop route (``_ring_fwd``,
    ``paddle_tpu/kernels/attention.py:797-849``): one K1 ring launch a
    hop on each device.  Returns (out [B, H, Tq, D] in q's dtype, lse
    [B*H, Tq] in the kernels' form), both on q's device."""
    sp = len(devices)
    B, H, Tq, D = q.shape
    Sq, Sk = Tq // sp, k.shape[2] // sp
    fr = _Frames(devices, q.device)
    grid = _seed_grid(seed, sp)
    seeds = {d: grid.to(d) for d in fr.places}
    qf = fr.holding(q, 2)
    kf, vf, mf = fr.holding(k, 2), fr.holding(v, 2), fr.holding(kv_mask, 1)
    have = _kv_held(fr, devices, k)
    out = fr.new(q.shape, q.dtype, torch.empty_like(q))
    lse = fr.new((B * H, Tq), torch.float32)
    o_acc = (out if q.dtype == torch.float32
             else fr.new(q.shape, torch.float32))
    for hop in ring_hops(devices, causal):
        for d, pairs in hop:
            for i, j, _ in pairs:
                _fetch((kf, vf, mf), have, devices, i, j, (Sk, Sk, Sk),
                       (2, 2, 1), d)
            with _on(d):
                flash_attention_fwd_ring(qf[d], kf[d], vf[d], mf[d],
                                         seeds[d], pairs, o_acc[d], lse[d],
                                         out[d], sm_scale, rate)
    return (fr.gather(out, Sq, 2, devices), fr.gather(lse, Sq, 1, devices))


def _ring_hop_backward(q, k, v, kv_mask, seed, out, lse, do, devices, causal,
                       sm_scale, rate):
    """Ring attention's backward by the hop route (``_ring_vjp_bwd``,
    ``paddle_tpu/kernels/attention.py:858-932``): a K2 and a K3 ring
    launch a hop on each device, every pair with the ring's merged lse
    (the kernels' form) and delta.  In float32 delta is one
    :func:`flash_attention_delta` over the whole (out, dO); in bfloat16
    the first hop's K2 writes it.  dk/dv accumulate with their kv shard:
    on distinct devices a shard's accumulator rows move to the device of
    its next pair, and its last pair's device holds the result."""
    sp = len(devices)
    B, H, Tq, D = q.shape
    Sq, Sk = Tq // sp, k.shape[2] // sp
    f32 = q.dtype == torch.float32
    fr = _Frames(devices, q.device)
    grid = _seed_grid(seed, sp)
    seeds = {d: grid.to(d) for d in fr.places}
    qf, dof, lsef = fr.holding(q, 2), fr.holding(do, 2), fr.holding(lse, 1)
    kf, vf, mf = fr.holding(k, 2), fr.holding(v, 2), fr.holding(kv_mask, 1)
    have = _kv_held(fr, devices, k)
    outf = None if f32 else fr.holding(out, 2)
    delta = (fr.holding(flash_attention_delta(out, do), 1) if f32
             else fr.new((B * H, Tq), torch.float32))
    dq = fr.new(q.shape, q.dtype, torch.empty_like(q))
    dk = fr.new(k.shape, k.dtype, torch.empty_like(k))
    dv = fr.new(v.shape, v.dtype, torch.empty_like(v))
    dq_acc = dq if f32 else fr.new(q.shape, torch.float32)
    dk_acc = dk if f32 else fr.new(k.shape, torch.float32)
    dv_acc = dv if f32 else fr.new(v.shape, torch.float32)
    owner = list(devices)  # where kv shard j's dk/dv accumulators are
    for t, hop in enumerate(ring_hops(devices, causal)):
        for d, pairs in hop:
            for i, j, _ in pairs:
                _fetch((kf, vf, mf), have, devices, i, j, (Sk, Sk, Sk),
                       (2, 2, 1), d)
                if owner[j] != d:
                    for acc in (dk_acc, dv_acc):
                        _rows(acc[d], j, Sk).copy_(_rows(acc[owner[j]], j, Sk),
                                                   non_blocking=True)
                    owner[j] = d
            with _on(d):
                flash_attention_bwd_dq_ring(
                    qf[d], kf[d], vf[d], mf[d], seeds[d], pairs, lsef[d],
                    delta[d], dof[d], dq_acc[d], dq[d], sm_scale, rate,
                    out=outf[d] if outf is not None and t == 0 else None)
                flash_attention_bwd_dkv_ring(
                    qf[d], kf[d], vf[d], mf[d], seeds[d], pairs, lsef[d],
                    delta[d], dof[d], dk_acc[d], dv_acc[d], dk[d], dv[d],
                    sm_scale, rate)
    return (fr.gather(dq, Sq, 2, devices), fr.gather(dk, Sk, 2, owner),
            fr.gather(dv, Sk, 2, owner))


class RingAttentionFn(torch.autograd.Function):
    """Forward: the hop route over K1's ring entry; backward: the hop
    route over K2's and K3's on the saved (q, k, v, mask, seed, out, lse),
    with no re-run of the forward.  ``plain`` takes the plain ring, the
    pair-by-pair walk over the plain pair functions, on any device
    (:func:`ring_attention_ref`)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, devices, causal, sm_scale,
                dropout_rate, plain):
        if plain:
            out, lse = _ring_forward(q, k, v, kv_mask, seed, devices, causal,
                                     sm_scale, dropout_rate,
                                     flash_attention_ref)
        else:
            out, lse = _ring_hop_forward(q, k, v, kv_mask, seed, devices,
                                         causal, sm_scale, dropout_rate)
        ctx.save_for_backward(q, k, v, kv_mask, seed, out, lse)
        ctx.args = (devices, causal, sm_scale, dropout_rate, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, seed, out, lse = ctx.saved_tensors
        devices, causal, sm_scale, rate, plain = ctx.args
        if plain:
            dq, dk, dv = _ring_backward(q, k, v, kv_mask, seed, out, lse,
                                        do.contiguous(), devices, causal,
                                        sm_scale, rate, _plain_dq, _plain_dkv)
        else:
            dq, dk, dv = _ring_hop_backward(q, k, v, kv_mask, seed, out, lse,
                                            do.contiguous(), devices, causal,
                                            sm_scale, rate)
        return dq, dk, dv, None, None, None, None, None, None, None


def _ring(q, k, v, kv_mask, devices, causal, sm_scale, dropout_rate,
          dropout_seed, plain):
    devices = _ring_places(q, devices)
    _ring_check(q, k, devices)
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    seed = (torch.zeros(1, dtype=torch.int32, device=q.device)
            if dropout_seed is None else dropout_seed.reshape(1))
    return RingAttentionFn.apply(q, k, v, kv_mask, seed, devices,
                                 bool(causal), float(sm_scale),
                                 float(dropout_rate or 0.0), plain)


def ring_attention(q, k, v, kv_mask, devices, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   dropout_rate: float = 0.0, dropout_seed=None):
    """Differentiable sequence-parallel ring attention, the port of
    ``ring_attention``/``_ring_flash``
    (``paddle_tpu/kernels/attention.py:694-935``).

    q [B, H, Tq, D], k/v [B, H, Tk, D] and kv_mask [B, Tk] (or None) are
    whole; the sequence axis is cut into ``sp = len(devices)`` contiguous
    shards, shard i on ``devices[i]`` (a mesh's ``sp`` axis gives them:
    ``Mesh.axis_devices``).  Devices may repeat: one card then holds every
    shard, and nothing is copied.  Hop t pairs q shard i with kv shard
    (i - t) mod sp (``causal`` on the diagonal hop 0; under ``causal`` a
    pair above the diagonal is left out), in the reference's order, and
    runs as one ring launch of K1 on each distinct device, which carries
    that hop's pairs of the q shards it holds (:func:`ring_hops`); the
    launch reads its shards in place, as rows of the whole tensors, and
    merges each pair's output (rounded to q's dtype) by its log2 mass
    into float32 accumulators in its epilogue.  Between hops a device
    that lacks a kv shard takes it (``tensor.copy_``) from the ring's
    previous position.  Dropout keys each pair on :func:`_pair_seed`.
    The backward runs K2 and K3 the same way from the saved forward, dq
    summed on its shard, dk/dv with their kv shard.

    Launches per call: K1 once a hop on each device that has a pair in
    it: ``sp`` times on one card, causal or not; the backward the same
    counts of K2 and of K3.  CPU tensors take the ring entries' plain
    loops (no launch), as the other wrappers do."""
    return _ring(q, k, v, kv_mask, devices, causal, sm_scale,
                 dropout_rate, dropout_seed, plain=False)


def ring_attention_ref(q, k, v, kv_mask, devices, causal: bool = False,
                       sm_scale: Optional[float] = None,
                       dropout_rate: float = 0.0, dropout_seed=None):
    """The plain ring: the reference's walk pair by pair over
    :func:`flash_attention_ref` and the plain backward, with the merges,
    casts and gradient sums in torch ops and every shard copied to its
    device, on any device; differentiable the same way.  The hop route's
    yardstick."""
    return _ring(q, k, v, kv_mask, devices, causal, sm_scale,
                 dropout_rate, dropout_seed, plain=True)


def hash_dropout_ref(seed, shape, rate: float, device=None) -> torch.Tensor:
    """The reference's ``_hash_dropout`` multiplier [B, H, Tq, Tk] for
    the plain attention chain, keyed by (seed, element coords); the
    reference's salt, a ring-attention shard offset, is 0 here."""
    B, H, Tq, Tk = shape

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    x = mul32(ar(Tq), ROW_MUL)[:, None] ^ mul32(ar(Tk), COL_MUL)[None]
    bh = (mul32(ar(B), C3)[:, None] + mul32(ar(H), C4)[None]) & M32
    s = (torch.zeros((), dtype=torch.int64, device=device) if seed is None
         else u32(seed.reshape(-1)[0]))
    return dropout_multiplier(x[None, None] ^ bh[:, :, None, None] ^ s,
                              rate)


def mha_ref(q, k, v, kv_mask=None, causal: bool = False,
            sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
            dropout_seed=None):
    """Plain attention, the port of ``mha_xla``: q,k,v [B, H, T, D],
    kv_mask [B, Tk] 1/0 → [B, H, Tq, D]; attention-probability dropout
    from :func:`hash_dropout_ref` bits."""
    if sm_scale is None:
        sm_scale = float(1.0 / math.sqrt(q.shape[-1]))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if kv_mask is not None:
        s = s.masked_fill(~(kv_mask[:, None, None, :] > 0), NEG_INF)
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None]
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(qi < ki, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_rate and dropout_rate > 0.0:
        p = p * hash_dropout_ref(dropout_seed, tuple(p.shape), dropout_rate,
                                 device=q.device)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


__all__ = ["FLASH_MAX_HEAD_DIM", "FlashAttentionFn", "LOG2E",
           "MAX_HEAD_DIM", "NEG_INF", "RING_CAUSAL", "RING_FIRST",
           "RING_LAST_KV", "RING_LAST_Q", "RING_MAX_PAIRS", "RING_PAIR_SALT",
           "RingAttentionFn", "decode_attention", "decode_splits",
           "flash_attention",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_ring",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_ring",
           "flash_attention_bwd_ref", "flash_attention_delta",
           "flash_attention_fwd", "flash_attention_fwd_ring",
           "flash_attention_ref", "hash_dropout_ref",
           "mha_ref", "paged_attention_ref", "resolve_blocks",
           "ring_attention", "ring_attention_ref", "ring_hops",
           "tile_dropout_ref"]