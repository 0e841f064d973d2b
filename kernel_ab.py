#!/usr/bin/env python3
"""Hand-written kernels of this checkout against those of other checkouts
of the repository, on one CUDA card, in one process.

    git archive <commit> paddle_tpu_torch/kernels/csrc | tar -x -C <dir>
    python3 kernel_ab.py <kernel>[,<kernel> ...] <dir> [<dir> ...]

<kernel> is one of

- ``flash_fwd``: K1 in float32 (``csrc/flash_attn_fwd.cu``) at the
  training shape (dropout 0.1, not causal and causal) and at B=4, H=8,
  T=8192, D=64 causal: each build's outputs bit for bit against this
  one's, and its device time;
- ``flash_bwd``: K2/K3 (``csrc/flash_attn_bwd.cu``) at the bench shape
  (B=32, H=8, T=256, D=64, ragged key masks), dropout 0.1 (not causal and
  causal) and rate 0, with each build's registers, shared memory and
  resident blocks an SM, and whether its dq, dk, dv are bit for bit this
  build's.  A source with no occupancy query of its own
  (PR 2's kernels, templates in an anonymous namespace) is compiled with
  a small shim that includes it and reports them;
- ``flash_bwd_bf16``: K2/K3 in bfloat16 (``csrc/flash_attn_bwd_bf16.cu``)
  at four shapes (``FLASH_BF16_AB_SHAPES``): the training shape (B=32,
  H=8, T=256, D=64, ragged key masks, dropout 0.1, not causal and
  causal), ``bench_flash_attention_long``'s B=4, T=8192, causal, (H, D) =
  (8, 64) and (4, 128), and the bf16 ring's pair (B=1, H=4, 4,096 x
  4,096, D=128, ragged keys): each kernel alone from the same lse and
  delta (the forward's, this checkout's K1), and the backward's whole
  device work, delta + K2 + K3 (a build whose K2 computes delta, one
  whose source names ``delta_out``, does so; another takes delta by the
  float32 torch reduction), with each build's registers, shared memory
  and blocks an SM, and its max error against the plain bf16 version
  (at T=8192, where the plain version's scores do not fit, against the
  first build's output), whether its outputs are bit for bit the first
  build's, and the bound at the bf16 rate;
- ``flash_fwd_bf16``: K1 in bfloat16 (``csrc/flash_attn_fwd_bf16.cu``)
  at ``FLASH_FWD_BF16_AB_SHAPES``: (a) the training shape (B=32, H=8,
  T=256, D=64, ragged key masks, dropout 0.1, not causal and causal),
  (b, c) ``bench_flash_attention_long``'s B=4, T=8192, causal, (H, D) =
  (8, 64) and (4, 128), (d) the bf16 ring's pair (B=1, H=4, 4,096 x
  4,096, D=128, ragged keys, dropout 0.1) and its causal diagonal at rate
  0.  Each build's device time, its max error against
  the plain bf16 version (at T=8192, where the plain version's scores do
  not fit, against the float32 K1 on the same inputs upcast, within
  ``FLASH_BF16_VS_F32_REL``), whether its out and LSE are bit for bit
  this build's, SDPA bf16's forward on the same inputs and mask (device
  time), and the bound at the bf16 rate; this build's registers, shared
  memory, blocks an SM and local bytes;
- ``paged_decode``: K4 (``csrc/paged_decode_attn.cu``), float32 and int8
  at the decode shape and at the long-context case
  (``chip_smoke.PAGED_SHAPES``), cycling input sets past the L2.  Another
  checkout is called through ``paged_decode_attn`` (one split), this one
  through ``decode_attention``, which cuts a long table into context
  splits;
- ``lstm_fwd``: K6 (``csrc/lstm_fwd.cu``) at the stacked LSTM's bench
  shape, ragged and full, and ragged at H=1024 (``LSTM_WIDE_H``), every
  build through ``lstm_fwd`` (given enough barrier words for either
  design);
- ``gru_fwd``: K8a (``csrc/gru_fwd.cu``) at machine translation's shape
  (``chip_smoke.GRU_TIME_SHAPE``), ragged 8..32 and full, and ragged at
  H=1024 (``GRU_WIDE_H``), every build through ``gru_fwd`` (given enough
  barrier words for either design; a build that does not take a shape
  is listed as refused);
- ``gru_bwd``: K8b (``csrc/gru_bwd.cu``) at machine translation's shape
  (``chip_smoke.GRU_TIME_SHAPE``), ragged 8..32 and full, and ragged at
  H=1024 (``GRU_WIDE_H``: 8 units a block past H=896), every build
  through ``gru_bwd`` (given the barrier words its own
  ``gru_bwd_sync_words`` asks for, one where it has none); a build with
  K8b's three launches is also timed launch by launch;
- ``sparse_update``: K10 (``csrc/sparse_update.cu``), Adam on DeepFM's
  two tables ([1e6, 10] and [1e6, 1]) from one id batch
  (``chip_smoke.sparse_ids``, and a skewed batch of Zipf ids whose
  hottest id covers a tenth of it), cycling 32 batches: the kernel alone
  on each table, what is sorted in front of it, and the step's pair with
  everything in front of it.
  This checkout goes through ``rowwise_update`` with a run's memo (one
  int32 sort shared by both tables; the kernel reads the values through
  the permutation); another checkout through its own K10 behind the
  wrapper it had before the sort was shared (a stable int64 sort,
  the sorted copy of the values and the run flags, for each table);
- ``sparse_gather``: K9 (``csrc/sparse_gather.cu``) on DeepFM's two
  tables ([1e6, 10] and [1e6, 1]) with the bench batch
  (``chip_smoke.sparse_ids``), the same ids as int32 and a skewed batch
  (Zipf ids, the hottest a tenth of it), on four tables of widths 10, 1,
  3 and 16 and on one [1e6, 64] table, cycling 32 id batches: the
  kernel's device time with the L2 read over before each call (its rows
  and ids come from device memory), the same with the ids read back
  into the L2 (``ids_in_l2_ms``) and without either (``warm_ms``), the
  call's device time, the wall per call in a loop, and ``F.embedding``
  on each table (device and wall) beside them, with the byte and sector
  bounds.  This checkout goes through ``fused_gather``; another
  checkout whose source has no ``GatherParams`` through the first
  version's entry point (21 arguments, int64 ids) behind a copy of the
  wrapper it had.  The host cost of each piece of both launch paths is
  timed too (``launch_pieces``);
- ``ring_bf16``: ring attention (K11) in bfloat16 at 13a's shape
  (``chip_smoke.RING_SHAPE``: B=1, H=4, D=128, sp=4 on the card,
  T=16,384, ragged keys), dropout 0.1 and causal at rate 0: the ring's
  forward and backward bodies (``RingAttentionFn``'s), each build's
  device time with its K1 (K2 + K3) share and the rest, and CUDA-event
  times.  The other directory holds another checkout's whole kernels
  package (``git archive <commit> paddle_tpu_torch/kernels | tar -x -C
  <dir>``), loaded as a package of its own that builds its sources into
  its own ``build/``; a package without the hop route
  (``_ring_hop_forward``) runs its pair-by-pair walk.  Each build's
  output and gradients against this one's (max error, bit equality);
- ``ring_f32``: the same in float32;
- ``int8_fc``: K5 (``csrc/int8_fc.cu``) at the int8 Transformer's four
  bucket-8 shapes (``chip_smoke.INT8_SHAPES``) with the path's acts, on
  quantized activations, cycling input sets past the L2, and their sum
  over one dispatch's 97 launches.  A build with ``int8_fc_config``
  takes the weight K-major ([N, K]); one without takes it as stored
  ([K, N]).

Every source keeps its C entry points.  Each kernel is checked against
this checkout's plain version (a disagreement is reported, not raised, so
a variant built to find where the time goes can be timed too) and its
device time taken (``chip_smoke.py``'s ``device_ms``, the torch
profiler's median of three sessions) in turns, other, this, this, other;
the flash modes time by CUDA events where the profiler lost most
sessions' records (``flash_ms``; the row lists them).
One JSON line at the end; run on a card, it fails without one.
"""
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import (DEEPFM_B, FLASH_BF16_REL,  # noqa: E402
                        FLASH_BF16_VS_F32_REL, RING_SP,
                        FLASH_GRAD_TOL, FLASH_TIME_SHAPE, GRU_TIME_SHAPE,
                        INT8_DISPATCH_SHAPES, INT8_SHAPES, K4_KERNELS,
                        K8B_LAUNCHES, L2_BYTES, LSTM_SHORTEST,
                        LSTM_TIME_SHAPE, MT_SHORTEST, PAGED_SHAPES,
                        SPARSE_EMBED, SPARSE_FIELDS, SPARSE_HYPER,
                        SPARSE_ROWS, SPARSE_TIME_SETS, bits_equal,
                        device_ms, device_ms_by_name, flash_as,
                        flash_inputs, flash_kernel_names, flash_work, gather_work, gru_inputs,
                        int8_case, lstm_inputs, nvidia_smi_line, paged_inputs,
                        ring_inputs, sparse_ids, time_ms,
                        update_tables, work, worst, zipf_ids)
from paddle_tpu_torch.core.selected_rows import SelectedRows  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import attention as A  # noqa: E402
from paddle_tpu_torch.kernels import quant as Q  # noqa: E402
from paddle_tpu_torch.kernels import rnn as R  # noqa: E402
from paddle_tpu_torch.kernels import sparse as S  # noqa: E402
from paddle_tpu_torch.observability import stats  # noqa: E402

# PR 2's K2/K3 at D=64: LPR = 2 lanes a row, 128 threads
FLASH_SHIM = r"""
#include "%s"
namespace {
template <typename K>
int occ(K kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = blocks;
  return static_cast<int>(err);
}
}
extern "C" int flash_attn_bwd_occupancy(int D, int Tq, int Tk, int device, int* out) {
  int err = occ(flash_bwd_dq_kernel<2>, 128, out);
  return err ? err : occ(flash_bwd_dkv_kernel<2>, 128, out + 4);
}
"""

OCC_KEYS = ("registers", "static_smem", "dynamic_smem", "blocks_per_sm")
# paged_decode_attn (one split): q, k/v caches, k/v scales, tables,
# lengths, out; S, H, D, bs, MB, quantized; sm_scale; device; stream
PAGED_ONE_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
BARRIER_WORDS = 64   # group barriers of the widest batch timed here
LSTM_WIDE_H = 1024   # K6 past H=512: 8 units a block
GRU_WIDE_H = 1024    # K8a and K8b past H=896: 8 units a block


# tag -> the csrc source each other build was made from
SOURCES = {}


def build_other(src_dir: str, out_dir: str, tag: str, name: str,
                shim=None):
    """``csrc/<name>.cu`` of the checkout ``src_dir`` built with this
    checkout's flags; ``shim`` = (marker, text): compiled around the source
    when the source lacks ``marker``.  Prints ptxas' register lines."""
    src = os.path.join(os.path.abspath(src_dir), "paddle_tpu_torch", "kernels",
                       "csrc", f"{name}.cu")
    SOURCES[tag] = src
    if shim is not None:
        with open(src) as f:
            if shim[0] not in f.read():
                path = os.path.join(out_dir, f"{tag}_{name}_shim.cu")
                with open(path, "w") as g:
                    g.write(shim[1] % src)
                src = path
    lib = os.path.join(out_dir, f"lib{tag}_{name}.so")
    log = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log.stdout}{log.stderr}")
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line or "C7515" in line:
            print(f"  {tag}:", line.strip(), flush=True)
    return ctypes.CDLL(lib)


def turns(libs) -> list:
    """other, this, this, other for each other build."""
    return [w for o in libs if o != "this" for w in (o, "this", "this", o)]


def flash_ms(fn, sets, iters, name, row, key) -> float:
    """``device_ms``, or where the profiler recorded no device time in
    most of its sessions (it drops records now and then, more often on
    some hosts), CUDA events around ``iters`` calls (at least 20); the
    keys so timed are listed under ``row["event_timed"]``."""
    try:
        return device_ms(fn, sets, iters=iters, name=name)
    except AssertionError as e:
        row.setdefault("event_timed", []).append(key)
        print(f"  {key}: {e}; timed by CUDA events", flush=True)
        return time_ms(fn, sets, iters=max(iters, 20), warmup=3)


def err_of(got, want) -> str:
    e = max((g - w).abs().max().item() for g, w in zip(got, want))
    return repr(e) if math.isfinite(e) else f"disagrees: {e}"


# ---------------------------------------------------------------------------
# K2/K3
# ---------------------------------------------------------------------------

def flash_occupancy(lib, device: int) -> dict:
    fn = lib.flash_attn_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    err = fn(64, 256, 256, device, out)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_occupancy: cudaError {err}")
    return {k: {key: out[4 * i + j] for j, key in enumerate(OCC_KEYS)}
            for i, k in enumerate(("bwd_dq", "bwd_dkv"))}


def flash_call(lib, which: str, s, causal, rate):
    """One launch of K2 or K3 of ``lib`` on input set ``s``."""
    dq, dkv = lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkv
    dq.argtypes, dq.restype = A._DQ_ARGS, ctypes.c_int
    dkv.argtypes, dkv.restype = A._DKV_ARGS, ctypes.c_int
    q, k, v = s["q"], s["k"], s["v"]
    scale = float(1.0 / math.sqrt(q.shape[-1]))
    B, H, Tq, Tk, D, c, sl2, r, keep, bq, bk = A._common(q, k, causal,
                                                          scale, rate)
    stream = torch.cuda.current_stream().cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), s["mask"].data_ptr(),
              s["seed"].data_ptr(), s["do"].data_ptr(), s["lse"].data_ptr(),
              s["delta"].data_ptr())
    if which == "bwd_dq":
        err = dq(*common, s["dq"].data_ptr(), B, H, Tq, Tk, D, c, sl2, scale,
                 r, keep, bq, bk, q.device.index, stream)
    else:
        err = dkv(*common, s["dk"].data_ptr(), s["dv"].data_ptr(), B, H, Tq,
                  Tk, D, c, sl2, scale / sl2, r, keep, bq, bk,
                  q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{which}: cudaError {err}")


def ab_flash_bwd(libs, dev) -> dict:
    res = {"occupancy": {t: flash_occupancy(lib, dev.index)
                         for t, lib in libs.items()}}
    print(json.dumps(res["occupancy"]), flush=True)
    B, H, T, D = FLASH_TIME_SHAPE
    one = flash_inputs(dev, B, H, T, T, D, seed=40)
    set_bytes = sum(one[n].numel() * 4 for n in ("q", "k", "v", "do"))
    n_sets = max(2, math.ceil(2 * L2_BYTES / set_bytes))
    for label, causal, rate in (("self_dropout", False, 0.1),
                                ("causal_dropout", True, 0.1),
                                ("self", False, 0.0)):
        sets = [flash_inputs(dev, B, H, T, T, D, seed=41 + i)
                for i in range(n_sets)]
        for s in sets:
            s["out"], s["lse"] = A.flash_attention_fwd(
                s["q"], s["k"], s["v"], s["mask"], causal, None, rate,
                s["seed"])
            s["delta"] = A.flash_attention_delta(s["out"], s["do"])
            for n in ("dq", "dk", "dv"):
                s[n] = torch.empty_like(s["q"])
        s = sets[0]
        want = A.flash_attention_bwd_ref(
            s["q"], s["k"], s["v"], s["mask"], s["out"], s["lse"], s["do"],
            causal, None, rate, s["seed"], delta=s["delta"])
        row, mine = {}, None
        for who in ["this"] + [w for w in libs if w != "this"]:
            lib = libs[who]
            for which in ("bwd_dq", "bwd_dkv"):
                flash_call(lib, which, s, causal, rate)
            torch.cuda.synchronize()
            got = [s[n].clone() for n in ("dq", "dk", "dv")]
            mine = got if who == "this" else mine
            row[f"{who}_bits_equal_this"] = all(
                torch.equal(a, b) for a, b in zip(got, mine))
            try:   # max |kernel - plain| over dq, dk, dv
                row[f"{who}_max_abs_err"] = repr(max(
                    worst(s[n], w, FLASH_GRAD_TOL)
                    for n, w in zip(("dq", "dk", "dv"), want)))
            except AssertionError as e:
                row[f"{who}_max_abs_err"] = f"disagrees: {e}"
        for which in ("bwd_dq", "bwd_dkv"):
            for who in turns(libs):
                ms = flash_ms(lambda x: flash_call(libs[who], which, x,
                                                   causal, rate),
                              sets, 50, f"flash_{which}_kernel", row,
                              f"{who}_{which}")
                row.setdefault(f"{who}_{which}_ms", []).append(ms)
        res[label] = row
        print(label, json.dumps(row), flush=True)
        del sets
        torch.cuda.empty_cache()
    return res


def ab_flash_fwd(libs, dev) -> dict:
    """K1 in float32 at the training shape (dropout 0.1, not causal and
    causal) and at B=4, H=8, T=8192, D=64 causal: each build's outputs
    bit for bit against this one's, its error against the plain version
    (at T=256), and its device time in turns."""
    res = {}
    for label, (B, H, T, D, causal, rate) in (
            ("self_dropout", (32, 8, 256, 64, False, 0.1)),
            ("causal_dropout", (32, 8, 256, 64, True, 0.1)),
            ("long_causal", (4, 8, 8192, 64, True, 0.0))):
        one = B * H * 3 * T * D * 4
        sets = [flash_inputs(dev, B, H, T, T, D, seed=60 + i)
                for i in range(max(2, math.ceil(2 * L2_BYTES / one)))]
        for x in sets:
            x.update(causal=causal, rate=rate, out=torch.empty_like(x["q"]),
                     lse=torch.empty(B * H, T, device=dev))
        calls = {t: flash_fwd_call(lib, "flash_attn_fwd")
                 for t, lib in libs.items()}
        s, row, mine = sets[0], {"shape": [B, H, T, D, causal, rate]}, None
        for who in ["this"] + [w for w in libs if w != "this"]:
            calls[who](s)
            torch.cuda.synchronize()
            got = (s["out"].clone(), s["lse"].clone())
            mine = got if who == "this" else mine
            row[f"{who}_bits_equal_this"] = (torch.equal(got[0], mine[0])
                                             and torch.equal(got[1], mine[1]))
        if T * T <= 1 << 20:
            want, _ = A.flash_attention_ref(s["q"], s["k"], s["v"], s["mask"],
                                            causal, None, rate, s["seed"])
            row["this_max_abs_err"] = (mine[0] - want).abs().max().item()
        for who in turns(libs):
            ms = flash_ms(calls[who], sets, 50 if T <= 256 else 5,
                          "flash_fwd_kernel", row, who)
            row.setdefault(f"{who}_ms", []).append(ms)
        res[label] = row
        print(label, json.dumps(row), flush=True)
        del sets, s
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# K2/K3 in bfloat16
# ---------------------------------------------------------------------------

# name: (B, H, Tq, Tk, D, causal, dropout rate, ragged key mask)
FLASH_BF16_AB_SHAPES = {
    "a_train": (32, 8, 256, 256, 64, False, 0.1, True),
    "a_train_causal": (32, 8, 256, 256, 64, True, 0.1, True),
    "b_long_h8_d64": (4, 8, 8192, 8192, 64, True, 0.0, False),
    "c_long_h4_d128": (4, 4, 8192, 8192, 128, True, 0.0, False),
    "d_ring_pair": (1, 4, 4096, 4096, 128, False, 0.0, True),
}
# the plain version's [T, T] scores fit up to this many query-key pairs
FLASH_BF16_AB_PLAIN_PAIRS = 1 << 27


def own_delta(tag: str) -> bool:
    """Whether the build's K2 computes delta (its source names
    delta_out); this checkout's does."""
    if tag == "this":
        return True
    with open(SOURCES[tag]) as f:
        return "delta_out" in f.read()


def flash_bf16_calls(lib, tag: str):
    """(K2 alone, K3 alone, delta + K2 + K3) of one build on an input
    set, the kernels from the set's lse and delta; the backward's own
    delta where the build's K2 computes it."""
    own = own_delta(tag)
    dq_fn, dkv_fn = lib.flash_attn_bwd_dq_bf16, lib.flash_attn_bwd_dkv_bf16
    dq_fn.argtypes = A._DQ_BF16_ARGS if own else A._DQ_ARGS
    dkv_fn.argtypes = A._DKV_ARGS
    dq_fn.restype = dkv_fn.restype = ctypes.c_int

    def run(s, which, delta=None, own_out=False):
        q, k, v = s["q"], s["k"], s["v"]
        B, H, Tq, Tk, D, c, sl2, r, keep, bq, bk = A._common(
            q, k, s["causal"], sm_scale_of(q), s["rate"])
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), A._ptr(s["mask"]),
                A._ptr(s["seed"]), s["do"].data_ptr(), s["lse"].data_ptr())
        tail = (B, H, Tq, Tk, D, c, sl2, sm_scale_of(q), r, keep, bq, bk,
                q.device.index, torch.cuda.current_stream().cuda_stream)
        if which == "dq":
            if own:
                err = dq_fn(*head, None if own_out else delta.data_ptr(),
                            s["out"].data_ptr() if own_out else None,
                            delta.data_ptr() if own_out else None,
                            s["dq"].data_ptr(), *tail)
            else:
                err = dq_fn(*head, delta.data_ptr(), s["dq"].data_ptr(),
                            *tail)
        else:
            err = dkv_fn(*head, delta.data_ptr(), s["dk"].data_ptr(),
                         s["dv"].data_ptr(), *tail)
        if err != 0:
            raise RuntimeError(f"{tag} {which}: cudaError {err}")

    def pair(s):
        if own:
            run(s, "dq", s["own_delta"], own_out=True)
            delta = s["own_delta"]
        else:
            delta = A.flash_attention_delta(s["out"], s["do"])
            run(s, "dq", delta)
        run(s, "dkv", delta)

    return {"bwd_dq": lambda s: run(s, "dq", s["delta"]),
            "bwd_dkv": lambda s: run(s, "dkv", s["delta"]),
            "bwd": pair}


def sm_scale_of(q) -> float:
    """The default sm_scale, 1 / sqrt(D)."""
    return float(1.0 / math.sqrt(q.shape[-1]))


def flash_bf16_occupancy(lib, D: int, device: int) -> dict:
    fn = lib.flash_attn_bwd_bf16_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    err = fn(D, device, out)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_bf16_occupancy: cudaError {err}")
    return {k: {key: out[4 * i + j] for j, key in enumerate(OCC_KEYS)}
            for i, k in enumerate(("bwd_dq", "bwd_dkv"))}


def flash_bf16_sets(dev, shape) -> list:
    """Input sets at one shape (enough to cycle past the L2), each with
    this checkout's K1 output and lse, the float32 delta and outputs."""
    B, H, Tq, Tk, D, causal, rate, ragged = shape
    one = B * H * (2 * Tq + 2 * Tk) * D * 2
    sets = []
    for i in range(max(2, math.ceil(2 * L2_BYTES / one))):
        x = flash_as(flash_inputs(dev, B, H, Tq, Tk, D, seed=60 + i),
                     torch.bfloat16)
        if not ragged:
            x["mask"] = None
        if rate == 0.0:
            x["seed"] = None
        x.update(causal=causal, rate=rate)
        x["out"], x["lse"] = A.flash_attention_fwd(
            x["q"], x["k"], x["v"], x["mask"], causal, None, rate, x["seed"])
        x["delta"] = A.flash_attention_delta(x["out"], x["do"])
        x["own_delta"] = torch.empty_like(x["delta"])
        for n, like in (("dq", "q"), ("dk", "k"), ("dv", "v")):
            x[n] = torch.empty_like(x[like])
        sets.append(x)
    return sets


def ab_flash_bwd_bf16(libs, dev) -> dict:
    res = {"occupancy": {t: {f"D{D}": flash_bf16_occupancy(lib, D, dev.index)
                             for D in (64, 128)}
                         for t, lib in libs.items()}}
    print(json.dumps(res["occupancy"]), flush=True)
    calls = {t: flash_bf16_calls(lib, t) for t, lib in libs.items()}
    for label, shape in FLASH_BF16_AB_SHAPES.items():
        B, H, Tq, Tk, D, causal, rate, _ = shape
        sets = flash_bf16_sets(dev, shape)
        s = sets[0]
        row = {"shape": list(shape), "input_sets": len(sets)}
        plain = B * H * Tq * Tk <= FLASH_BF16_AB_PLAIN_PAIRS
        if plain:
            want = A._bwd_ref(s["q"], s["k"], s["v"], s["mask"], s["lse"],
                              s["delta"], s["do"], causal, sm_scale_of(s["q"]),
                              rate, s["seed"], True, True)
        first = bits = None
        for who in libs:
            calls[who]["bwd"](s)
            torch.cuda.synchronize()
            got = tuple(s[n].clone() for n in ("dq", "dk", "dv"))
            if who == "this":
                row["this_delta_max_abs_diff"] = (
                    s["own_delta"] - s["delta"]).abs().max().item()
            if bits is None:
                bits = got
            row[f"{who}_bits_equal_first_build"] = all(
                torch.equal(g, b) for g, b in zip(got, bits))
            ref = want if plain else first
            if ref is None:
                first = got
                row[f"{who}_vs"] = "the reference for the others"
                continue
            e = max(((g.float() - r.float()).abs().max()
                     / r.float().abs().max()).item()
                    for g, r in zip(got, ref))
            row[f"{who}_max_rel_err"] = (
                repr(e) if math.isfinite(e) and e <= FLASH_BF16_REL
                else f"disagrees: {e}")
            row[f"{who}_vs"] = "plain bf16" if plain else "the first build"
        del s
        iters = 50 if Tq * Tk <= 1 << 20 else (20 if Tq * Tk <= 1 << 24 else 5)
        names = {"bwd_dq": "flash_bwd_dq_bf16_kernel",
                 "bwd_dkv": "flash_bwd_dkv_bf16_kernel", "bwd": None}
        for which, name in names.items():
            for who in turns(libs):
                ms = flash_ms(calls[who][which], sets, iters, name, row,
                              f"{who}_{which}")
                row.setdefault(f"{who}_{which}_ms", []).append(ms)
        work = flash_work(dict(sets[0], mask=sets[0]["mask"] if
                               sets[0]["mask"] is not None else
                               torch.ones(B, Tk, device=dev)), causal)
        row["bound_ms"] = {n: work[n]["bound_ms"] for n in ("bwd_dq",
                                                            "bwd_dkv")}
        row["ops"] = {n: work[n]["ops"] for n in ("bwd_dq", "bwd_dkv")}
        res[label] = row
        print(label, json.dumps(row), flush=True)
        del sets
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# K1 in bfloat16
# ---------------------------------------------------------------------------

# name: (B, H, Tq, Tk, D, causal, dropout rate, ragged key mask)
FLASH_FWD_BF16_AB_SHAPES = {
    "a_train": (32, 8, 256, 256, 64, False, 0.1, True),
    "a_train_causal": (32, 8, 256, 256, 64, True, 0.1, True),
    "b_long_h8_d64": (4, 8, 8192, 8192, 64, True, 0.0, False),
    "c_long_h4_d128": (4, 4, 8192, 8192, 128, True, 0.0, False),
    "d_ring_pair": (1, 4, 4096, 4096, 128, False, 0.1, True),
    "d_ring_diagonal": (1, 4, 4096, 4096, 128, True, 0.0, True),
}


def flash_fwd_call(lib, name="flash_attn_fwd_bf16"):
    """K1 of ``lib`` (its entry ``name``: bf16, or float32's
    ``flash_attn_fwd``) on an input set, into the set's out and lse."""
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = A._FWD_ARGS, ctypes.c_int

    def run(s):
        q, k = s["q"], s["k"]
        B, H, Tq, Tk, D, c, sl2, r, keep, bq, bk = A._common(
            q, k, s["causal"], sm_scale_of(q), s["rate"])
        err = fn(q.data_ptr(), k.data_ptr(), s["v"].data_ptr(),
                 A._ptr(s["mask"]), A._ptr(s["seed"]), s["out"].data_ptr(),
                 s["lse"].data_ptr(), B, H, Tq, Tk, D, c, sl2, r, keep, bq, bk,
                 q.device.index, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: cudaError {err}")
    return run


def flash_fwd_bf16_occupancy(lib, D: int, device: int):
    """The occupancy entry of a build that has one (this checkout's):
    {"no_dropout": ..., "dropout": ...} with OCC_KEYS and local bytes a
    thread; None for a build without it."""
    fn = getattr(lib, "flash_attn_fwd_bf16_occupancy", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 10)()
    err = fn(D, device, out)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_bf16_occupancy: cudaError {err}")
    keys = OCC_KEYS + ("local_bytes",)
    return {k: {key: out[5 * i + j] for j, key in enumerate(keys)}
            for i, k in enumerate(("no_dropout", "dropout"))}


def ab_flash_fwd_bf16(libs, dev) -> dict:
    import torch.nn.functional as F
    res = {"occupancy": {t: {f"D{D}": flash_fwd_bf16_occupancy(lib, D,
                                                               dev.index)
                             for D in (32, 64, 128)}
                         for t, lib in libs.items()}}
    print(json.dumps(res["occupancy"]), flush=True)
    calls = {t: flash_fwd_call(lib) for t, lib in libs.items()}
    for label, shape in FLASH_FWD_BF16_AB_SHAPES.items():
        B, H, Tq, Tk, D, causal, rate, ragged = shape
        sets = []
        one = B * H * (Tq + 2 * Tk) * D * 2
        for i in range(max(2, math.ceil(2 * L2_BYTES / one))):
            x = flash_as(flash_inputs(dev, B, H, Tq, Tk, D, seed=80 + i),
                         torch.bfloat16)
            if not ragged:
                x["mask"] = None
            if rate == 0.0:
                x["seed"] = None
            x.update(causal=causal, rate=rate, out=torch.empty_like(x["q"]),
                     lse=torch.empty(B * H, Tq, device=dev))
            # SDPA's mask: the key mask, and the causal triangle beside it
            # (without a key mask, is_causal)
            x["bias"] = x["mask"][:, None, None, :] > 0 if ragged else None
            if causal and ragged:
                x["bias"] = x["bias"] & torch.ones(
                    Tq, Tk, dtype=torch.bool, device=dev).tril()
            sets.append(x)
        s = sets[0]
        row = {"shape": list(shape), "input_sets": len(sets)}
        plain = B * H * Tq * Tk <= FLASH_BF16_AB_PLAIN_PAIRS
        args = (s["q"], s["k"], s["v"], s["mask"], causal, None, rate,
                s["seed"])
        if plain:
            want, want_lse = A.flash_attention_ref(*args)
            row["vs"] = "plain bf16"
        else:
            f32 = flash_as(s, torch.float32)
            want, want_lse = A.flash_attention_fwd(
                f32["q"], f32["k"], f32["v"], s["mask"], causal, None, rate,
                s["seed"])
            row["vs"] = "the float32 K1 on the same inputs"
        bar = FLASH_BF16_REL if plain else FLASH_BF16_VS_F32_REL
        mine = None
        for who in ["this"] + [w for w in libs if w != "this"]:
            calls[who](s)
            torch.cuda.synchronize()
            got = (s["out"].clone(), s["lse"].clone())
            if who == "this":
                mine = got
                calls[who](s)
                torch.cuda.synchronize()
                row["this_rerun_bit_for_bit"] = (
                    torch.equal(s["out"], got[0])
                    and torch.equal(s["lse"], got[1]))
            e = ((got[0].float() - want.float()).abs().max()
                 / want.float().abs().max()).item()
            row[f"{who}_max_rel_err"] = (repr(e) if math.isfinite(e)
                                         and e <= bar else f"disagrees: {e}")
            row[f"{who}_lse_max_abs_diff"] = (got[1] - want_lse).abs().max() \
                .item()
            row[f"{who}_bits_equal_this"] = (torch.equal(got[0], mine[0])
                                             and torch.equal(got[1], mine[1]))
        del want, want_lse
        iters = 50 if Tq * Tk <= 1 << 20 else (20 if Tq * Tk <= 1 << 24 else 5)
        for who in turns(libs):
            ms = flash_ms(calls[who], sets, iters, "flash_fwd_bf16_kernel",
                          row, who)
            row.setdefault(f"{who}_ms", []).append(ms)
        row["sdpa_ms"] = device_ms(
            lambda x: F.scaled_dot_product_attention(
                x["q"], x["k"], x["v"], attn_mask=x["bias"], dropout_p=rate,
                is_causal=causal and not ragged),
            sets, iters=iters)
        work = flash_work(dict(s, mask=s["mask"] if s["mask"] is not None
                               else torch.ones(B, Tk, device=dev)), causal)
        row.update(bound_ms=work["fwd"]["bound_ms"], ops=work["fwd"]["ops"],
                   bound_by=work["fwd"]["bound_by"])
        res[label] = row
        print(label, json.dumps(row), flush=True)
        del sets, s
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def paged_call(lib, this: bool):
    """The decode attention of ``lib`` (this checkout: its wrapper)."""
    if this:
        return lambda s: A.decode_attention(**s)
    fn = lib.paged_decode_attn
    fn.argtypes, fn.restype = PAGED_ONE_ARGS, ctypes.c_int

    def call(s):
        q = s["q"]
        S, H, D = q.shape
        out = torch.empty_like(q)
        quantized = "k_scale" in s
        err = fn(q.data_ptr(), s["k_cache"].data_ptr(), s["v_cache"].data_ptr(),
                 s["k_scale"].data_ptr() if quantized else None,
                 s["v_scale"].data_ptr() if quantized else None,
                 s["block_tables"].data_ptr(), s["context_lens"].data_ptr(),
                 out.data_ptr(), S, H, D, s["k_cache"].shape[1],
                 s["block_tables"].shape[1], int(quantized),
                 float(1.0 / math.sqrt(D)), q.device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"paged_decode_attn: cudaError {err}")
        return out
    return call


def ab_paged_decode(libs, dev) -> dict:
    res = {}
    calls = {who: paged_call(lib, who == "this") for who, lib in libs.items()}
    for dtype in ("float32", "int8"):
        for name in ("decode", "long"):
            shape = PAGED_SHAPES[name]
            q8 = dtype == "int8"
            one = paged_inputs(**shape, quantized=q8, seed=3, dev=dev)
            kv = sum(one[k].numel() * one[k].element_size()
                     for k in ("k_cache", "v_cache"))
            sets = [paged_inputs(**shape, quantized=q8, seed=10 + i, dev=dev)
                    for i in range(max(2, math.ceil(2 * L2_BYTES / kv)))]
            want = A.paged_attention_ref(**sets[0])
            row = {"this_splits": A.decode_splits(
                shape["S"], shape["H"], shape["D"], shape["bs"],
                shape["MB"], q8, dev), **work(one)}
            for who, call in calls.items():
                got = call(sets[0])
                torch.cuda.synchronize()
                row[f"{who}_max_abs_err"] = err_of([got], [want])
            for who in turns(libs):
                row.setdefault(f"{who}_ms", []).append(
                    device_ms(calls[who], sets, name=K4_KERNELS))
            res[f"{dtype}_{name}"] = row
            print(f"k4_{dtype}_{name}", json.dumps(row), flush=True)
            del sets, one, want
            torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def lstm_call(lib):
    fn = lib.lstm_fwd
    fn.argtypes, fn.restype = R._FWD_ARGS, ctypes.c_int

    def call(a):
        xproj, w, h0, c0, mask = a
        B, T, H4 = xproj.shape
        hs = torch.empty(B, T, H4 // 4, device=xproj.device)
        cs = torch.empty_like(hs)
        barrier = torch.empty(BARRIER_WORDS, dtype=torch.int32,
                              device=xproj.device)
        err = fn(xproj.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                 mask.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                 barrier.data_ptr(), B, T, H4 // 4, xproj.device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"lstm_fwd: error {err}")
        return hs, cs
    return call


def ab_lstm_fwd(libs, dev) -> dict:
    res = {}
    calls = {who: lstm_call(lib) for who, lib in libs.items()}
    B, T, H = LSTM_TIME_SHAPE
    for label, lo, h in (("ragged", LSTM_SHORTEST, H), ("full", None, H),
                         (f"ragged_h{LSTM_WIDE_H}", LSTM_SHORTEST,
                          LSTM_WIDE_H)):
        a = lstm_inputs(dev, B, T, h, seed=70, lo=lo)["args"]
        want = R.lstm_ref(*a)
        row = {"live_steps": int(a[4].sum().item())}
        for who, call in calls.items():
            got = call(a)
            torch.cuda.synchronize()
            row[f"{who}_max_abs_err"] = err_of(got, want)
        for who in turns(libs):
            row.setdefault(f"{who}_ms", []).append(
                device_ms(calls[who], [a], 20, name="lstm_fwd"))
        res[label] = row
        print(f"k6_{label}", json.dumps(row), flush=True)
    return res


# ---------------------------------------------------------------------------
# K8a
# ---------------------------------------------------------------------------

def gru_fwd_call(lib):
    fn = lib.gru_fwd
    fn.argtypes, fn.restype = R._GRU_FWD_ARGS, ctypes.c_int

    def call(a):
        xproj, w, h0, mask = a
        B, T, H3 = xproj.shape
        hs = torch.empty(B, T, H3 // 3, device=xproj.device)
        rh = torch.empty(B, H3 // 3, device=xproj.device)
        barrier = torch.empty(BARRIER_WORDS, dtype=torch.int32,
                              device=xproj.device)
        err = fn(xproj.data_ptr(), w.data_ptr(), h0.data_ptr(),
                 mask.data_ptr(), hs.data_ptr(), rh.data_ptr(),
                 barrier.data_ptr(), B, T, H3 // 3, xproj.device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"gru_fwd: error {err}")
        return hs
    return call


def ab_gru_fwd(libs, dev) -> dict:
    res = {}
    calls = {who: gru_fwd_call(lib) for who, lib in libs.items()}
    B, T, H = GRU_TIME_SHAPE
    for label, lo, h in (("ragged", MT_SHORTEST, H), ("full", None, H),
                         ("wide_ragged", MT_SHORTEST, GRU_WIDE_H)):
        a = gru_inputs(dev, B, T, h, seed=80, lo=lo)["args"]
        want = R.gru_ref(*a)
        row = {"live_steps": int(a[3].sum().item())}
        takes = {}
        for who, call in calls.items():
            try:
                got = call(a)
            except RuntimeError as e:   # a build that does not take H
                row[f"{who}_refused"] = str(e)
                continue
            torch.cuda.synchronize()
            takes[who] = libs[who]
            row[f"{who}_max_abs_err"] = err_of([got], [want])
        for who in turns(takes) or ["this", "this"]:
            row.setdefault(f"{who}_ms", []).append(
                device_ms(calls[who], [a], 20, name="gru_fwd"))
        res[label] = row
        print(f"k8a_{label}", json.dumps(row), flush=True)
    return res


# ---------------------------------------------------------------------------
# K8b
# ---------------------------------------------------------------------------

def gru_bwd_call(lib):
    fn = lib.gru_bwd
    fn.argtypes, fn.restype = R._GRU_BWD_ARGS, ctypes.c_int
    words = 1
    if hasattr(lib, "gru_bwd_sync_words"):
        words = lib.gru_bwd_sync_words
        words.argtypes, words.restype = [ctypes.c_int] * 2, ctypes.c_int

    def call(s):
        xproj, w, h0, mask = s["args"]
        B, T, H3 = xproj.shape
        H = H3 // 3
        dx, dw, dh0 = (torch.empty_like(xproj), torch.empty_like(w),
                       torch.empty_like(h0))
        rh = torch.empty(B, T, H, device=xproj.device)
        n = words if isinstance(words, int) else words(B, H)
        barrier = torch.empty(n, dtype=torch.int32, device=xproj.device)
        err = fn(xproj.data_ptr(), w.data_ptr(), h0.data_ptr(),
                 mask.data_ptr(), s["hs"].data_ptr(), s["dhs"].data_ptr(),
                 dx.data_ptr(), dw.data_ptr(), dh0.data_ptr(), rh.data_ptr(),
                 barrier.data_ptr(), B, T, H, xproj.device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"gru_bwd: error {err}")
        return dx, dw, dh0
    return call


def ab_gru_bwd(libs, dev) -> dict:
    res = {}
    calls = {who: gru_bwd_call(lib) for who, lib in libs.items()}
    B, T, H = GRU_TIME_SHAPE
    for label, lo, h in (("ragged", MT_SHORTEST, H), ("full", None, H),
                         ("wide_ragged", MT_SHORTEST, GRU_WIDE_H)):
        s = gru_inputs(dev, B, T, h, seed=80, lo=lo)
        s["hs"] = R.gru_ref(*s["args"])
        want = R.gru_grad_ref(*s["args"], s["hs"], s["dhs"])
        row = {"live_steps": int(s["args"][3].sum().item())}
        takes = {}
        for who, call in calls.items():
            try:
                got = call(s)
            except RuntimeError as e:   # a build that does not take H
                row[f"{who}_refused"] = str(e)
                continue
            torch.cuda.synchronize()
            takes[who] = libs[who]
            row[f"{who}_max_abs_err"] = err_of(got, want)
        # this build twice when no other takes the shape
        for who in turns(takes) or ["this", "this"]:
            row.setdefault(f"{who}_ms", []).append(
                device_ms(calls[who], [s], 20, name="gru_bwd"))
        for who, lib in takes.items():
            if hasattr(lib, "gru_bwd_sync_words"):
                row[f"{who}_launch_ms"] = device_ms_by_name(
                    calls[who], [s], 20, K8B_LAUNCHES)
        res[label] = row
        print(f"k8b_{label}", json.dumps(row), flush=True)
    return res


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

# the K10 entry point before the sort was shared: sparse_update(kind,
# rows int64, sorted values, first, last, n, d, p, a, b, lr, h1, h2, h3,
# flag, device, stream)
PARENT_UPDATE_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_float] * 3
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def parent_update(lib):
    """Adam through ``lib``'s K10 behind the wrapper it had before the
    sort was shared: (sort, kernel) for one table, the sort making the
    stable int64 sort, the sorted copy of the values and the run flags."""
    fn = lib.sparse_update
    fn.argtypes, fn.restype = PARENT_UPDATE_ARGS, ctypes.c_int
    hyper = SPARSE_HYPER["adam"]

    def sort(rows, vals, H):
        rows = torch.where(rows < 0, rows + H, rows).clamp(0, H - 1)
        r, order = torch.sort(rows.to(torch.int64), stable=True)
        neq = r[1:] != r[:-1]
        one = torch.ones(1, dtype=torch.bool, device=r.device)
        return (r, vals[order].contiguous(), torch.cat([one, neq]),
                torch.cat([neq, one]))

    def kernel(segs, tables, lr):
        r, v, first, last = segs
        err = fn(0, r.data_ptr(), v.data_ptr(), first.data_ptr(),
                 last.data_ptr(), r.shape[0], v.shape[1],
                 *[t.data_ptr() for t in tables], lr.data_ptr(),
                 hyper["beta1"], hyper["beta2"], hyper["eps"], 0,
                 r.device.index, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"sparse_update: error {err}")
    return sort, kernel


def this_update():
    """(sort, kernel) of this checkout: ``sorted_segments`` and K10
    through ``rowwise_update_sorted``."""
    hyper = SPARSE_HYPER["adam"]

    def sort(rows, vals, H):
        return (*S.sorted_segments(rows, H), vals)

    def kernel(segs, tables, lr):
        S.rowwise_update_sorted(*segs, tables, lr, "adam", **hyper)
    return sort, kernel


def ab_sparse_update(libs, dev) -> dict:
    res = {}
    hyper = SPARSE_HYPER["adam"]
    H, D = SPARSE_ROWS, SPARSE_EMBED
    fns = {who: this_update() if who == "this" else parent_update(lib)
           for who, lib in libs.items()}
    g = torch.Generator(device=dev).manual_seed(21)
    lr = torch.tensor(1e-4, device=dev)
    widths = {"emb": D, "w1": 1}
    tables = {n: update_tables("adam", H, w, g) for n, w in widths.items()}
    n_ids = DEEPFM_B * SPARSE_FIELDS
    feeds = {"bench": lambda i: sparse_ids(100 + i).reshape(-1),
             "skewed": lambda i: zipf_ids(n_ids, H, 300 + i)}
    for label, make in feeds.items():
        ids = [torch.tensor(make(i), device=dev)
               for i in range(SPARSE_TIME_SETS)]
        vals = {n: [torch.randn(n_ids, w, generator=g, device=dev) * 1e-3
                    for _ in ids] for n, w in widths.items()}
        idx = list(range(SPARSE_TIME_SETS))
        row = {"unique_rows": int(torch.unique(ids[0]).numel()),
               "hot_share": int(torch.unique(ids[0], return_counts=True)[1]
                                .max().item()) / n_ids}
        for who, (sort, kernel) in fns.items():   # bit for bit on set 0
            ok = True
            for n in widths:
                got = [t.clone() for t in tables[n]]
                kernel(sort(ids[0], vals[n][0], H), got, lr)
                want = [t.clone() for t in tables[n]]
                S.rowwise_update_ref(*S.sorted_segments(ids[0], H),
                                     vals[n][0], want, lr, "adam", **hyper)
                torch.cuda.synchronize()
                ok = ok and all(bits_equal(a, b) for a, b in zip(got, want))
            row[f"{who}_bit_equal"] = ok
        for who in turns(libs):
            sort, kernel = fns[who]
            for n in widths:   # the kernel alone, on sorted inputs
                segs = [sort(x, v, H) for x, v in zip(ids, vals[n])]
                row.setdefault(f"{who}_{n}_kernel_ms", []).append(device_ms(
                    lambda i: kernel(segs[i], tables[n], lr), idx,
                    name="sparse_update"))
                del segs
            # what the step sorts: the ids (and, for another checkout, the
            # sorted copy of the [1e6, 10] table's values and the flags)
            row.setdefault(f"{who}_sort_ms", []).append(device_ms(
                lambda i: sort(ids[i], vals["emb"][i], H), idx))
            if who == "this":   # one sort, shared through the run's memo
                def step(i):
                    memo = {}
                    for n in widths:
                        S.rowwise_update(SelectedRows(ids[i], vals[n][i], H),
                                         tables[n], lr, "adam", memo, **hyper)
            else:               # a sort each
                def step(i):
                    for n in widths:
                        kernel(sort(ids[i], vals[n][i], H), tables[n], lr)
            row.setdefault(f"{who}_step_ms", []).append(device_ms(step, idx))
        res[label] = row
        print(f"k10_{label}", json.dumps(row), flush=True)
        del ids, vals
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

# the first version's K9 entry point: sparse_gather(k, ids int64, n,
# table[4], out[4], height[4], width[4], device, stream)
PARENT_GATHER_ARGS = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
                      + [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4
                      + [ctypes.c_int] * 4 + [ctypes.c_int, ctypes.c_void_p])
# the cases: the tables' widths (each [SPARSE_ROWS, width]) and the ids
GATHER_AB_CASES = {
    "bench": ((SPARSE_EMBED, 1), "bench"),
    "bench_int32": ((SPARSE_EMBED, 1), "int32"),
    "skewed": ((SPARSE_EMBED, 1), "skewed"),
    "four_tables": ((SPARSE_EMBED, 1, 3, 16), "bench"),
    "d64": ((64,), "bench"),
}


def packed_entry(who: str) -> bool:
    """Whether build ``who``'s K9 takes one packed argument block (its
    source defines ``GatherParams``); else it has the first version's
    21-argument entry."""
    if who == "this":
        return True
    with open(SOURCES[who]) as f:
        return "GatherParams" in f.read()


def parent_gather(lib):
    """K9 of ``lib`` through the first version's entry point, behind a
    copy of the wrapper it had: the checks on every table, the ids
    flattened and made int64, a ``torch.empty`` a table, the stream
    object, the 21-argument call, the counters, the reshape."""
    fn = lib.sparse_gather
    fn.argtypes, fn.restype = PARENT_GATHER_ARGS, ctypes.c_int
    counter = stats.scope("kernel_ab").counter("parent_gather_launches")

    def call(tables, ids):
        if ids.device.type == "cpu":
            raise ValueError("cpu")
        if ids.device.type != "cuda":
            raise ValueError(f"unsupported device {ids.device}")
        if not 1 <= len(tables) <= 4:
            raise ValueError("1..4 tables")
        if ids.dtype not in (torch.int32, torch.int64):
            raise TypeError("ids must be int32/int64")
        for i, t in enumerate(tables):
            if t.device != ids.device:
                raise ValueError(f"table {i} is on {t.device}")
            if t.dtype != torch.float32 or t.dim() != 2:
                raise TypeError(f"table {i} must be a 2-D float32 tensor")
            if not t.is_contiguous() or t.shape[0] < 1:
                raise ValueError(f"table {i} must be contiguous, non-empty")
        flat = ids.reshape(-1).to(torch.int64).contiguous()
        n = flat.shape[0]
        outs = [torch.empty((n, t.shape[1]), dtype=t.dtype, device=t.device)
                for t in tables]
        if n:
            pad = 4 - len(tables)
            stream = torch.cuda.current_stream(ids.device).cuda_stream
            err = fn(len(tables), flat.data_ptr(), n,
                     *[t.data_ptr() for t in tables], *[None] * pad,
                     *[o.data_ptr() for o in outs], *[None] * pad,
                     *[t.shape[0] for t in tables], *[0] * pad,
                     *[t.shape[1] for t in tables], *[0] * pad,
                     ids.device.index, stream)
            if err != 0:
                raise RuntimeError(f"sparse_gather: cudaError {err}")
            call.launches += 1
            counter.inc()
        return [o.reshape(tuple(ids.shape) + (o.shape[1],)) for o in outs]
    call.launches = 0
    return call


def packed_gather(lib):
    """K9 of ``lib`` through a packed-block entry, behind this
    checkout's allocation and packing."""
    fn = lib.sparse_gather
    fn.argtypes, fn.restype = S._GATHER_ARGS, ctypes.c_int

    def call(tables, ids):
        widths = [t.shape[1] for t in tables]
        outs = [ids.new_empty((*ids.shape, d), dtype=torch.float32)
                for d in widths]
        err = fn(S.gather_params(ids, ids.numel(), tables, outs,
                                 [t.shape[0] for t in tables], widths,
                                 ids.get_device()),
                 _build.current_stream(ids))
        if err != 0:
            raise RuntimeError(f"sparse_gather: cudaError {err}")
        return outs
    return call


def host_us(fn, iters=20000) -> float:
    """Host microseconds per call of ``fn``: the least of three loops."""
    best = math.inf
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t) / iters * 1e6)
    torch.cuda.synchronize()
    return best


def launch_pieces(dev, libs) -> dict:
    """Host microseconds a call of K9's launch paths and of their
    pieces, at the bench batch on DeepFM's two tables: this checkout's
    path, the first version's (for each build with its entry) and
    ``F.embedding`` on each table.  A piece that launches counts its
    launch, not its device time."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(5)
    tables = [torch.randn(SPARSE_ROWS, w, generator=g, device=dev)
              for w in (SPARSE_EMBED, 1)]
    ids = torch.tensor(sparse_ids(7), device=dev)
    ids32 = ids.to(torch.int32)
    n = ids.numel()
    heights = [t.shape[0] for t in tables]
    widths = [t.shape[1] for t in tables]
    shapes = [tuple(ids.shape) + (d,) for d in widths]
    outs = [torch.empty(s, device=dev) for s in shapes]
    idx = ids.get_device()
    fn = S._kernel_fn(S._GATHER, S._GATHER_ARGS)
    # an empty batch returns before any CUDA call: the ctypes call alone
    empty = S._GATHER_PARAMS.pack(*[0] * 18, 1, 8, 0, 0)
    full = S.gather_params(ids, n, tables, outs, heights, widths, idx)
    stream = _build.current_stream(ids)
    pieces = {
        "this_fused_gather": lambda: S.fused_gather(tables, ids),
        "this_new_empty_a_table": lambda: [
            ids.new_empty(s, dtype=torch.float32) for s in shapes],
        "this_pack_params": lambda: S.gather_params(
            ids, n, tables, outs, heights, widths, idx),
        "this_current_stream": lambda: _build.current_stream(ids),
        "this_ctypes_2_args": lambda: fn(empty, 0),
        "this_ctypes_launch": lambda: fn(full, stream),
        "f_embedding_x2": lambda: [F.embedding(ids, t) for t in tables],
    }
    first = [(who, lib) for who, lib in libs.items() if not packed_entry(who)]
    if first:   # the first version's pieces, which the redesign cut
        pieces.update({
            "first_flatten_int64": lambda: ids.reshape(-1).to(
                torch.int64).contiguous(),
            "first_flatten_int32_to_int64": lambda: ids32.reshape(-1).to(
                torch.int64).contiguous(),
            "first_empty_a_table": lambda: [
                torch.empty((n, d), dtype=torch.float32, device=dev)
                for d in widths],
            "first_stream_object": lambda: torch.cuda.current_stream(
                ids.device).cuda_stream,
            "first_reshape_outputs": lambda: [
                o.reshape(s) for o, s in zip(outs, shapes)],
        })
    for who, lib in first:
        call = parent_gather(lib)
        f = lib.sparse_gather
        pieces[f"{who}_wrapper"] = lambda c=call: c(tables, ids)
        pieces[f"{who}_ctypes_21_args"] = lambda f=f: f(
            2, 0, 0, 0, 0, None, None, 0, 0, None, None, 1, 1, 0, 0,
            10, 1, 0, 0, 0, 0)
        pieces[f"{who}_ctypes_launch"] = lambda f=f: f(
            2, ids.data_ptr(), n, *[t.data_ptr() for t in tables], None,
            None, *[o.data_ptr() for o in outs], None, None, *heights, 0, 0,
            *widths, 0, 0, idx, stream)
    return {name: host_us(piece) for name, piece in pieces.items()}


def l2_flushed(fn, dev, ids_in_l2=False):
    """``fn`` behind a read of four times the L2 (a sum over a buffer),
    so the rows and ids it reads come from device memory; with
    ``ids_in_l2`` a sum over the ids then reads them back into the L2,
    as the copy that brings a step's ids to the card leaves them.  The
    reads are kernels of their own, which ``device_ms(..., name=)``
    leaves out."""
    buf = torch.ones(L2_BYTES, device=dev)

    def call(x):
        buf.sum()
        if ids_in_l2:
            x.sum()
        return fn(x)
    return call


def ab_sparse_gather(libs, dev) -> dict:
    import torch.nn.functional as F
    res = {"pieces_us": launch_pieces(dev, libs)}
    print("k9_pieces_us", json.dumps(res["pieces_us"]), flush=True)
    calls = {who: S.fused_gather if who == "this" else packed_gather(lib)
             if packed_entry(who) else parent_gather(lib)
             for who, lib in libs.items()}
    g = torch.Generator(device=dev).manual_seed(22)
    n_ids = DEEPFM_B * SPARSE_FIELDS
    feeds = {"bench": lambda i: torch.tensor(sparse_ids(100 + i), device=dev),
             "skewed": lambda i: torch.tensor(zipf_ids(n_ids, SPARSE_ROWS,
                                                       300 + i), device=dev)}
    feeds["int32"] = lambda i: feeds["bench"](i).to(torch.int32)
    tables = {}   # width: a [SPARSE_ROWS, width] table
    for label, (widths, feed) in GATHER_AB_CASES.items():
        for w in widths:
            if w not in tables:
                tables[w] = torch.randn(SPARSE_ROWS, w, generator=g,
                                        device=dev)
        tabs = [tables[w] for w in widths]
        ids = [feeds[feed](i) for i in range(SPARSE_TIME_SETS)]
        row = {"widths": list(widths), "ids": str(ids[0].dtype),
               **gather_work(tabs, ids[0])}
        want = S.fused_gather_ref(tabs, ids[0])
        for who, call in calls.items():
            got = call(tabs, ids[0])
            torch.cuda.synchronize()
            row[f"{who}_bit_equal"] = all(bits_equal(a, b)
                                          for a, b in zip(got, want))
        lib = lambda x: [F.embedding(x, t) for t in tabs]  # noqa: E731
        row["library_ms"] = device_ms(lib, ids)
        row["library_wall_ms"] = time_ms(lib, ids)
        for who in turns(libs):
            fn = lambda x: calls[who](tabs, x)  # noqa: E731
            # the kernel alone: rows and ids from device memory (the L2
            # read over before each call), rows from device memory and
            # ids from L2, then with only the id batches cycled, as a
            # step's other kernels may leave rows in L2
            row.setdefault(f"{who}_ms", []).append(device_ms(
                l2_flushed(fn, dev), ids, name="sparse_gather"))
            row.setdefault(f"{who}_ids_in_l2_ms", []).append(device_ms(
                l2_flushed(fn, dev, ids_in_l2=True), ids,
                name="sparse_gather"))
            row.setdefault(f"{who}_warm_ms", []).append(
                device_ms(fn, ids, name="sparse_gather"))
            row.setdefault(f"{who}_call_ms", []).append(device_ms(fn, ids))
            row.setdefault(f"{who}_wall_ms", []).append(time_ms(fn, ids))
        res[label] = row
        print(f"k9_{label}", json.dumps(row), flush=True)
        del ids, want
    del tables
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def int8_fc_call(lib):
    """K5 of ``lib`` on a quantized input set (xq, sx, w_q, w_t, w_scale,
    bias) with the act ``act``."""
    fn = lib.int8_fc
    kmajor = hasattr(lib, "int8_fc_config")
    fn.argtypes = Q._ARGS
    fn.restype = ctypes.c_int

    def call(s, act):
        xq, sx, w_q, w_t, w_scale, b = s
        M, K = xq.shape
        N = w_q.shape[1]
        out = torch.empty(M, N, device=xq.device)
        err = fn(xq.data_ptr(), (w_t if kmajor else w_q).data_ptr(),
                 w_scale.data_ptr(), sx.data_ptr(), b.data_ptr(),
                 out.data_ptr(), M, N, K, Q._EPILOGUE_ACTS[act],
                 xq.device.index, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"int8_fc: error {err}")
        return out
    return call


def ab_int8_fc(libs, dev) -> dict:
    res = {}
    calls = {who: int8_fc_call(lib) for who, lib in libs.items()}
    for i, (name, (M, K, N, act)) in enumerate(INT8_SHAPES.items()):
        per_set = M * K + 2 * K * N
        n_sets = max(2, min(32, -(-3 * L2_BYTES // per_set)))
        sets = []
        for j in range(n_sets):
            x, q, s, b = int8_case(dev, M, K, N, seed=120 + 40 * i + j)
            xq, sx = Q._quantize_act(x, 0.0)
            sets.append((xq, sx, q, q.t().contiguous(), s, b))
            del x
        x0, q0, s0, b0 = int8_case(dev, M, K, N, seed=120 + 40 * i)
        want = Q.int8_fc_plain(x0, q0, s0, 0.0, b0, act)
        row = {}
        for who, call in calls.items():
            got = call(sets[0], act)
            torch.cuda.synchronize()
            row[f"{who}_bit_equal"] = bool(torch.equal(got, want))
        idx = list(range(n_sets))
        for who in turns(libs):
            row.setdefault(f"{who}_ms", []).append(device_ms(
                lambda k: calls[who](sets[k], act), idx, 20,
                name="int8_fc_kernel"))
        res[name] = row
        print(f"k5_{name}", json.dumps(row), flush=True)
        del sets, want
        torch.cuda.empty_cache()
    res["dispatch_sum"] = {
        who: sum(min(res[n][f"{who}_ms"]) * INT8_DISPATCH_SHAPES[n]
                 for n in INT8_SHAPES) for who in libs}
    print("k5_dispatch_sum", json.dumps(res["dispatch_sum"]), flush=True)
    return res


# ---------------------------------------------------------------------------
# K11: the ring in bfloat16
# ---------------------------------------------------------------------------

def load_kernels(src_dir: str, tag: str):
    """The ``attention`` module of another checkout's kernels package
    (``<src_dir>/paddle_tpu_torch/kernels``), imported as the package
    ``<tag>_kernels``: its relative imports stay inside it, and its
    ``_build`` builds its own sources into its own ``build/``."""
    import importlib
    import importlib.util
    path = os.path.join(os.path.abspath(src_dir), "paddle_tpu_torch",
                        "kernels")
    name = f"{tag}_kernels"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    SOURCES[tag] = path
    return importlib.import_module(f"{name}.attention")


def ring_bodies(mod, x, devices, causal, rate):
    """(forward, backward) of ``mod``'s ring, ``RingAttentionFn``'s two
    bodies: the hop route where the module has one, else the
    pair-by-pair walk over its K1-K3 wrappers."""
    q, k, v, m, seed, do = (x[n] for n in ("q", "k", "v", "mask", "seed",
                                           "do"))
    sm = sm_scale_of(q)
    args = (m, seed, devices, causal, sm, rate)
    if hasattr(mod, "_ring_hop_forward"):
        def fwd(_):
            return mod._ring_hop_forward(q, k, v, *args)
        saved = fwd(None)

        def bwd(_):
            return mod._ring_hop_backward(q, k, v, m, seed, *saved, do,
                                          devices, causal, sm, rate)
    else:
        def fwd(_):
            return mod._ring_forward(q, k, v, *args, mod.flash_attention_fwd)
        saved = fwd(None)

        def bwd(_):
            return mod._ring_backward(q, k, v, m, seed, *saved, do, devices,
                                      causal, sm, rate,
                                      mod.flash_attention_bwd_dq,
                                      mod.flash_attention_bwd_dkv)
    return fwd, bwd


def ab_ring(mods, dev, dtype=torch.bfloat16) -> dict:
    devices = (dev,) * RING_SP
    kn = flash_kernel_names(dtype)
    res = {}
    for label, causal, rate in (("full_dropout", False, 0.1),
                                ("causal", True, 0.0)):
        x = flash_as(ring_inputs(dev, seed=70), dtype)
        row, outs = {}, {}
        for who, mod in mods.items():
            leaves = [x[n].clone().requires_grad_(True)
                      for n in ("q", "k", "v")]
            o = mod.ring_attention(*leaves, x["mask"], list(devices), causal,
                                   None, rate, x["seed"])
            outs[who] = (o.detach(),) + torch.autograd.grad(o, leaves,
                                                            x["do"])
            torch.cuda.synchronize()
        for who in mods:
            row[f"{who}_max_abs_err_vs_this"] = err_of(outs[who],
                                                       outs["this"])
            row[f"{who}_bit_equal_this"] = all(
                torch.equal(a, b) for a, b in zip(outs[who], outs["this"]))
        del outs
        for who in turns(mods):
            mod = mods[who]
            fwd, bwd = ring_bodies(mod, x, devices, causal, rate)
            # each kernel's launches a call: a session short of them lost
            # records (device_ms_by_name's expect)
            n0 = (mod.flash_attention_fwd.launches,
                  mod.flash_attention_bwd_dq.launches)
            fwd(None)
            bwd(None)
            n_fwd = mod.flash_attention_fwd.launches - n0[0]
            n_bwd = mod.flash_attention_bwd_dq.launches - n0[1]
            t = {"fwd_event_ms": time_ms(fwd, [None], iters=10),
                 "bwd_event_ms": time_ms(bwd, [None], iters=10)}
            t["total_event_ms"] = t["fwd_event_ms"] + t["bwd_event_ms"]
            try:
                kf = device_ms_by_name(fwd, [None], 3, [None, kn["fwd"]],
                                       {kn["fwd"]: n_fwd})
                kb = device_ms_by_name(bwd, [None], 3,
                                       [None, kn["bwd_dq"], kn["bwd_dkv"]],
                                       {kn["bwd_dq"]: n_bwd,
                                        kn["bwd_dkv"]: n_bwd})
                t.update(fwd_ms=kf[None], fwd_kernel_ms=kf[kn["fwd"]],
                         bwd_ms=kb[None],
                         bwd_kernel_ms=kb[kn["bwd_dq"]] + kb[kn["bwd_dkv"]])
                t["rest_ms"] = (t["fwd_ms"] - t["fwd_kernel_ms"]
                                + t["bwd_ms"] - t["bwd_kernel_ms"])
                t["total_ms"] = t["fwd_ms"] + t["bwd_ms"]
            except AssertionError as e:   # the profiler lost the records
                print(f"  {who} {label}: {e}; CUDA events only", flush=True)
            for key, val in t.items():
                row.setdefault(f"{who}_{key}", []).append(val)
            del fwd, bwd
            torch.cuda.empty_cache()
        res[label] = row
        print(label, json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()
    return res


# kernel: (csrc source, its A/B, the shim for sources without a query)
KERNELS = {
    "flash_bwd": ("flash_attn_bwd", ab_flash_bwd,
                  ("flash_attn_bwd_occupancy", FLASH_SHIM)),
    "flash_fwd": ("flash_attn_fwd", ab_flash_fwd, None),
    "flash_bwd_bf16": ("flash_attn_bwd_bf16", ab_flash_bwd_bf16, None),
    "flash_fwd_bf16": ("flash_attn_fwd_bf16", ab_flash_fwd_bf16, None),
    "paged_decode": ("paged_decode_attn", ab_paged_decode, None),
    "lstm_fwd": ("lstm_fwd", ab_lstm_fwd, None),
    "gru_fwd": ("gru_fwd", ab_gru_fwd, None),
    "gru_bwd": ("gru_bwd", ab_gru_bwd, None),
    "sparse_update": ("sparse_update", ab_sparse_update, None),
    "sparse_gather": ("sparse_gather", ab_sparse_gather, None),
    "int8_fc": ("int8_fc", ab_int8_fc, None),
    # the ring's whole kernels package, not one source
    "ring_bf16": (None, ab_ring, None),
    "ring_f32": (None, lambda mods, dev: ab_ring(mods, dev, torch.float32),
                 None),
}


def main() -> int:
    kernels = sys.argv[1].split(",") if len(sys.argv) > 1 else []
    if (not torch.cuda.is_available() or len(sys.argv) < 3 or not kernels
            or any(k not in KERNELS for k in kernels)):
        print(f"usage: kernel_ab.py <{'|'.join(KERNELS)}>[,...] "
              "<other checkout> ... (on a CUDA card)", file=sys.stderr)
        return 1
    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    res = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        for kernel in kernels:
            src, run, shim = KERNELS[kernel]
            libs = {"this": A if src is None else _build.load(src)}
            for i, d in enumerate(sys.argv[2:]):
                tag = f"other{i}_{os.path.basename(os.path.normpath(d))}"
                libs[tag] = (load_kernels(d, tag) if src is None else
                             build_other(d, tmp, tag, src, shim))
            res[kernel] = run(libs, dev)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
