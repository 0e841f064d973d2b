#!/usr/bin/env python3
"""K2/K3 (``csrc/flash_attn_bwd.cu``) of this checkout against those of
other checkouts of the repository, on one CUDA card, in one process.

    git archive <commit> paddle_tpu_torch/kernels/csrc | tar -x -C <dir>
    python3 flash_bwd_ab.py <dir> [<dir> ...]

Every source keeps the same C interface.  One that has no occupancy
query of its own (PR 2's kernels, templates in an anonymous namespace)
is compiled with a small shim that includes it and reports its
kernels' registers, shared memory and resident blocks an SM.  At the
bench shape (B=32, H=8, T=256, D=64, ragged key masks) each kernel is
checked against this checkout's plain version (a disagreement is
reported, not raised, so a variant built to find where the time goes
can be timed too) and its device time taken (the torch profiler, as
``chip_smoke.py``'s ``device_ms``) in turns, other, this, this, other,
for dropout 0.1 (not causal and causal) and rate 0.  One JSON line at
the end; run on a card, it fails without one.
"""
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from chip_smoke import (FLASH_GRAD_TOL, FLASH_TIME_SHAPE, L2_BYTES,  # noqa: E402
                        device_ms, flash_inputs, nvidia_smi_line, worst)
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import attention as A  # noqa: E402

# PR 2's kernels at D=64: LPR = 2 lanes a row, 128 threads
SHIM = r"""
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

KEYS = ("registers", "static_smem", "dynamic_smem", "blocks_per_sm")


def build_other(src_dir: str, out_dir: str, tag: str):
    src = os.path.join(os.path.abspath(src_dir), "paddle_tpu_torch", "kernels",
                       "csrc", "flash_attn_bwd.cu")
    with open(src) as f:
        has_query = "flash_attn_bwd_occupancy" in f.read()
    if not has_query:
        shim = os.path.join(out_dir, f"{tag}_shim.cu")
        with open(shim, "w") as f:
            f.write(SHIM % src)
        src = shim
    lib = os.path.join(out_dir, f"lib{tag}_bwd.so")
    log = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{log.stdout}{log.stderr}")
    return ctypes.CDLL(lib), log.stdout + log.stderr


def occupancy(lib, device: int) -> dict:
    fn = lib.flash_attn_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    err = fn(64, 256, 256, device, out)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_occupancy: cudaError {err}")
    return {k: {key: out[4 * i + j] for j, key in enumerate(KEYS)}
            for i, k in enumerate(("bwd_dq", "bwd_dkv"))}


def bind(lib):
    dq = lib.flash_attn_bwd_dq
    dq.argtypes, dq.restype = A._DQ_ARGS, ctypes.c_int
    dkv = lib.flash_attn_bwd_dkv
    dkv.argtypes, dkv.restype = A._DKV_ARGS, ctypes.c_int
    return dq, dkv


def call(fns, which: str, s, causal, rate):
    """One launch of K2 or K3 from ``fns`` on input set ``s``."""
    q, k, v = s["q"], s["k"], s["v"]
    B, H, Tq, Tk, D, c, sl2, r, keep, bq, bk = A._common(q, k, causal,
                                                          D_SCALE(q), rate)
    stream = torch.cuda.current_stream().cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), s["mask"].data_ptr(),
              s["seed"].data_ptr(), s["do"].data_ptr(), s["lse"].data_ptr(),
              s["delta"].data_ptr())
    if which == "bwd_dq":
        err = fns[0](*common, s["dq"].data_ptr(), B, H, Tq, Tk, D, c, sl2,
                     D_SCALE(q), r, keep, bq, bk, q.device.index, stream)
    else:
        err = fns[1](*common, s["dk"].data_ptr(), s["dv"].data_ptr(), B, H,
                     Tq, Tk, D, c, sl2, D_SCALE(q) / sl2, r, keep, bq, bk,
                     q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{which}: cudaError {err}")


def D_SCALE(q) -> float:
    return float(1.0 / math.sqrt(q.shape[-1]))


def check(s, want) -> str:
    """max |kernel - plain| over dq, dk, dv, or why they disagree."""
    try:
        return repr(max(worst(s[n], w, FLASH_GRAD_TOL)
                        for n, w in zip(("dq", "dk", "dv"), want)))
    except AssertionError as e:
        return f"disagrees: {e}"


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("usage: flash_bwd_ab.py <other checkout> ... (on a CUDA card)",
              file=sys.stderr)
        return 1
    card = nvidia_smi_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    libs = {"this": _build.load("flash_attn_bwd")}
    _build.load("flash_attn_fwd")
    with tempfile.TemporaryDirectory() as tmp:
        for i, d in enumerate(sys.argv[1:]):
            tag = f"other{i}_{os.path.basename(os.path.normpath(d))}"
            libs[tag], log = build_other(d, tmp, tag)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {tag}:", line.strip(), flush=True)
        res = {"card": card,
               "occupancy": {t: occupancy(lib, dev.index)
                             for t, lib in libs.items()}}
        print(json.dumps(res["occupancy"]), flush=True)
        fns = {t: bind(lib) for t, lib in libs.items()}
        others = [t for t in libs if t != "this"]
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
                s["q"], s["k"], s["v"], s["mask"], s["out"], s["lse"],
                s["do"], causal, None, rate, s["seed"], delta=s["delta"])
            row = {}
            for who in libs:
                for which in ("bwd_dq", "bwd_dkv"):
                    call(fns[who], which, s, causal, rate)
                torch.cuda.synchronize()
                row[f"{who}_max_abs_err"] = check(s, want)
            for which in ("bwd_dq", "bwd_dkv"):
                for who in [w for o in others for w in (o, "this", "this", o)]:
                    ms = device_ms(lambda x: call(fns[who], which, x, causal,
                                                  rate), sets, iters=50,
                                   name=f"flash_{which}_kernel")
                    row.setdefault(f"{who}_{which}_ms", []).append(ms)
            res[label] = row
            print(label, json.dumps(row), flush=True)
            del sets
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
