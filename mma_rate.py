#!/usr/bin/env python3
"""The rate of ``mma.sync`` products on one CUDA card: m16n8k8 TF32, the
instruction the split-TF32 kernels (K1, K2, K3, K6-K8b) are built on,
and m16n8k16 bf16 with float32 sums, the bfloat16 flash kernels' (K1-K3
on bfloat16 inputs).

    python3 mma_rate.py

A kernel in which every warp runs ``chains`` independent accumulator
chains of ``mma.sync`` (no memory traffic) is compiled with ``nvcc``
for ``sm_90a`` into a temporary directory and timed with CUDA events
at 1, 2, 4 and 8 chains a warp and 4, 8 and 16 warps an SM, on every
SM, for each instruction.  Prints the rate (2 * 16 * 8 * 8 operations
a TF32 instruction, 2 * 16 * 8 * 16 a bf16 one) of each, then one JSON
line; fails without a card.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from paddle_tpu_torch.kernels import _build  # noqa: E402

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS, bool BF16>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f800000u + threadIdx.x * 3 + i;
  float d[CHAINS][4];
  for (int c = 0; c < CHAINS; ++c) d[c][0] = d[c][1] = d[c][2] = d[c][3] = 0.0f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (BF16) {
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.0f;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool BF16>
int run(int chains, int blocks, int threads, int iters, float* o, cudaStream_t st) {
  switch (chains) {
    case 1: mma_loop<1, BF16><<<blocks, threads, 0, st>>>(o, iters); break;
    case 2: mma_loop<2, BF16><<<blocks, threads, 0, st>>>(o, iters); break;
    case 4: mma_loop<4, BF16><<<blocks, threads, 0, st>>>(o, iters); break;
    case 8: mma_loop<8, BF16><<<blocks, threads, 0, st>>>(o, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mma_run(int bf16, int chains, int blocks, int threads, int iters,
                       void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return bf16 ? run<true>(chains, blocks, threads, iters, o, st)
              : run<false>(chains, blocks, threads, iters, o, st);
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "mma_rate.cu")
        with open(src, "w") as f:
            f.write(SRC)
        lib = os.path.join(tmp, "libmma_rate.so")
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True)
        fn = ctypes.CDLL(lib).mma_run
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        iters = 4096
        res = {"mma_sync_m16n8k8_tf32": [], "mma_sync_m16n8k16_bf16": []}
        for key, bf16, depth in (("mma_sync_m16n8k8_tf32", 0, 8),
                                 ("mma_sync_m16n8k16_bf16", 1, 16)):
            for warps in (4, 8, 16):
                for chains in (1, 2, 4, 8):
                    threads = 128
                    blocks = sms * warps // 4
                    out = torch.empty(blocks * threads, device="cuda")
                    stream = torch.cuda.current_stream().cuda_stream
                    def launch():
                        err = fn(bf16, chains, blocks, threads, iters,
                                 out.data_ptr(), stream)
                        if err != 0:
                            raise RuntimeError(f"mma_run: cudaError {err}")

                    launch()
                    launch()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    launch()
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end)
                    n_mma = blocks * (threads // 32) * chains * iters
                    rate = n_mma * 2 * 16 * 8 * depth / (ms * 1e-3)
                    res[key].append({"warps_per_sm": warps, "chains": chains,
                                     "ms": ms, "tflops": rate / 1e12})
                    print(f"  {key}: {warps} warps an SM, {chains} chains a "
                          f"warp: {rate / 1e12:.1f} TFLOP/s ({ms:.3f} ms)",
                          flush=True)
    print(json.dumps({"card": card, "sms": sms, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
