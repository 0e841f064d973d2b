#!/usr/bin/env python3
"""The rate of tensor-core products on one CUDA card: ``mma.sync``
m16n8k8 TF32, the instruction the split-TF32 kernels (K1, K2, K3,
K6-K8b) are built on, and m16n8k16 bf16 with float32 sums; the
warpgroup product ``wgmma`` m64nNk16 bf16 with float32 sums (N = 64,
128, 256; A from shared memory and from registers), the bfloat16 flash
kernels' (K1, K2, K3); and ``ex2.approx``, the bfloat16 forward's other
floor.

    python3 mma_rate.py

A kernel in which every warp runs ``chains`` independent accumulator
chains of ``mma.sync`` (no memory traffic) is compiled with ``nvcc``
for ``sm_90a`` into a temporary directory and timed with CUDA events
at 1, 2, 4 and 8 chains a warp and 4, 8 and 16 warps an SM, on every
SM, for each instruction.  A second kernel has each warpgroup issue
batches of eight ``wgmma`` on one accumulator from operands in shared
memory (B, and A unless it comes from registers), then wait for them,
at 1, 2 and 3 warpgroups an SM.  A third kernel runs ``chains``
independent chains of ``ex2.approx.ftz.f32`` a thread (the special-function
unit's exp2, which the flash forward takes once a score) at 4, 8 and 16
warps on one SM and on every SM.  Prints the rate (2 * 16 * 8 * 8
operations a TF32 ``mma.sync``, 2 * 16 * 8 * 16 a bf16 one, 2 * 64 * N
* 16 a ``wgmma``; exp2s a second, and a clock an SM with the SM clock
read in the loop: ``clock64`` against ``%globaltimer``) of each, then
one JSON line; fails without a card.
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

// ---- wgmma m64nNk16 bf16, f32 sums --------------------------------------

__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

WGMMA_FUNCS

template <int N, bool RS>
__global__ void wgmma_loop(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char sm[];
  // A: 64 rows x 64 columns (8 KB), B: N rows x 64 columns, small values
  const int words = (8192 + N * 128) / 4;
  uint32_t* w = reinterpret_cast<uint32_t*>(sm);
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0x3c003c00u ^ (i & 0x00ff00ffu);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const uint32_t a[4] = {0x3c003c00u + threadIdx.x, 0x3c013c01u, 0x3c023c02u, 0x3c033c03u};
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t db = desc_b128(base + 8192 + (k & 3) * 32);
      if (RS) {
        wgmma_rs<N>(d, a, db);
      } else {
        wgmma_ss<N>(d, desc_b128(base + (k & 3) * 32), db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, bool RS>
int run_wgmma(int blocks, int iters, float* o, cudaStream_t st) {
  const int smem = 8192 + N * 128 + 1024;
  wgmma_loop<N, RS><<<blocks, 128, smem, st>>>(o, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgmma_run(int n, int rs, int blocks, int iters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (n * 2 + rs) {
    case 128: return run_wgmma<64, false>(blocks, iters, o, st);
    case 129: return run_wgmma<64, true>(blocks, iters, o, st);
    case 256: return run_wgmma<128, false>(blocks, iters, o, st);
    case 257: return run_wgmma<128, true>(blocks, iters, o, st);
    case 512: return run_wgmma<256, false>(blocks, iters, o, st);
    case 513: return run_wgmma<256, true>(blocks, iters, o, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- ex2.approx.ftz.f32 (MUFU.EX2) ----------------------------------------

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// clk[4 b .. 4 b + 3]: block b's SM clock (clock64) and global time (ns)
// at the start and at the end of its loop
template <int CHAINS>
__global__ void ex2_loop(float* out, long long* clk, int iters) {
  float x[CHAINS];
  for (int c = 0; c < CHAINS; ++c) x[c] = -1.0f - 1e-3f * (threadIdx.x + c);
  __syncthreads();
  if (threadIdx.x == 0) {
    clk[4 * blockIdx.x] = clock64();
    clk[4 * blockIdx.x + 1] = globaltimer();
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) asm volatile("ex2.approx.ftz.f32 %0, %0;\n" : "+f"(x[c]));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    clk[4 * blockIdx.x + 2] = clock64();
    clk[4 * blockIdx.x + 3] = globaltimer();
  }
  float s = 0.0f;
  for (int c = 0; c < CHAINS; ++c) s += x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int ex2_run(int chains, int blocks, int threads, int iters, void* out,
                       void* clk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  long long* c = static_cast<long long*>(clk);
  switch (chains) {
    case 4: ex2_loop<4><<<blocks, threads, 0, st>>>(o, c, iters); break;
    case 8: ex2_loop<8><<<blocks, threads, 0, st>>>(o, c, iters); break;
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


def wgmma_funcs() -> str:
    """CUDA source of wgmma_ss<N> and wgmma_rs<N> (N = 64, 128, 256): d
    += A . B, A and B K-major, every accumulator register an operand of
    the inline PTX (the form of csrc/sm90.cuh's)."""
    out = ["template <int N> __device__ __forceinline__ void wgmma_ss("
           "float (&d)[N / 2], uint64_t a, uint64_t b);",
           "template <int N> __device__ __forceinline__ void wgmma_rs("
           "float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);"]
    for n in (64, 128, 256):
        regs = n // 2
        dl = ", ".join(f"%{i}" for i in range(regs))
        cons = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
        for rs in (False, True):
            if rs:
                a = "{" + ", ".join(f"%{regs + i}" for i in range(4)) + "}"
                b, one, tail = f"%{regs + 4}", f"%{regs + 5}", "p, 1, 1, 0"
                ins = ('"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), '
                       '"r"(1)')
                sig = "const uint32_t (&a)[4], uint64_t b"
            else:
                a, b, one = f"%{regs}", f"%{regs + 1}", f"%{regs + 2}"
                tail = "p, 1, 1, 0, 0"
                ins = '"l"(a), "l"(b), "r"(1)'
                sig = "uint64_t a, uint64_t b"
            name = "wgmma_rs" if rs else "wgmma_ss"
            out.append(
                f"template <> __device__ __forceinline__ void {name}<{n}>("
                f"float (&d)[{regs}], {sig}) {{\n"
                f"  asm volatile(\"{{\\n.reg .pred p;\\nsetp.ne.b32 p, {one}, 0;"
                f"\\nwgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
                f"{{{dl}}}, {a}, {b}, {tail};\\n}}\\n\"\n"
                f"               : {cons}\n               : {ins} : \"memory\");\n}}")
    return "\n".join(out)


def lib_fn(lib: str, name: str, argtypes):
    fn = getattr(ctypes.CDLL(lib), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def event_ms(launch) -> float:
    """CUDA-event ms of the third of three launches (``launch`` returns a
    cudaError_t)."""
    for i in range(3):
        if i == 2:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        err = launch()
        if err != 0:
            raise RuntimeError(f"launch: cudaError {err}")
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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
            f.write(SRC.replace("WGMMA_FUNCS", wgmma_funcs()))
        lib = os.path.join(tmp, "libmma_rate.so")
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       check=True, capture_output=True)
        fn = lib_fn(lib, "mma_run", [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
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
                    ms = event_ms(lambda: fn(bf16, chains, blocks, threads,
                                             iters, out.data_ptr(), stream))
                    n_mma = blocks * (threads // 32) * chains * iters
                    rate = n_mma * 2 * 16 * 8 * depth / (ms * 1e-3)
                    res[key].append({"warps_per_sm": warps, "chains": chains,
                                     "ms": ms, "tflops": rate / 1e12})
                    print(f"  {key}: {warps} warps an SM, {chains} chains a "
                          f"warp: {rate / 1e12:.1f} TFLOP/s ({ms:.3f} ms)",
                          flush=True)
        wg = lib_fn(lib, "wgmma_run", [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
        for n in (64, 128, 256):
            for rs in (0, 1):
                key = f"wgmma_m64n{n}k16_bf16_{'rs' if rs else 'ss'}"
                res[key] = []
                for wgs in (1, 2, 3):
                    blocks = sms * wgs
                    out = torch.empty(blocks * 128, device="cuda")
                    stream = torch.cuda.current_stream().cuda_stream
                    ms = event_ms(lambda: wg(n, rs, blocks, iters, out.data_ptr(),
                                             stream))
                    rate = blocks * iters * 8 * 2 * 64 * n * 16 / (ms * 1e-3)
                    res[key].append({"warpgroups_per_sm": wgs, "ms": ms,
                                     "tflops": rate / 1e12})
                    print(f"  {key}: {wgs} warpgroups an SM: "
                          f"{rate / 1e12:.1f} TFLOP/s ({ms:.3f} ms)", flush=True)
        ex = lib_fn(lib, "ex2_run", [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        res["ex2_approx_ftz_f32"] = []
        for n_sm in (1, sms):
            for warps in (4, 8, 16):
                for chains in (4, 8):
                    threads = 32 * warps
                    out = torch.empty(n_sm * threads, device="cuda")
                    clk = torch.zeros(n_sm, 4, dtype=torch.int64, device="cuda")
                    stream = torch.cuda.current_stream().cuda_stream
                    ms = event_ms(lambda: ex(chains, n_sm, threads, iters,
                                             out.data_ptr(), clk.data_ptr(),
                                             stream))
                    n = threads * chains * iters    # exp2s a block (an SM)
                    rate = n_sm * n / (ms * 1e-3)
                    # the third launch's loop, block by block: its cycles
                    # (clock64) and nanoseconds (globaltimer)
                    cyc = (clk[:, 2] - clk[:, 0]).double()
                    ns = (clk[:, 3] - clk[:, 1]).double()
                    per_clock = (n / cyc).max().item()
                    mhz = (cyc / ns).mean().item() * 1e3
                    res["ex2_approx_ftz_f32"].append({
                        "sms": n_sm, "warps_per_sm": warps, "chains": chains,
                        "ms": ms, "per_s": rate,
                        "per_clock_per_sm": per_clock, "sm_mhz_in_run": mhz})
                    print(f"  ex2.approx.ftz.f32: {n_sm} SMs, {warps} warps an "
                          f"SM, {chains} chains a thread: {rate / 1e9:.1f} G/s "
                          f"({ms:.3f} ms); {per_clock:.2f} a clock an SM at "
                          f"{mhz:.0f} MHz (clock64 / globaltimer in the loop)",
                          flush=True)
    rows = res["ex2_approx_ftz_f32"]
    best = max(rows, key=lambda r: r["per_s"] if r["sms"] == sms else 0.0)
    one = max(r["per_s"] for r in rows if r["sms"] == 1)
    print(f"  ex2 best: {best['per_s'] / 1e12:.3f} T/s on {sms} SMs, "
          f"{one / 1e9:.2f} G/s on one; at most "
          f"{max(r['per_clock_per_sm'] for r in rows):.2f} a clock an SM; the "
          f"best run's SM clock {best['sm_mhz_in_run']:.0f} MHz", flush=True)
    res["ex2_summary"] = {
        "per_s_all_sms": best["per_s"], "per_s_one_sm": one,
        "per_clock_per_sm": max(r["per_clock_per_sm"] for r in rows),
        "sm_mhz_in_best_run": best["sm_mhz_in_run"]}
    print(json.dumps({"card": card, "sms": sms, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
