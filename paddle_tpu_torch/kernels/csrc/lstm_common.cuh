// Shared pieces of the fused recurrent kernels (lstm_fwd.cu, lstm_bwd.cu,
// gru_fwd.cu, gru_bwd.cu): the grid and group barriers, the occupancy
// query, the cooperative launch, sigmoidf and the (row, units) loads and
// stores of their cells.
//
// These kernels run one persistent grid for the whole sequence, launched
// with cudaLaunchCooperativeKernel so that every block is resident at
// once, and step through time with a barrier between steps.  Their
// products are split TF32 on the tensor cores (tf32x3.cuh); h, c and
// every cell stay in float32, as the reference keeps them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm {

constexpr int kThreads = 256;  // threads a block

// return codes besides a cudaError_t (kernels/rnn.py raises ValueError)
constexpr int kSmemOver = -1;
constexpr int kNotResident = -2;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Grid-wide barrier on a counter the host zeroed before the launch: the
// n-th barrier waits until the counter reaches n * gridDim.x.  Only safe
// when every block is resident (a cooperative launch guarantees it).  A
// barrier that has not opened after 20 s traps, so a fault ends the
// kernel with an error instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned int* count, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned long long t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    while (true) {
      unsigned int seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (static_cast<int>(seen - target) >= 0) break;
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (now - t0 > 20000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The group barrier of the batch-group kernels (lstm_fwd.cu, gru_fwd.cu,
// gru_bwd.cu) in two halves: every block of a group arrives after its
// writes, and waits only before it reads what the others wrote, for the
// count to reach the arrivals it needs.  Arrival is a block barrier, then
// thread 0's release add on the group's counter (release is cumulative:
// it publishes what the whole block wrote before the block barrier);
// the wait is thread 0's acquire loads, then a block barrier.  No full
// fence either side: it cost K6 and K8b 6-9% of their time on an H100
// (PERF.md).  A wait that has not opened after 20 s traps, so a fault
// ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void group_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
  }
}

__device__ __forceinline__ void group_wait(unsigned int* count, unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned long long t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    while (true) {
      unsigned int seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (static_cast<int>(seen - target) >= 0) break;
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (now - t0 > 20000000000ull) __trap();
    }
  }
  __syncthreads();
}

// P consecutive floats at p, of which the first n exist; 8- or 16-byte
// loads when `vec` (p aligned to P floats and n == P).  kL2: through L2
// only (__ldcg), for values other blocks of the launch write nearby.
template <int P, bool kL2 = false>
__device__ __forceinline__ void load_units(const float* p, int n, bool vec, float (&v)[P]) {
  if constexpr (P == 1) {
    v[0] = n > 0 ? (kL2 ? __ldcg(p) : __ldg(p)) : 0.0f;
  } else if (vec) {
    if constexpr (P == 2) {
      const float2* p2 = reinterpret_cast<const float2*>(p);
      const float2 x = kL2 ? __ldcg(p2) : __ldg(p2);
      v[0] = x.x; v[1] = x.y;
    } else {
#pragma unroll
      for (int i = 0; i < P; i += 4) {
        const float4* p4 = reinterpret_cast<const float4*>(p + i);
        const float4 x = kL2 ? __ldcg(p4) : __ldg(p4);
        v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = i < n ? (kL2 ? __ldcg(p + i) : __ldg(p + i)) : 0.0f;
  }
}

template <int P>
__device__ __forceinline__ void store_units(float* p, int n, bool vec, const float (&v)[P]) {
  if constexpr (P == 1) {
    if (n > 0) p[0] = v[0];
  } else if (vec) {
    if constexpr (P == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int i = 0; i < P; i += 4) {
        *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < n) p[i] = v[i];
    }
  }
}

// Blocks of `kernel` the card `device` holds at once with `smem` bytes of
// dynamic shared memory a block: SM count x blocks per SM from the
// occupancy query, 0 when `smem` is more than a block may use.  Returns
// the count, or minus a cudaError_t.  kernels/rnn.py's eligibility gate
// reads it before it routes a shape to the kernel.
template <typename Args>
int resident_capacity(void (*kernel)(const Args), size_t smem, int device) {
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (smem > static_cast<size_t>(smem_max)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// Checks that the launch can run (shared memory a block, every block
// resident) and launches `kernel` cooperatively with the one argument
// `args`; returns 0, kSmemOver, kNotResident or a cudaError_t.
template <typename Args>
int launch_cooperative(void (*kernel)(const Args), const Args& args, int grid,
                       size_t smem, int device, cudaStream_t stream) {
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(smem_max)) return kSmemOver;
  const int capacity = resident_capacity(kernel, smem, device);
  if (capacity < 0) return -capacity;
  if (capacity < grid) return kNotResident;
  void* argv[] = {const_cast<Args*>(&args)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(kThreads),
                                    argv, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lstm
