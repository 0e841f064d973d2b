// Row-wise lazy optimizer update for Hopper (sm_90a), float32: K10.
//
// Replaces the Pallas kernel paddle_tpu/kernels/sparse.py:256
// _update_kernel (launched by _rowwise_update through pl.pallas_call):
// given a sparse gradient (values [n, d] in the id batch's order) and its
// canonical ids stably sorted beforehand (rows [n] int32 and the sort's
// permutation order [n]: sorted position k holds the batch's row
// order[k]), sum each run of equal ids left to right in batch order in
// float32 and apply the lazy Adam, momentum or adagrad step once per
// unique row, IN PLACE on the parameter table and its moments [H, d].
// Rows the batch does not touch are never read or written.
//
// Design.  The TPU walked a grid of one sorted position per step over a
// sorted copy of the values, carried the run's sum in VMEM scratch and
// wrote the row back when its block index changed.  Blocks on the GPU run
// in no order, so here the thread for (sorted position i, column j) does
// work only when i starts a run (rows[i - 1] != rows[i]): it sums its
// run's values in order, reading each straight from the unsorted gradient
// as vals[order[k]] (no sorted copy of the values exists), then reads p
// and the moments of that row, applies the math and writes them back.
// Most runs are one position long (uniform ids over a large table); a
// longer run finds its end by a galloping search over the sorted ids and
// loads its values kWalk at a time, each chunk together with the next
// chunk's order entries, so a long run of one hot id pays about one
// round trip to memory a chunk, not two a value; the adds stay one after
// the other, in batch order.  Each unique row has exactly one owner per
// column: no atomics, no host-side nonzero, no host sync.  lr is read from device memory (a 0-d tensor the
// program computes), so it is never copied to the host.  The math is
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn,
// which nvcc never contracts into an FMA, in the same order as the plain
// version's separate torch kernels, so the two agree bit for bit.
//
// Bound.  At the DeepFM bench shape (53,248 ids of a [1e6, 10] table,
// Adam) the function reads the values once (2.13 MB), the sorted ids and
// the permutation (0.64 MB) and each unique row of p, m1, m2 once and
// writes them once (U x 10 x 4 x 6 bytes; U is about 51,900 uniques for
// uniform ids over 1e6 rows): about 15 MB, 4.5 us at 3.35 TB/s.  The rows
// sit at random addresses, so the 32-byte sectors they span (2 or 3 for
// a 40-byte row, 1 for a 4-byte row) are the real bound.
//
// Entry point: sparse_update(), a plain C function called through ctypes
// on PyTorch's current stream.  It returns 0 or a cudaError_t; it never
// synchronises and allocates nothing.  n = 0 launches nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWalk = 16;  // positions of a run loaded together

enum Kind : int { kAdam = 0, kMomentum = 1, kAdagrad = 2 };

struct UpdateArgs {
  const int* rows;              // [n] canonical ids, sorted
  const int64_t* order;         // [n] the sort's permutation
  const float* vals;            // [n, d] in the batch's order
  int64_t n;
  int d;
  float* p;                     // [H, d]
  float* a;                     // adam m1 | momentum velocity | adagrad moment
  float* b;                     // adam m2
  const float* lr;              // one value in device memory
  float h1, h2, h3;             // adam beta1, beta2, eps | momentum mu | adagrad eps
  int flag;                     // momentum: use_nesterov
};

// One past the last sorted position of the run of `row` that starts at
// i, given rows[i + 1] == row: a galloping search (probes at i + 2, i + 4,
// i + 8, ...), then a binary search between the last two probes
__device__ __forceinline__ int64_t run_end(const int* rows, int64_t n, int64_t i, int row) {
  int64_t lo = i + 1, step = 1;  // rows[lo] == row
  int64_t hi = n;                // first position known past the run (or n)
  while (lo + step < n) {
    if (__ldg(rows + lo + step) != row) {
      hi = lo + step;
      break;
    }
    lo += step;
    step *= 2;
  }
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (__ldg(rows + mid) == row) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

template <int K>
__global__ void __launch_bounds__(kThreads) sparse_update_kernel(const UpdateArgs u) {
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (x >= u.n * u.d) return;
  const int64_t i = x / u.d;
  const int j = static_cast<int>(x - i * u.d);
  const int row = __ldg(u.rows + i);
  if (i > 0 && __ldg(u.rows + i - 1) == row) return;  // not the start of its run
  // the run's sum, left to right in batch order from its first value
  float g = __ldg(u.vals + __ldg(u.order + i) * u.d + j);
  if (i + 1 < u.n && __ldg(u.rows + i + 1) == row) {
    const int64_t e = run_end(u.rows, u.n, i, row);
    // kWalk values a round trip: the chunk's values are loaded together
    // with the next chunk's order entries, then added one after the other
    int o[kWalk];  // positions in the batch (n < 2^31)
#pragma unroll
    for (int s = 0; s < kWalk; ++s) {
      o[s] = i + 1 + s < e ? static_cast<int>(__ldg(u.order + i + 1 + s)) : 0;
    }
    for (int64_t k = i + 1; k < e; k += kWalk) {
      float v[kWalk];
#pragma unroll
      for (int s = 0; s < kWalk; ++s) {
        v[s] = k + s < e ? __ldg(u.vals + static_cast<int64_t>(o[s]) * u.d + j) : 0.0f;
      }
#pragma unroll
      for (int s = 0; s < kWalk; ++s) {
        o[s] = k + kWalk + s < e ? static_cast<int>(__ldg(u.order + k + kWalk + s)) : 0;
      }
#pragma unroll
      for (int s = 0; s < kWalk; ++s) {
        if (k + s < e) g = __fadd_rn(g, v[s]);
      }
    }
  }
  const int64_t at = static_cast<int64_t>(row) * u.d + j;
  const float lr = __ldg(u.lr);
  const float p = u.p[at];
  if (K == kAdam) {
    const float b1 = u.h1, b2 = u.h2, eps = u.h3;
    // m1n = b1 * m1 + (1 - b1) * g
    const float m1n = __fadd_rn(__fmul_rn(b1, u.a[at]), __fmul_rn(__fsub_rn(1.0f, b1), g));
    // m2n = b2 * m2 + ((1 - b2) * g) * g
    const float m2n =
        __fadd_rn(__fmul_rn(b2, u.b[at]), __fmul_rn(__fmul_rn(__fsub_rn(1.0f, b2), g), g));
    // step = (lr * m1n) / (sqrt(m2n) + eps)
    const float step = __fdiv_rn(__fmul_rn(lr, m1n), __fadd_rn(__fsqrt_rn(m2n), eps));
    u.p[at] = __fsub_rn(p, step);
    u.a[at] = m1n;
    u.b[at] = m2n;
  } else if (K == kMomentum) {
    const float mu = u.h1;
    const float v_new = __fadd_rn(__fmul_rn(mu, u.a[at]), g);
    // nesterov: p - (g + mu * v_new) * lr; else p - lr * v_new
    const float step = u.flag ? __fmul_rn(__fadd_rn(g, __fmul_rn(mu, v_new)), lr)
                              : __fmul_rn(lr, v_new);
    u.p[at] = __fsub_rn(p, step);
    u.a[at] = v_new;
  } else {
    const float eps = u.h3;
    const float mom_new = __fadd_rn(u.a[at], __fmul_rn(g, g));
    // step = ((lr * g) / (sqrt(mom_new) + eps))
    const float step = __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(__fsqrt_rn(mom_new), eps));
    u.p[at] = __fsub_rn(p, step);
    u.a[at] = mom_new;
  }
}

}  // namespace

extern "C" {

// kind 0 adam (p, a = m1, b = m2; h1 beta1, h2 beta2, h3 eps), 1 momentum
// (p, a = velocity; h1 mu; flag nesterov), 2 adagrad (p, a = moment;
// h3 eps).  rows [n] int32 sorted canonical ids, order [n] int64 their
// positions in the batch (n < 2^31), vals [n, d] float32 in batch order,
// tables [H, d] float32, lr one float32: contiguous on `device`.  Returns
// 0 or a cudaError_t.
int sparse_update(int kind, const void* rows, const void* order, const void* vals, int64_t n,
                  int d, void* p, void* a, void* b, const void* lr, float h1, float h2,
                  float h3, int flag, int device, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || d < 1 || kind < kAdam || kind > kAdagrad || p == nullptr ||
      a == nullptr || (kind == kAdam && b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  UpdateArgs u{};
  u.rows = static_cast<const int*>(rows);
  u.order = static_cast<const int64_t*>(order);
  u.vals = static_cast<const float*>(vals);
  u.n = n;
  u.d = d;
  u.p = static_cast<float*>(p);
  u.a = static_cast<float*>(a);
  u.b = static_cast<float*>(b);
  u.lr = static_cast<const float*>(lr);
  u.h1 = h1; u.h2 = h2; u.h3 = h3;
  u.flag = flag;
  const int64_t blocks = (n * d + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kAdam: sparse_update_kernel<kAdam><<<grid, kThreads, 0, st>>>(u); break;
    case kMomentum: sparse_update_kernel<kMomentum><<<grid, kThreads, 0, st>>>(u); break;
    default: sparse_update_kernel<kAdagrad><<<grid, kThreads, 0, st>>>(u); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
