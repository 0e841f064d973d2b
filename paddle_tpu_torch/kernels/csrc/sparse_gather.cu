// Fused multi-table embedding gather for Hopper (sm_90a), float32: K9.
//
// Replaces the Pallas kernel paddle_tpu/kernels/sparse.py _gather_kernel
// (launched by fused_gather through pl.pallas_call): ONE launch gathers
// the same id batch from k <= 4 tables, out_t[i, :] = table_t[ids[i], :].
// Ids in [-H_t, 0) wrap to id + H_t; an id outside [-H_t, H_t) writes a
// NaN row, here in the kernel (the TPU version NaN-filled in a second
// XLA pass), so a data bug in the feed fails the step loudly.  It is a
// copy: the output equals fused_gather_ref (and jnp.take) bit for bit.
//
// Design.  The TPU walked a grid of one id per step, each step's row
// block chosen by a scalar-prefetched index map.  Here one thread owns
// one (id, column) of one table: thread x of the flat range
// [0, n * sum_t D_t) reads the id of row x / sum D, finds its table from
// the column x % sum D, and copies one float.  Neighbouring threads
// write neighbouring output words, and the threads of one id read one
// table row, so every touched row costs the sectors it spans and no
// more.
//
// Bound.  At the DeepFM bench shape (n = 2048 x 26 = 53,248 ids, tables
// [1e6, 10] and [1e6, 1] float32) the function moves 0.43 MB of ids,
// 2.34 MB of rows read and 2.34 MB written: 5.1 MB, 1.5 us at 3.35 TB/s.
// The rows sit at random addresses, so it is the 32-byte sectors that
// bound it: a 40-byte row spans 2 or 3 sectors and a 4-byte row 1, about
// 4.3 MB of sectors read besides the ids and the outputs.
//
// Entry point: sparse_gather(), a plain C function called through
// ctypes on PyTorch's current stream.  It returns 0 or a cudaError_t; it
// never synchronises and allocates nothing.  n = 0 launches nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTables = 4;
constexpr int kThreads = 256;

struct GatherArgs {
  const int64_t* ids;
  int64_t n;
  const float* table[kMaxTables];
  float* out[kMaxTables];
  int64_t height[kMaxTables];
  int width[kMaxTables];
  int col_start[kMaxTables + 1];  // prefix sums of width
  int k;
};

__global__ void __launch_bounds__(kThreads) sparse_gather_kernel(const GatherArgs a) {
  const int total_cols = a.col_start[a.k];
  const int64_t x = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (x >= a.n * total_cols) return;
  const int64_t i = x / total_cols;
  const int c = static_cast<int>(x - i * total_cols);
  int t = 0;
#pragma unroll
  for (int s = 1; s < kMaxTables; ++s) t += (s < a.k && c >= a.col_start[s]) ? 1 : 0;
  const int j = c - a.col_start[t];
  const int64_t h = a.height[t];
  const int64_t d = a.width[t];
  const int64_t id = __ldg(a.ids + i);
  float val;
  if (id >= -h && id < h) {
    const int64_t row = id < 0 ? id + h : id;
    val = __ldg(a.table[t] + row * d + j);
  } else {
    val = __int_as_float(0x7fc00000);  // quiet NaN
  }
  a.out[t][i * d + j] = val;
}

}  // namespace

extern "C" {

// ids [n] int64; table_t [height_t, width_t] float32 and out_t
// [n, width_t] float32 for t < k (the rest unused), all contiguous on
// `device`.  Returns 0 or a cudaError_t.
int sparse_gather(int k, const void* ids, int64_t n, const void* t0, const void* t1,
                  const void* t2, const void* t3, void* o0, void* o1, void* o2, void* o3,
                  int64_t h0, int64_t h1, int64_t h2, int64_t h3, int w0, int w1, int w2,
                  int w3, int device, void* stream) {
  if (k < 1 || k > kMaxTables || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  GatherArgs a{};
  a.ids = static_cast<const int64_t*>(ids);
  a.n = n;
  a.k = k;
  const void* tables[kMaxTables] = {t0, t1, t2, t3};
  void* outs[kMaxTables] = {o0, o1, o2, o3};
  const int64_t heights[kMaxTables] = {h0, h1, h2, h3};
  const int widths[kMaxTables] = {w0, w1, w2, w3};
  a.col_start[0] = 0;
  for (int t = 0; t < kMaxTables; ++t) {
    const bool used = t < k;
    if (used && (tables[t] == nullptr || outs[t] == nullptr || heights[t] < 1 || widths[t] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    a.table[t] = static_cast<const float*>(tables[t]);
    a.out[t] = static_cast<float*>(outs[t]);
    a.height[t] = used ? heights[t] : 0;
    a.width[t] = used ? widths[t] : 0;
    a.col_start[t + 1] = a.col_start[t] + a.width[t];
  }
  const int64_t threads = n * a.col_start[k];
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  sparse_gather_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
