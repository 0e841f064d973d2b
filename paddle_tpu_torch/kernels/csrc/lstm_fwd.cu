// Fused LSTM forward for Hopper (sm_90a), float32: K6.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py _lstm_fwd_kernel
// (launched by lstm_fused through pl.pallas_call): the whole-sequence
// LSTM over xproj [B, T, 4H] (x·Wx + b, gates i, f, g, o) with the
// recurrent weight w [H, 4H], the initial state h0/c0 [B, H] and the
// length mask [B, T]; a masked step passes h and c through.  It writes
// hs and cs [B, T, H], and nothing else: the backward (lstm_bwd.cu)
// recomputes the gates.
//
// Design.  The TPU walked a grid of T sequential steps with W resident
// in VMEM and h/c in VMEM scratch.  Here one cooperative launch runs the
// whole sequence (lstm_common.cuh): block x owns 4 hidden units and
// keeps their 16 columns of W in shared memory for every step (H x 16
// floats, 32 KB at H = 512).  Per step a block stages h_{t-1} (hs[t-1],
// written by every block in the step before, read through L2; h0 at
// t = 0) in 128-row x 32-deep tiles, forms its [B, 16] pre-activations
// with FFMA (two threads per batch row, each half of every tile), applies
// the cell to its units and writes hs[t] and cs[t]; then one grid
// barrier.  h and c never leave float32.
//
// Bound.  At the bench shape B = 128, T = 128, H = 512 the work is
// 2 * B * H * 4H * T = 34.4 GFLOP of float32, over about 205 MB of xproj,
// w, mask and hs/cs: bound by the float32 rate outside the tensor cores
// (67 TFLOP/s on an H100 SXM), 0.513 ms.  This first version reads
// h_{t-1} from L2 once per block per step (128 blocks x 256 KB a step)
// and pays one grid barrier a step; its time beside the bound is in
// PERF.md.
//
// Entry point: lstm_fwd(), a plain C function called through ctypes on
// PyTorch's current stream.  It zeroes the barrier counter, launches and
// returns 0, a cudaError_t, or kSmemOver/kNotResident when the shape
// cannot run; it never synchronises and allocates nothing.

#include "lstm_common.cuh"

namespace {

using namespace lstm;

struct FwdArgs {
  const float* xproj;  // [B, T, 4H]
  const float* w;      // [H, 4H]
  const float* h0;     // [B, H]
  const float* c0;     // [B, H]
  const float* mask;   // [B, T]
  float* hs;           // [B, T, H]
  float* cs;           // [B, T, H]
  unsigned int* barrier;
  int B, T, H;
};

size_t fwd_smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(round_up(H, kTile)) * kCols + kTileFloats);
}

__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H;
  float* Ws = smem;                                   // [Hp][kCols]
  float* tile = Ws + round_up(H, kTile) * kCols;      // [kRows][kTileStride]
  const int j0 = blockIdx.x * kUnits;
  const int r = threadIdx.x % kRows;
  const int ks = threadIdx.x / kRows;
  const size_t row = static_cast<size_t>(T) * H;      // hs/cs batch stride
  load_w_slice(a.w, H, j0, Ws);

  unsigned int passed = 0;
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
    const size_t hstride = t == 0 ? static_cast<size_t>(H) : row;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kCols];
      rows_times_slice<kCols>(hprev, hstride, B, b0, H, Ws, tile, acc);
      reduce_split<kCols>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
      const float m = a.mask[static_cast<size_t>(b) * T + t];
      const float* x = a.xproj + (static_cast<size_t>(b) * T + t) * 4 * H;
      float* hs_t = a.hs + b * row + static_cast<size_t>(t) * H;
      float* cs_t = a.cs + b * row + static_cast<size_t>(t) * H;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int j = j0 + u;
        if (j >= H) continue;
        const float ig = sigmoidf(acc[0 * kUnits + u] + x[j]);
        const float fg = sigmoidf(acc[1 * kUnits + u] + x[H + j]);
        const float gg = tanhf(acc[2 * kUnits + u] + x[2 * H + j]);
        const float og = sigmoidf(acc[3 * kUnits + u] + x[3 * H + j]);
        const float c_prev = t == 0 ? a.c0[static_cast<size_t>(b) * H + j] : __ldcg(cs_t - H + j);
        const float h_prev = t == 0 ? a.h0[static_cast<size_t>(b) * H + j] : __ldcg(hs_t - H + j);
        const float c_new = fg * c_prev + ig * gg;
        const float h_new = og * tanhf(c_new);
        cs_t[j] = m * c_new + (1.0f - m) * c_prev;
        hs_t[j] = m * h_new + (1.0f - m) * h_prev;
      }
    }
    if (t + 1 < T) {
      passed += gridDim.x;
      grid_sync(a.barrier, passed);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block of lstm_fwd takes at this shape (bytes).
int lstm_fwd_smem_bytes(int B, int H) {
  (void)B;
  return static_cast<int>(fwd_smem_bytes(H));
}

// xproj [B, T, 4H], w [H, 4H], h0/c0 [B, H], mask [B, T], hs/cs [B, T, H]:
// float32, contiguous, on `device`; barrier: one 32-bit word of device
// memory.  Returns 0, a cudaError_t, kSmemOver or kNotResident.
int lstm_fwd(const void* xproj, const void* w, const void* h0, const void* c0,
             const void* mask, void* hs, void* cs, void* barrier, int B, int T, int H,
             int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdArgs a{};
  a.xproj = static_cast<const float*>(xproj);
  a.w = static_cast<const float*>(w);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.mask = static_cast<const float*>(mask);
  a.hs = static_cast<float*>(hs);
  a.cs = static_cast<float*>(cs);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_cooperative(lstm_fwd_kernel, a, round_up(H, kUnits) / kUnits,
                            fwd_smem_bytes(H), device, st);
}

// Blocks of lstm_fwd the card holds at once at this shape's shared memory
// (0 when a block cannot have that much), or minus a cudaError_t.
int lstm_fwd_capacity(int B, int H, int device) {
  (void)B;
  return resident_capacity(lstm_fwd_kernel, fwd_smem_bytes(H), device);
}

const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
