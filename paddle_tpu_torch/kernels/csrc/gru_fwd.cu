// Fused GRU forward for Hopper (sm_90a), float32: K8a.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py _gru_fwd_kernel
// (launched by gru_fused through pl.pallas_call): the whole-sequence GRU
// over xproj [B, T, 3H] (x·Wx + b, gates [update | reset | candidate])
// with the recurrent weight w [H, 3H], the initial state h0 [B, H] and
// the length mask [B, T]:
//   u = sigmoid(x_u + h w_u),  r = sigmoid(x_r + h w_r),
//   c = tanh(x_c + (r ⊙ h) w_c),  h' = u ⊙ h + (1 - u) ⊙ c,
// and a masked step carries h unchanged.  It writes hs [B, T, H] and
// nothing else: the backward (gru_bwd.cu) recomputes the gates.
//
// Design.  The TPU walked a grid of T sequential steps with w resident in
// VMEM and h in VMEM scratch.  Here one cooperative launch runs the whole
// sequence (lstm_common.cuh): block x owns 4 hidden units and keeps their
// 8 update/reset columns and 4 candidate columns of w in shared memory for
// every step.  Unlike the LSTM, the candidate's product needs r ⊙ h of
// every unit, so a step has two phases and two grid barriers:
//   (1) stage h_{t-1} (hs[t-1], written by every block in the step
//       before, read through L2; h0 at t = 0) in 128-row x 32-deep tiles,
//       form the block's [B, 8] update/reset pre-activations, and write
//       r ⊙ h_{t-1} of its units to a [B, H] scratch; barrier;
//   (2) stage the whole scratch, form the block's [B, 4] candidate
//       pre-activations, and write h_t of its units into hs[t]; barrier.
// h never leaves float32; no atomics, so the result does not depend on
// scheduling.
//
// Bound.  At the machine-translation shape B = 64, T = 32, H = 256 the
// work is 2 * B * T * H * 3H = 805 MFLOP of float32 over about 9.2 MB of
// xproj, w, h0, mask and hs: bound by the float32 rate outside the tensor
// cores (67 TFLOP/s on an H100 SXM), 0.0120 ms.  This first version pays
// 2T grid barriers of a few microseconds each and re-reads [B, H] from L2
// per block and phase; its time beside the bound is in PERF.md.
//
// Entry point: gru_fwd(), a plain C function called through ctypes on
// PyTorch's current stream.  It zeroes the barrier counter, launches and
// returns 0, a cudaError_t, or kSmemOver/kNotResident when the shape
// cannot run; it never synchronises and allocates nothing.

#include "gru_common.cuh"

namespace {

using namespace gru;
using lstm::grid_sync;
using lstm::reduce_split;
using lstm::rows_times_slice;
using lstm::sigmoidf;

struct FwdArgs {
  const float* xproj;  // [B, T, 3H]
  const float* w;      // [H, 3H]
  const float* h0;     // [B, H]
  const float* mask;   // [B, T]
  float* hs;           // [B, T, H]
  float* rh;           // [B, H] scratch: r ⊙ h_{t-1} of the current step
  unsigned int* barrier;
  int B, T, H;
};

size_t fwd_smem_floats(int B, int H) {
  const size_t Hp = round_up(H, kTile);
  return Hp * kUZ                  // Wuz: update/reset columns of the block's units
         + Hp * kUnits             // Wc: candidate columns
         + kTileFloats             // staging tile
         + static_cast<size_t>(B) * kUnits;  // the step's update gate
}

__global__ void __launch_bounds__(kThreads) gru_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, H3 = 3 * a.H;
  const int Hp = round_up(H, kTile);
  float* Wuz = smem;                   // [Hp][kUZ]
  float* Wc = Wuz + Hp * kUZ;          // [Hp][kUnits]
  float* tile = Wc + Hp * kUnits;      // [kRows][kTileStride]
  float* ug = tile + kTileFloats;      // [B][kUnits]
  const int j0 = blockIdx.x * kUnits;
  const int r = threadIdx.x % kRows;
  const int ks = threadIdx.x / kRows;
  const size_t row = static_cast<size_t>(T) * H;  // hs batch stride
  load_gate_cols(a.w, H, j0, 0, 2, Wuz);
  load_gate_cols(a.w, H, j0, 2, 1, Wc);
  // (rows_times_slice starts with __syncthreads: the slices are in place)

  unsigned int passed = 0;
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
    const size_t hstride = t == 0 ? static_cast<size_t>(H) : row;

    // (1) u and r of this block's units; r ⊙ h_{t-1} into the scratch
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kUZ];
      rows_times_slice<kUZ>(hprev, hstride, B, b0, H, Wuz, tile, acc);
      reduce_split<kUZ>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
      const float* x = a.xproj + (static_cast<size_t>(b) * T + t) * H3;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int j = j0 + u;
        if (j >= H) continue;
        const float uu = sigmoidf(x[j] + acc[u]);
        const float rr = sigmoidf(x[H + j] + acc[kUnits + u]);
        const float hp = __ldcg(hprev + b * hstride + j);
        ug[b * kUnits + u] = uu;
        a.rh[static_cast<size_t>(b) * H + j] = rr * hp;
      }
    }
    passed += gridDim.x;
    grid_sync(a.barrier, passed);

    // (2) the candidate from every unit's r ⊙ h_{t-1}, then h_t
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kUnits];
      rows_times_slice<kUnits>(a.rh, H, B, b0, H, Wc, tile, acc);
      reduce_split<kUnits>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
      const float m = a.mask[static_cast<size_t>(b) * T + t];
      const float* x = a.xproj + (static_cast<size_t>(b) * T + t) * H3;
      float* hs_t = a.hs + b * row + static_cast<size_t>(t) * H;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int j = j0 + u;
        if (j >= H) continue;
        const float c = tanhf(x[2 * H + j] + acc[u]);
        const float uu = ug[b * kUnits + u];
        const float hp = __ldcg(hprev + b * hstride + j);
        const float hn = uu * hp + (1.0f - uu) * c;
        hs_t[j] = m * hn + (1.0f - m) * hp;
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

// Shared memory one block of gru_fwd takes at this shape (bytes).
int gru_fwd_smem_bytes(int B, int H) {
  return static_cast<int>(sizeof(float) * fwd_smem_floats(B, H));
}

// xproj [B, T, 3H], w [H, 3H], h0 [B, H], mask [B, T], hs [B, T, H],
// rh [B, H]: float32, contiguous, on `device`; barrier: one 32-bit word
// of device memory.  Returns 0, a cudaError_t, kSmemOver or kNotResident.
int gru_fwd(const void* xproj, const void* w, const void* h0, const void* mask, void* hs,
            void* rh, void* barrier, int B, int T, int H, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdArgs a{};
  a.xproj = static_cast<const float*>(xproj);
  a.w = static_cast<const float*>(w);
  a.h0 = static_cast<const float*>(h0);
  a.mask = static_cast<const float*>(mask);
  a.hs = static_cast<float*>(hs);
  a.rh = static_cast<float*>(rh);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return lstm::launch_cooperative(gru_fwd_kernel, a, round_up(H, kUnits) / kUnits,
                                  sizeof(float) * fwd_smem_floats(B, H), device, st);
}

// Blocks of gru_fwd the card holds at once at this shape's shared memory
// (0 when a block cannot have that much), or minus a cudaError_t.
int gru_fwd_capacity(int B, int H, int device) {
  return lstm::resident_capacity(gru_fwd_kernel, sizeof(float) * fwd_smem_floats(B, H), device);
}

const char* gru_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
