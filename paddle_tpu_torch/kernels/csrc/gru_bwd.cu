// Fused GRU backward for Hopper (sm_90a), float32: K8b.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py _gru_bwd_kernel
// (launched by gru_fused_grad through pl.pallas_call): the reverse-time
// GRU backward from the forward's saved hs [B, T, H] and the cotangent
// dhs [B, T, H].  It recomputes the gates from hs[t-1] (h0 at t = 0),
// folds (1 - m) into the dh carry so masked steps pass the gradient
// straight through, and emits dxproj [B, T, 3H] (da = [du', dr'] and db,
// the pre-activation gradients), dw [H, 3H] and dh0 [B, H].
//
// Design (lstm_common.cuh / gru_common.cuh for the launch and the
// ownership of units).  The TPU walked the reversed time axis with the dh
// carry and the dW accumulator in VMEM, recomputing each step's gates in
// its grid step.  Here:
//   (p) the gates of every step are recomputed first, all steps at once,
//       since hs holds every h_{t-1}: u and r of the block's units, then
//       one grid barrier, then c from every unit's r ⊙ h_{t-1}.  u, r and
//       c are parked in dxproj (each slot is overwritten by its gradient
//       in the walk below) and r ⊙ h_{t-1} in a [T, B, H] scratch.
//   Each reversed step t then has two all-unit products, hence two grid
//   barriers:
//   (a) from the block's own units: dh_total = dhs[t] + dh, du, db;
//       db goes into dxproj[t] (candidate slots); barrier;
//   (b) drh = db · w_c^T over every unit's db, for the block's units
//       (their rows of w_c in shared memory), then dr and da = [du', dr']
//       into dxproj[t] (update/reset slots); barrier;
//   (c) dh_{t-1} = the pass-through parts + da · w_uz^T over every unit's
//       da, for the block's units (their rows of w_uz in shared memory).
//   Last, each block forms the dw columns of its own units,
//   dw[:, uz] = sum_t sum_b h_{t-1}^T da and dw[:, c] = sum (r ⊙ h_{t-1})^T db,
//   from the dxproj columns it wrote itself, in a fixed order (t, then b).
// No atomics and no reduction across blocks, so repeated runs are bit
// identical.
//
// Bound.  At the machine-translation shape B = 64, T = 32, H = 256: the
// gate recompute (2 * B * T * H * 3H), drh (2 * B * T * H * H), dh_{t-1}
// (2 * B * T * 2H * H) and dw (2 * B * T * H * 3H) are 2.42 GFLOP of
// float32 together, over about 16 MB of inputs and outputs: bound by the
// float32 rate (67 TFLOP/s on an H100 SXM), 0.036 ms.  This first version
// pays 2T + 1 grid barriers and re-reads [B, H] or [B, 2H] from L2 per
// block and phase; its time beside the bound is in PERF.md.
//
// Entry point: gru_bwd(), a plain C function called through ctypes on
// PyTorch's current stream (returns as gru_fwd() does).

#include "gru_common.cuh"

namespace {

using namespace gru;
using lstm::grid_sync;
using lstm::reduce_split;
using lstm::rows_times_slice;
using lstm::sigmoidf;

struct BwdArgs {
  const float* xproj;  // [B, T, 3H]
  const float* w;      // [H, 3H]
  const float* h0;     // [B, H]
  const float* mask;   // [B, T]
  const float* hs;     // [B, T, H]
  const float* dhs;    // [B, T, H]
  float* dxproj;       // [B, T, 3H]
  float* dw;           // [H, 3H]
  float* dh0;          // [B, H]
  float* rh;           // [T, B, H] scratch: r ⊙ h_{t-1} of every step
  unsigned int* barrier;
  int B, T, H;
};

constexpr int kG = 3 * kUnits;  // dxproj columns of a block's units

size_t bwd_smem_floats(int B, int H) {
  const size_t Hp = round_up(H, kTile);
  const size_t H2p = round_up(2 * H, kTile);
  return Hp * kUZ          // Wuz: update/reset columns of the block's units
         + Hp * kUnits     // Wc: candidate columns
         + Hp * kUnits     // WcT: w[units, 2H:3H], transposed
         + H2p * kUnits    // WuzT: w[units, 0:2H], transposed
         + kTileFloats     // staging tile
         + static_cast<size_t>(B) * kUnits * 3  // dh carry, du, dh_{t-1} part
         + static_cast<size_t>(B) * kG;         // a step's dxproj columns (dw)
}

__global__ void __launch_bounds__(kThreads) gru_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, H3 = 3 * a.H;
  const int Hp = round_up(H, kTile);
  const int H2p = round_up(2 * H, kTile);
  float* Wuz = smem;                   // [Hp][kUZ]
  float* Wc = Wuz + Hp * kUZ;          // [Hp][kUnits]
  float* WcT = Wc + Hp * kUnits;       // [Hp][kUnits]
  float* WuzT = WcT + Hp * kUnits;     // [H2p][kUnits]
  float* tile = WuzT + H2p * kUnits;   // [kRows][kTileStride]
  float* dh_car = tile + kTileFloats;  // [B][kUnits]
  float* du_s = dh_car + B * kUnits;   // [B][kUnits]
  float* dhp_s = du_s + B * kUnits;    // [B][kUnits]
  float* g_s = dhp_s + B * kUnits;     // [B][kG]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kUnits;
  const int r = tid % kRows;
  const int ks = tid / kRows;
  const size_t row = static_cast<size_t>(T) * H;    // hs/dhs batch stride
  const size_t row3 = static_cast<size_t>(T) * H3;  // xproj/dxproj batch stride
  const size_t plane = static_cast<size_t>(B) * H;  // one step of the scratch

  load_gate_cols(a.w, H, j0, 0, 2, Wuz);
  load_gate_cols(a.w, H, j0, 2, 1, Wc);
  load_unit_rows(a.w, H, j0, 2 * H, H, WcT);
  load_unit_rows(a.w, H, j0, 0, 2 * H, WuzT);
  for (int idx = tid; idx < B * kUnits; idx += kThreads) dh_car[idx] = 0.0f;

  // (p1) u and r of every step for this block's units; r ⊙ h_{t-1}
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
    const size_t hstride = t == 0 ? static_cast<size_t>(H) : row;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kUZ];
      rows_times_slice<kUZ>(hprev, hstride, B, b0, H, Wuz, tile, acc);
      reduce_split<kUZ>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
      const float* x = a.xproj + b * row3 + static_cast<size_t>(t) * H3;
      float* dx = a.dxproj + b * row3 + static_cast<size_t>(t) * H3;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int j = j0 + u;
        if (j >= H) continue;
        const float uu = sigmoidf(x[j] + acc[u]);
        const float rr = sigmoidf(x[H + j] + acc[kUnits + u]);
        dx[j] = uu;
        dx[H + j] = rr;
        a.rh[t * plane + static_cast<size_t>(b) * H + j] = rr * hprev[b * hstride + j];
      }
    }
  }
  unsigned int passed = gridDim.x;
  grid_sync(a.barrier, passed);

  // (p2) c of every step from every unit's r ⊙ h_{t-1}
  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kUnits];
      rows_times_slice<kUnits>(a.rh + t * plane, H, B, b0, H, Wc, tile, acc);
      reduce_split<kUnits>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
      const float* x = a.xproj + b * row3 + static_cast<size_t>(t) * H3;
      float* dx = a.dxproj + b * row3 + static_cast<size_t>(t) * H3;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int j = j0 + u;
        if (j < H) dx[2 * H + j] = tanhf(x[2 * H + j] + acc[u]);
      }
    }
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* hprev = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
    const size_t hstride = t == 0 ? static_cast<size_t>(H) : row;
    const float* dx_t = a.dxproj + static_cast<size_t>(t) * H3;

    // (a) the block's own units: du, db, and the pass-through part of dh_{t-1}
    __syncthreads();  // (c) of the step before wrote dh_car row by row
    for (int idx = tid; idx < B * kUnits; idx += kThreads) {
      const int b = idx / kUnits;
      const int j = j0 + idx % kUnits;
      if (j >= H) continue;
      float* dx = a.dxproj + b * row3 + static_cast<size_t>(t) * H3;
      const float uu = __ldcg(dx + j);
      const float c = __ldcg(dx + 2 * H + j);
      const float hp = __ldcg(hprev + b * hstride + j);
      const float m = a.mask[static_cast<size_t>(b) * T + t];
      const float dht = a.dhs[b * row + static_cast<size_t>(t) * H + j] + dh_car[idx];
      const float din = m * dht;
      du_s[idx] = din * (hp - c);
      dhp_s[idx] = din * uu + (1.0f - m) * dht;
      const float dc = din * (1.0f - uu);
      dx[2 * H + j] = dc * (1.0f - c * c);
    }
    passed += gridDim.x;
    grid_sync(a.barrier, passed);

    // (b) drh = db · w_c^T over every unit, then dr and da of the block's units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kUnits];
      rows_times_slice<kUnits>(dx_t + 2 * H, row3, B, b0, H, WcT, tile, acc);
      reduce_split<kUnits>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
      float* dx = a.dxproj + b * row3 + static_cast<size_t>(t) * H3;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int j = j0 + u;
        if (j >= H) continue;
        const int cu = b * kUnits + u;
        const float uu = __ldcg(dx + j);
        const float rr = __ldcg(dx + H + j);
        const float hp = __ldcg(hprev + b * hstride + j);
        const float drh = acc[u];
        const float dr = drh * hp;
        dhp_s[cu] = dhp_s[cu] + drh * rr;
        dx[j] = du_s[cu] * uu * (1.0f - uu);
        dx[H + j] = dr * rr * (1.0f - rr);
      }
    }
    passed += gridDim.x;
    grid_sync(a.barrier, passed);

    // (c) dh_{t-1} = the pass-through parts + da · w_uz^T over every unit
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kUnits];
      rows_times_slice<kUnits>(dx_t, row3, B, b0, 2 * H, WuzT, tile, acc);
      reduce_split<kUnits>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int cu = b * kUnits + u;
        dh_car[cu] = acc[u] + dhp_s[cu];
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < B * kUnits; idx += kThreads) {
    const int j = j0 + idx % kUnits;
    if (j < H) a.dh0[static_cast<size_t>(idx / kUnits) * H + j] = dh_car[idx];
  }

  // dw[:, block columns]: sum over t, then b, of h_{t-1}^T da and
  // (r ⊙ h_{t-1})^T db; g_s holds step t's dxproj columns of the block
  for (int k0 = 0; k0 < H; k0 += kThreads) {
    const int k = k0 + tid;
    float acc[kG];
#pragma unroll
    for (int c = 0; c < kG; ++c) acc[c] = 0.0f;
    for (int t = 0; t < T; ++t) {
      __syncthreads();  // the previous step's columns are no longer read
      for (int idx = tid; idx < B * kG; idx += kThreads) {
        const int b = idx / kG;
        const int c = idx - b * kG;
        const int j = j0 + c % kUnits;
        g_s[idx] = j < H ? __ldcg(a.dxproj + b * row3 + static_cast<size_t>(t) * H3 +
                                  (c / kUnits) * H + j)
                         : 0.0f;
      }
      __syncthreads();
      if (k >= H) continue;
      const float* hprev = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
      const size_t hstride = t == 0 ? static_cast<size_t>(H) : row;
      const float* rh_t = a.rh + t * plane;
      for (int b = 0; b < B; ++b) {
        const float hv = __ldcg(hprev + b * hstride + k);
        const float rv = __ldcg(rh_t + static_cast<size_t>(b) * H + k);
        const float* g = g_s + b * kG;
#pragma unroll
        for (int c = 0; c < kUZ; ++c) acc[c] = fmaf(hv, g[c], acc[c]);
#pragma unroll
        for (int c = kUZ; c < kG; ++c) acc[c] = fmaf(rv, g[c], acc[c]);
      }
    }
    if (k >= H) continue;
#pragma unroll
    for (int c = 0; c < kG; ++c) {
      const int j = j0 + c % kUnits;
      if (j < H) a.dw[static_cast<size_t>(k) * H3 + (c / kUnits) * H + j] = acc[c];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block of gru_bwd takes at this shape (bytes).
int gru_bwd_smem_bytes(int B, int H) {
  return static_cast<int>(sizeof(float) * bwd_smem_floats(B, H));
}

// xproj/dxproj [B, T, 3H], w/dw [H, 3H], h0/dh0 [B, H], mask [B, T],
// hs/dhs [B, T, H], rh [T, B, H]: float32, contiguous, on `device`;
// barrier: one 32-bit word of device memory.  Returns 0, a cudaError_t,
// kSmemOver or kNotResident.
int gru_bwd(const void* xproj, const void* w, const void* h0, const void* mask,
            const void* hs, const void* dhs, void* dxproj, void* dw, void* dh0, void* rh,
            void* barrier, int B, int T, int H, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdArgs a{};
  a.xproj = static_cast<const float*>(xproj);
  a.w = static_cast<const float*>(w);
  a.h0 = static_cast<const float*>(h0);
  a.mask = static_cast<const float*>(mask);
  a.hs = static_cast<const float*>(hs);
  a.dhs = static_cast<const float*>(dhs);
  a.dxproj = static_cast<float*>(dxproj);
  a.dw = static_cast<float*>(dw);
  a.dh0 = static_cast<float*>(dh0);
  a.rh = static_cast<float*>(rh);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return lstm::launch_cooperative(gru_bwd_kernel, a, round_up(H, kUnits) / kUnits,
                                  sizeof(float) * bwd_smem_floats(B, H), device, st);
}

// Blocks of gru_bwd the card holds at once at this shape's shared memory
// (0 when a block cannot have that much), or minus a cudaError_t.
int gru_bwd_capacity(int B, int H, int device) {
  return lstm::resident_capacity(gru_bwd_kernel, sizeof(float) * bwd_smem_floats(B, H), device);
}

const char* gru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
