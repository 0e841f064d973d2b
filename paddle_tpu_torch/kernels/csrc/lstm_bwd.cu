// Fused LSTM backward for Hopper (sm_90a), float32: K7.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py _lstm_bwd_kernel
// (launched by lstm_fused_grad through pl.pallas_call): the reverse-time
// LSTM backward from the forward's saved hs/cs [B, T, H] and the
// cotangents dhs/dcs [B, T, H].  Per step it recomputes the gates from
// hs[t-1] (h0 at t = 0), folds (1 - m) into the dh/dc carries so masked
// steps pass gradients straight through, and emits dxproj [B, T, 4H]; it
// accumulates dW [H, 4H] and ends with dh0 and dc0 [B, H].
//
// Design (lstm_common.cuh for the launch and the ownership of units).
// The TPU walked the reversed time axis with the dh/dc carries and the
// full dW accumulator in VMEM.  Here block x owns 4 hidden units and
// keeps three things in shared memory for the whole sequence: its 16
// columns of W (to recompute its gates), W's 4 rows of those units (to
// form their dh_prev), and its 16 columns of dW as a float32 accumulator;
// the carries of its units live there too.  Each reversed step t:
//   (a) the block recomputes its [B, 16] pre-activations from hs[t-1],
//       forms its units' gate gradients and writes them into dxproj[t]
//       (an output anyway), keeping a copy in shared memory, and updates
//       its dc carry, which needs nothing from other units;
//   (b) one grid barrier: dxproj[t] is complete;
//   (c) it reads all of dxproj[t] [B, 4H] (through L2) to form dh_prev of
//       its own units against W's rows, and adds h_{t-1}^T dgates into
//       its dW columns.
// No atomics and no reduction across blocks, so the result does not
// depend on scheduling; dh0, dc0 and dW are written after the last step.
//
// Bound.  At the bench shape B = 128, T = 128, H = 512: the gate
// recompute, dh_prev and dW are each 2 * B * H * 4H * T = 34.4 GFLOP of
// float32, 103.1 GFLOP together, over about 403 MB of inputs and
// outputs: bound by the float32 rate (67 TFLOP/s on an H100 SXM),
// 1.539 ms.  This first version reads h_{t-1} twice and dxproj[t] once
// from L2 per block and step and pays one grid barrier a step; its time
// beside the bound is in PERF.md.
//
// Entry point: lstm_bwd(), a plain C function called through ctypes on
// PyTorch's current stream (returns as lstm_fwd() does).

#include "lstm_common.cuh"

namespace {

using namespace lstm;

struct BwdArgs {
  const float* xproj;  // [B, T, 4H]
  const float* w;      // [H, 4H]
  const float* h0;     // [B, H]
  const float* c0;     // [B, H]
  const float* mask;   // [B, T]
  const float* hs;     // [B, T, H]
  const float* cs;     // [B, T, H]
  const float* dhs;    // [B, T, H]
  const float* dcs;    // [B, T, H]
  float* dxproj;       // [B, T, 4H]
  float* dw;           // [H, 4H]
  float* dh0;          // [B, H]
  float* dc0;          // [B, H]
  unsigned int* barrier;
  int B, T, H;
};

// floats a row of the batch keeps in shared memory: its 16 gate
// gradients of the step, and the dc carry, dh carry and the masked
// pass-through of dh for each of the 4 units
constexpr int kRowFloats = kCols + 3 * kUnits;

size_t bwd_smem_floats(int B, int H) {
  const size_t Hp = round_up(H, kTile);
  const size_t Np = round_up(4 * H, kTile);
  return Hp * kCols           // Ws: W[:, block columns]
         + Np * kUnits        // Wr: W[block units, :], transposed [4H][4]
         + Hp * kCols         // acc_dw
         + kTileFloats        // staging tile
         + static_cast<size_t>(B) * kRowFloats;
}

__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H;
  const int Hp = round_up(H, kTile);
  const int Np = round_up(4 * H, kTile);
  float* Ws = smem;                        // [Hp][kCols]
  float* Wr = Ws + Hp * kCols;             // [Np][kUnits]
  float* acc_dw = Wr + Np * kUnits;        // [Hp][kCols]
  float* tile = acc_dw + Hp * kCols;       // [kRows][kTileStride]
  float* dgs = tile + kTileFloats;         // [B][kCols]
  float* dc_car = dgs + static_cast<size_t>(B) * kCols;  // [B][kUnits]
  float* dh_car = dc_car + B * kUnits;     // [B][kUnits]
  float* dh_pass = dh_car + B * kUnits;    // [B][kUnits]

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kUnits;
  const int r = tid % kRows;
  const int ks = tid / kRows;
  const int H4 = 4 * H;
  const size_t row = static_cast<size_t>(T) * H;    // hs/cs/dhs/dcs batch stride
  const size_t row4 = static_cast<size_t>(T) * H4;  // xproj/dxproj batch stride

  load_w_slice(a.w, H, j0, Ws);
  for (int idx = tid; idx < Np * kUnits; idx += kThreads) {
    const int n = idx / kUnits;
    const int j = j0 + idx % kUnits;
    Wr[idx] = (n < H4 && j < H) ? a.w[static_cast<size_t>(j) * H4 + n] : 0.0f;
  }
  for (int idx = tid; idx < Hp * kCols; idx += kThreads) acc_dw[idx] = 0.0f;
  for (int idx = tid; idx < B * kUnits; idx += kThreads) {
    dc_car[idx] = 0.0f;
    dh_car[idx] = 0.0f;
  }

  unsigned int passed = 0;
  for (int t = T - 1; t >= 0; --t) {
    const float* hprev = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
    const size_t hstride = t == 0 ? static_cast<size_t>(H) : row;

    // (a) gates of this block's units, their gradients, the dc carry
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kCols];
      rows_times_slice<kCols>(hprev, hstride, B, b0, H, Ws, tile, acc);
      reduce_split<kCols>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
      const float m = a.mask[static_cast<size_t>(b) * T + t];
      const size_t bt = b * row + static_cast<size_t>(t) * H;
      const float* x = a.xproj + b * row4 + static_cast<size_t>(t) * H4;
      float* dx = a.dxproj + b * row4 + static_cast<size_t>(t) * H4;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int j = j0 + u;
        float* dg = dgs + b * kCols + u;
        if (j >= H) {
          dg[0 * kUnits] = dg[1 * kUnits] = dg[2 * kUnits] = dg[3 * kUnits] = 0.0f;
          continue;
        }
        const float ig = sigmoidf(acc[0 * kUnits + u] + x[j]);
        const float fg = sigmoidf(acc[1 * kUnits + u] + x[H + j]);
        const float gg = tanhf(acc[2 * kUnits + u] + x[2 * H + j]);
        const float og = sigmoidf(acc[3 * kUnits + u] + x[3 * H + j]);
        const float c_prev = t == 0 ? a.c0[static_cast<size_t>(b) * H + j] : a.cs[bt - H + j];
        const float c_t = a.cs[bt + j];
        const int cu = b * kUnits + u;
        const float dh_total = a.dhs[bt + j] + dh_car[cu];
        const float dc_total = a.dcs[bt + j] + dc_car[cu];
        const float dh_new = m * dh_total;
        float dc_new = m * dc_total;
        const float tc = tanhf(c_t);
        const float d_o = dh_new * tc;
        dc_new = dc_new + dh_new * og * (1.0f - tc * tc);
        const float d_i = dc_new * gg;
        const float d_f = dc_new * c_prev;
        const float d_g = dc_new * ig;
        dc_car[cu] = dc_new * fg + (1.0f - m) * dc_total;
        dh_pass[cu] = (1.0f - m) * dh_total;
        const float gi = d_i * ig * (1.0f - ig);
        const float gf = d_f * fg * (1.0f - fg);
        const float gc = d_g * (1.0f - gg * gg);
        const float go = d_o * og * (1.0f - og);
        dx[j] = gi;
        dx[H + j] = gf;
        dx[2 * H + j] = gc;
        dx[3 * H + j] = go;
        dg[0 * kUnits] = gi;
        dg[1 * kUnits] = gf;
        dg[2 * kUnits] = gc;
        dg[3 * kUnits] = go;
      }
    }

    // (b) every block's gate gradients of step t are in dxproj
    passed += gridDim.x;
    grid_sync(a.barrier, passed);

    // (c1) dh_prev of this block's units: dxproj[t] [B, 4H] x W[units, :]^T
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kUnits];
      rows_times_slice<kUnits>(a.dxproj + static_cast<size_t>(t) * H4, row4, B, b0, H4, Wr,
                               tile, acc);
      reduce_split<kUnits>(tile, acc);
      const int b = b0 + r;
      if (ks != 0 || b >= B) continue;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        dh_car[b * kUnits + u] = acc[u] + dh_pass[b * kUnits + u];
      }
    }

    // (c2) dW[:, block columns] += h_{t-1}^T dgates[:, block columns]
    for (int k = tid; k < H; k += kThreads) {
      float acc[kCols];
      float4* dst = reinterpret_cast<float4*>(acc_dw + k * kCols);
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        const float4 v = dst[c];
        acc[4 * c + 0] = v.x;
        acc[4 * c + 1] = v.y;
        acc[4 * c + 2] = v.z;
        acc[4 * c + 3] = v.w;
      }
#pragma unroll 4
      for (int b = 0; b < B; ++b) {
        const float hv = hprev[b * hstride + k];
        const float4* dg = reinterpret_cast<const float4*>(dgs + b * kCols);
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) {
          const float4 d = dg[c];
          acc[4 * c + 0] = fmaf(hv, d.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(hv, d.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(hv, d.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(hv, d.w, acc[4 * c + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        dst[c] = make_float4(acc[4 * c + 0], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < B * kUnits; idx += kThreads) {
    const int b = idx / kUnits;
    const int j = j0 + idx % kUnits;
    if (j < H) {
      a.dh0[static_cast<size_t>(b) * H + j] = dh_car[idx];
      a.dc0[static_cast<size_t>(b) * H + j] = dc_car[idx];
    }
  }
  for (int idx = tid; idx < H * kCols; idx += kThreads) {
    const int k = idx / kCols;
    const int c = idx - k * kCols;
    const int j = j0 + c % kUnits;
    if (j < H) a.dw[static_cast<size_t>(k) * H4 + (c / kUnits) * H + j] = acc_dw[idx];
  }
}

}  // namespace

extern "C" {

// Shared memory one block of lstm_bwd takes at this shape (bytes).
int lstm_bwd_smem_bytes(int B, int H) {
  return static_cast<int>(sizeof(float) * bwd_smem_floats(B, H));
}

// xproj/dxproj [B, T, 4H], w/dw [H, 4H], h0/c0/dh0/dc0 [B, H], mask
// [B, T], hs/cs/dhs/dcs [B, T, H]: float32, contiguous, on `device`;
// barrier: one 32-bit word of device memory.  Returns 0, a cudaError_t,
// kSmemOver or kNotResident.
int lstm_bwd(const void* xproj, const void* w, const void* h0, const void* c0,
             const void* mask, const void* hs, const void* cs, const void* dhs,
             const void* dcs, void* dxproj, void* dw, void* dh0, void* dc0, void* barrier,
             int B, int T, int H, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdArgs a{};
  a.xproj = static_cast<const float*>(xproj);
  a.w = static_cast<const float*>(w);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.mask = static_cast<const float*>(mask);
  a.hs = static_cast<const float*>(hs);
  a.cs = static_cast<const float*>(cs);
  a.dhs = static_cast<const float*>(dhs);
  a.dcs = static_cast<const float*>(dcs);
  a.dxproj = static_cast<float*>(dxproj);
  a.dw = static_cast<float*>(dw);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.barrier = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_cooperative(lstm_bwd_kernel, a, round_up(H, kUnits) / kUnits,
                            sizeof(float) * bwd_smem_floats(B, H), device, st);
}

// Blocks of lstm_bwd the card holds at once at this shape's shared memory
// (0 when a block cannot have that much), or minus a cudaError_t.
int lstm_bwd_capacity(int B, int H, int device) {
  return resident_capacity(lstm_bwd_kernel, sizeof(float) * bwd_smem_floats(B, H), device);
}

const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
