// Fused LSTM backward for Hopper (sm_90a), float32: K7.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py:91 _lstm_bwd_kernel
// (launched by lstm_fused_grad through pl.pallas_call): the reverse-time
// LSTM backward from the forward's saved hs/cs [B, T, H] and the
// cotangents dhs/dcs [B, T, H].  Per step it recomputes the gates from
// hs[t-1] (h0 at t = 0), folds (1 - m) into the dh/dc carries so masked
// steps pass gradients straight through, and emits dxproj [B, T, 4H]; it
// sums dW [H, 4H] and ends with dh0 and dc0 [B, H].
//
// The TPU kernel walks the reversed time axis on one core with the dh/dc
// carries and the whole dW accumulator in VMEM, so it keeps the three
// products of a step together.  Only one of them depends on the backward
// carry, so here they are three launches on the stream:
//
//   (A) lstm_bwd_gates: the post-activation gates of every (row, step)
//       at once, [hs shifted one step (h0 at t = 0)] . W + xproj, one GEMM
//       over the B*T rows with the activations in its epilogue.  It writes
//       them into dxproj's own buffer, which (B) overwrites with the gate
//       gradients: no memory beyond the outputs.
//   (B) lstm_bwd_recurrence: the serial part, dh_prev = dgates[t] . W^T +
//       the masked pass-through, and the elementwise backward of the cell.
//       One cooperative persistent launch: batch rows are independent in
//       the recurrence, so the grid is (slots of batch groups of R rows) x
//       (blocks of 16 hidden units), and each group barriers on its own
//       counter once a step.  A slot takes the groups slot, slot + slots,
//       ... in turn, so any batch runs once ceil(H / 16) blocks are
//       resident.  A block keeps W[its units, :] in shared memory for
//       the whole sequence; a step it forms its units' gate gradients
//       (reading the gates (A) left at those addresses and writing the
//       gradients over them), then, after the group's barrier, reads the
//       group's rows of dgates[t] (R x 4H, cp.async, double-buffered) and
//       multiplies them by W^T.  A 16-row tile whose rows are all masked
//       at t is not read or multiplied (its gradients are zeros), and a
//       group with no live row skips the barrier and the product.
//   (C) lstm_bwd_dw: dW = Hprev^T . dgates as one product over all B*T
//       rows, split K-wise when the output tiles alone cannot fill the
//       card; a 32-row chunk whose rows are all masked adds nothing and is
//       skipped.  The splits of a tile add their partial sums into dW in
//       the fixed order 0, 1, 2, ... (each waits for the previous one's
//       flag), so the result does not depend on scheduling; the only
//       atomics are the barrier and flag counters.
//
// Why the in-place reuse of dxproj is safe: the gates of (row b, step t,
// unit j) are read only by the block that owns (b's group, j), in (B)'s
// step t, before that block writes the gradients of the same (b, t, j)
// over them; other blocks read dgates[t] only after the group's barrier of
// step t, which every writer of step t has passed.  A masked step's gates
// are never read: its gradients are written as zeros.
//
// Products are float32-equivalent: split TF32 on the tensor cores
// (tf32x3.cuh), three mma.sync products a term.
//
// Bound.  At the bench shape B = 128, T = 128, H = 512 the three products
// are each 2 * (live (row, step) pairs) * H * 4H float32 operations:
// 103.1 GFLOP together at full lengths, 52% of it for the bench's ragged
// lengths 16..128; over about 412 MB of inputs and outputs (0.123 ms).
// In split TF32 the operations run at a third of the tensor cores' TF32
// rate (495 TFLOP/s on an H100 SXM), 165 TFLOP/s: bound by them, 0.625 ms
// at full lengths, 0.324 ms ragged.  Per launch: (A) and (C) are GEMMs
// with 64 x 128 tiles, K 32 deep, three stages of cp.async, bound by that
// rate; they skip what the mask makes zero.  (B) is 128 dependent
// steps; a block's step reads 256 KB of dgates through L2 and waits for
// its group, so it is bound by L2 bandwidth and barrier latency, not by
// operations: it keeps W on chip, reads each group's rows only once a
// block, and prefetches the next step's cell inputs during the product.
//
// Entry point: lstm_bwd(), a plain C function called through ctypes on
// PyTorch's current stream (returns as lstm_fwd() does).

#include <algorithm>

#include "lstm_common.cuh"
#include "tf32x3.cuh"

namespace {

using lstm::kThreads;
using lstm::round_up;
using lstm::sigmoidf;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::mma3;

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
  float* dxproj;       // [B, T, 4H]: the gates after (A), dgates after (B)
  float* dw;           // [H, 4H]
  float* dh0;          // [B, H]
  float* dc0;          // [B, H]
  unsigned int* sync;  // [groups] group barriers of (B), then [tiles] flags of (C)
  int B, T, H;
  int groups;          // (B): batch groups of R rows
  int slots;           // (B): groups that run side by side
  int splits;          // (C): K-wise splits of each dW tile
};

// Row k of the flat (row, step) axis of Hprev: h0[b] at t = 0, else hs[b, t-1]
__device__ __forceinline__ const float* hprev_row(const BwdArgs& a, int k) {
  const int t = k % a.T;
  return t == 0 ? a.h0 + static_cast<size_t>(k / a.T) * a.H
                : a.hs + static_cast<size_t>(k - 1) * a.H;
}

__device__ __forceinline__ bool live_at(const BwdArgs& a, int k, int K) {
  return k < K && __ldg(a.mask + k) != 0.0f;  // mask's flat index is k
}

// ---------------------------------------------------------------------------
// (A) and (C): 64 x 128 output tiles, K 32 deep, 3 cp.async stages, 8 warps
// of 32 x 32 (2 x 4 mma tiles)
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 128, kBK = 32, kStages = 3;
constexpr int kLdK = kBK + 4;   // an A tile stored [m][k]
constexpr int kLdM = kBM + 8;   // an A tile stored [k][m]
constexpr int kLdN = kBN + 8;   // a B tile stored [k][n]
constexpr int kTileA = kBM * kLdK;
constexpr int kTileB = kBK * kLdN;
constexpr int kGemmStage = kTileA + kTileB;
constexpr size_t kGemmSmem = sizeof(float) * kStages * kGemmStage;
static_assert(kBM * kLdK == kBK * kLdM, "both A layouts fill one tile");

// B tile [k0, k0 + 32) x [n0, n0 + 128) of a row-major [K][N] operand
// whose row k starts at row(k); N % 4 == 0 and rows 16-byte aligned
template <typename RowFn>
__device__ __forceinline__ void load_b(float* Bs, RowFn row, int k0, int K, int n0, int N,
                                       const float* any) {
  for (int i = threadIdx.x; i < kBK * kBN / 4; i += kThreads) {
    const int kk = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
    const bool ok = k0 + kk < K && n0 + c < N;
    cp_async16(Bs + kk * kLdN + c, ok ? row(k0 + kk) + n0 + c : any, ok ? 16 : 0);
  }
}

// A tile [m0, m0 + 64) x [k0, k0 + 32), stored [m][k], of an operand
// whose row m (K contiguous values) starts at row(m)
template <bool VEC, typename RowFn>
__device__ __forceinline__ void load_a_mk(float* As, RowFn row, int m0, int M, int k0, int K,
                                          const float* any) {
  if (VEC) {  // K % 4 == 0: 16-byte pieces
    for (int i = threadIdx.x; i < kBM * kBK / 4; i += kThreads) {
      const int mm = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const bool ok = m0 + mm < M && k0 + c < K;
      cp_async16(As + mm * kLdK + c, ok ? row(m0 + mm) + k0 + c : any, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int mm = i / kBK, c = i % kBK;
      const bool ok = m0 + mm < M && k0 + c < K;
      cp_async4(As + mm * kLdK + c, ok ? row(m0 + mm) + k0 + c : any, ok ? 4 : 0);
    }
  }
}

// A tile [m0, m0 + 64) x [k0, k0 + 32), stored [k][m], of an operand
// stored transposed: row k (M contiguous values) starts at row(k)
template <bool VEC, typename RowFn>
__device__ __forceinline__ void load_a_km(float* As, RowFn row, int m0, int M, int k0, int K,
                                          const float* any) {
  if (VEC) {  // M % 4 == 0
    for (int i = threadIdx.x; i < kBK * kBM / 4; i += kThreads) {
      const int kk = i / (kBM / 4), c = (i % (kBM / 4)) * 4;
      const bool ok = k0 + kk < K && m0 + c < M;
      cp_async16(As + kk * kLdM + c, ok ? row(k0 + kk) + m0 + c : any, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kBM; i += kThreads) {
      const int kk = i / kBM, c = i % kBM;
      const bool ok = k0 + kk < K && m0 + c < M;
      cp_async4(As + kk * kLdM + c, ok ? row(k0 + kk) + m0 + c : any, ok ? 4 : 0);
    }
  }
}

// acc += A . B over one staged 32-deep tile, for this warp's 32 x 32
// (warp row wm of 2, warp column wn of 4); a dead 16-row tile is skipped
template <bool A_KM>
__device__ __forceinline__ void mma_tile(const float* As, const float* Bs,
                                         float (&acc)[2][4][4], int wm, int wn,
                                         const bool (&live)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    FragA fa[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!live[mt]) continue;
      const int m = wm * 32 + mt * 16 + g;
      if (A_KM) {
        const float* p = As + (kk + q) * kLdM + m;
        fa[mt].set(p[0], p[8], p[4 * kLdM], p[4 * kLdM + 8]);
      } else {
        const float* p = As + m * kLdK + kk + q;
        fa[mt].set(p[0], p[8 * kLdK], p[4], p[8 * kLdK + 4]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* p = Bs + (kk + q) * kLdN + wn * 32 + nt * 8 + g;
      FragB fb;
      fb.set(p[0], p[4 * kLdN]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (live[mt]) mma3(acc[mt][nt], fa[mt], fb);
      }
    }
  }
}

// (A): dxproj[m, n] = act_n(Hprev[m] . W[:, n] + xproj[m, n]) over the
// B*T rows m, for the rows of every 16-row tile with a live step
template <bool VEC>
__global__ void __launch_bounds__(kThreads) lstm_bwd_gates(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int M = a.B * a.T, N = 4 * a.H, K = a.H;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 2, wn = warp & 3;
  // a block whose 64 (row, step) pairs are all masked has no gate to give
  if (!__syncthreads_or(tid < kBM && live_at(a, m0 + tid, M))) return;
  bool live[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = m0 + wm * 32 + mt * 16 + g;
    live[mt] = __any_sync(0xffffffffu, live_at(a, r, M) || live_at(a, r + 8, M));
  }
  auto arow = [&](int m) { return hprev_row(a, m); };
  auto brow = [&](int k) { return a.w + static_cast<size_t>(k) * N; };
  const int nk = (K + kBK - 1) / kBK;
  float acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      float* st = smem + s * kGemmStage;
      load_a_mk<VEC>(st, arow, m0, M, s * kBK, K, a.w);
      load_b(st + kTileA, brow, s * kBK, K, n0, N, a.w);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = i + kStages - 1;
    if (nx < nk) {
      float* st = smem + (nx % kStages) * kGemmStage;
      load_a_mk<VEC>(st, arow, m0, M, nx * kBK, K, a.w);
      load_b(st + kTileA, brow, nx * kBK, K, n0, N, a.w);
    }
    cp_async_commit();
    const float* st = smem + (i % kStages) * kGemmStage;
    if (live[0] || live[1]) mma_tile<false>(st, st + kTileA, acc, wm, wn, live);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!live[mt]) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * q;  // N is even, so n + 1 < N too
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (m >= M) continue;
        const size_t off = static_cast<size_t>(m) * N + n;
        const float2 x = *reinterpret_cast<const float2*>(a.xproj + off);
        const float p0 = acc[mt][nt][2 * h] + x.x, p1 = acc[mt][nt][2 * h + 1] + x.y;
        float2 y;  // i, f, o: sigmoid; g (the third gate): tanh
        y.x = n / a.H == 2 ? tanhf(p0) : sigmoidf(p0);
        y.y = (n + 1) / a.H == 2 ? tanhf(p1) : sigmoidf(p1);
        *reinterpret_cast<float2*>(a.dxproj + off) = y;
      }
    }
  }
}

// (C): dW = Hprev^T . dgates, tile blockIdx.x % tiles, split blockIdx.x /
// tiles of the 32-row chunks; the splits of a tile add into dW in order.
// Two blocks an SM (128 registers a thread), so the bench's 128 tiles
// split in two fill the card twice over.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2) lstm_bwd_dw(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  unsigned* flags = reinterpret_cast<unsigned*>(smem + kStages * kGemmStage);
  const int M = a.H, N = 4 * a.H, K = a.B * a.T;
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles = tiles_m * ((N + kBN - 1) / kBN);
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int nchunks = (K + kBK - 1) / kBK;
  const int per = (nchunks + a.splits - 1) / a.splits;
  const int c0 = split * per, c1 = min(nchunks, c0 + per);
  const int nwords = max(0, (c1 - c0 + 31) / 32);
  // flags: bit i of word w is set when chunk c0 + 32 w + i has a live row
  for (int w = warp; w < nwords; w += kThreads / 32) {
    const int c = c0 + 32 * w + lane;
    bool lv = false;
    if (c < c1) {
#pragma unroll 8
      for (int r = 0; r < kBK; ++r) lv |= live_at(a, c * kBK + r, K);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, lv);
    if (lane == 0) flags[w] = bits;
  }
  __syncthreads();
  int n_live = 0;
  for (int w = 0; w < nwords; ++w) n_live += __popc(flags[w]);
  // the first live chunk at or after c (c1 when none)
  auto next_live = [&](int c) {
    while (c < c1) {
      const int w = (c - c0) >> 5;
      const unsigned bits = flags[w] >> ((c - c0) & 31);
      if (bits) return c + __ffs(bits) - 1;
      c = c0 + 32 * (w + 1);
    }
    return c1;
  };
  auto arow = [&](int k) { return hprev_row(a, k); };
  auto brow = [&](int k) { return a.dxproj + static_cast<size_t>(k) * N; };
  const bool live[2] = {true, true};
  float acc[2][4][4] = {};
  int pre = next_live(c0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_live) {
      float* st = smem + s * kGemmStage;
      load_a_km<VEC>(st, arow, m0, M, pre * kBK, K, a.hs);
      load_b(st + kTileA, brow, pre * kBK, K, n0, N, a.dxproj);
      pre = next_live(pre + 1);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n_live) {
      float* st = smem + ((i + kStages - 1) % kStages) * kGemmStage;
      load_a_km<VEC>(st, arow, m0, M, pre * kBK, K, a.hs);
      load_b(st + kTileA, brow, pre * kBK, K, n0, N, a.dxproj);
      pre = next_live(pre + 1);
    }
    cp_async_commit();
    const float* st = smem + (i % kStages) * kGemmStage;
    mma_tile<true>(st, st + kTileA, acc, wm, wn, live);
  }
  cp_async_wait<0>();

  unsigned int* flag = a.sync + a.groups + tile;
  if (a.splits > 1) {  // wait for splits 0 .. split - 1 of this tile
    if (tid == 0) {
      unsigned long long t0;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
      while (true) {
        unsigned int seen;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(flag) : "memory");
        if (static_cast<int>(seen) >= split) break;
        unsigned long long now;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
        if (now - t0 > 20000000000ull) __trap();
      }
      __threadfence();
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * q;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (m >= M) continue;
        float2* p = reinterpret_cast<float2*>(a.dw + static_cast<size_t>(m) * N + n);
        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (split > 0) {
          const float2 o = __ldcg(p);
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        *p = v;
      }
    }
  }
  if (a.splits > 1) {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicExch(flag, static_cast<unsigned int>(split + 1));
    }
  }
}

// ---------------------------------------------------------------------------
// (B): the recurrence
// ---------------------------------------------------------------------------

constexpr int kU = 16;                // hidden units a block owns
constexpr int kStageFloats = 8704;    // max over R of R x (8192 / R + 4)
constexpr int kRedFloats = 256 * kU;  // (8 / (R / 32)) x R x kU, for every R

__host__ __device__ inline int recur_ld(int H) { return round_up(4 * H, 32) + 4; }

size_t recur_smem_floats(int H) {
  return static_cast<size_t>(kU) * recur_ld(H) + 2 * kStageFloats + kRedFloats + 8;
}

// Batch groups of R rows (R / 32 warp rows x 8 / (R / 32) warp K-slices in
// the product) and 16 hidden units: blockIdx.x = slot * nu + unit block,
// and the slot's groups slot, slot + slots, ... one after the other.
template <int R>
__global__ void __launch_bounds__(kThreads) lstm_bwd_recurrence(const BwdArgs a) {
  constexpr int WM = R / 32, WK = 8 / WM, CK = 8192 / R, LDS = CK + 4;
  constexpr int P = R * kU / kThreads;  // (row, unit) pairs a thread carries
  static_assert(R * LDS <= kStageFloats && WK * R * kU == kRedFloats, "layout");
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, H4 = 4 * H;
  const int ldw = recur_ld(H);
  float* Ws = smem;                              // [kU][ldw]: W[j0 + u, :]
  float* stage = Ws + kU * ldw;                  // [2][R][LDS]: dgates[t] chunks
  float* red = stage + 2 * kStageFloats;         // [WK][R][kU]: K-slice partials
  unsigned* live = reinterpret_cast<unsigned*>(red + kRedFloats);  // [2][4]
  const int nu = (H + kU - 1) / kU;
  const int j0 = (blockIdx.x % nu) * kU;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp % WM, wk = warp / WM;

  for (int i = tid; i < kU * (ldw / 4); i += kThreads) {
    const int u = i / (ldw / 4), n = (i % (ldw / 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j0 + u < H && n < H4) {
      v = __ldg(reinterpret_cast<const float4*>(a.w + static_cast<size_t>(j0 + u) * H4 + n));
    }
    *reinterpret_cast<float4*>(Ws + u * ldw + n) = v;
  }

  for (int group = blockIdx.x / nu; group < a.groups; group += a.slots) {
    const int b0 = group * R;
    // pair p of this thread: row r = (tid + p * kThreads) / kU of the group,
    // unit u = the same % kU; its carries and the next step's cell inputs
    float dh[P], dc[P], pass[P] = {};
    float nm[P], ndh[P], ndc[P], nct[P], ncp[P], ngt[P][4];
    auto fetch = [&](int t) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int idx = tid + p * kThreads;
        const int b = b0 + idx / kU, j = j0 + idx % kU;
        if (b >= B || j >= H) continue;
        const size_t bt = static_cast<size_t>(b) * T + t;
        nm[p] = __ldg(a.mask + bt);
        ndh[p] = __ldg(a.dhs + bt * H + j);
        ndc[p] = __ldg(a.dcs + bt * H + j);
        nct[p] = __ldg(a.cs + bt * H + j);
        ncp[p] = t == 0 ? __ldg(a.c0 + static_cast<size_t>(b) * H + j) : __ldg(a.cs + (bt - 1) * H + j);
#pragma unroll
        for (int k = 0; k < 4; ++k) ngt[p][k] = __ldcg(a.dxproj + bt * H4 + k * H + j);
      }
    };
#pragma unroll
    for (int p = 0; p < P; ++p) dh[p] = dc[p] = 0.0f;
    fetch(T - 1);

    unsigned int passed = 0;
    for (int t = T - 1; t >= 0; --t) {
      // (1) the gate gradients of this block's pairs at t, and the dc carry
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int idx = tid + p * kThreads;
        const int b = b0 + idx / kU, j = j0 + idx % kU;
        if (b >= B || j >= H) continue;
        float* dx = a.dxproj + (static_cast<size_t>(b) * T + t) * H4 + j;
        const float m = nm[p];
        const float dh_total = ndh[p] + dh[p];
        const float dc_total = ndc[p] + dc[p];
        if (m == 0.0f) {  // a masked step passes both carries through
          dx[0] = dx[H] = dx[2 * H] = dx[3 * H] = 0.0f;
          dc[p] = dc_total;
          pass[p] = dh_total;
          continue;
        }
        const float ig = ngt[p][0], fg = ngt[p][1], gg = ngt[p][2], og = ngt[p][3];
        const float c_prev = ncp[p];
        const float dh_new = m * dh_total;
        float dc_new = m * dc_total;
        const float tc = tanhf(nct[p]);
        const float d_o = dh_new * tc;
        dc_new = dc_new + dh_new * og * (1.0f - tc * tc);
        const float d_i = dc_new * gg;
        const float d_f = dc_new * c_prev;
        const float d_g = dc_new * ig;
        dc[p] = dc_new * fg + (1.0f - m) * dc_total;
        pass[p] = (1.0f - m) * dh_total;
        dx[0] = d_i * ig * (1.0f - ig);
        dx[H] = d_f * fg * (1.0f - fg);
        dx[2 * H] = d_g * (1.0f - gg * gg);
        dx[3 * H] = d_o * og * (1.0f - og);
      }
      if (t > 0) fetch(t - 1);
      // which of the group's rows are live at t (double-buffered by parity:
      // a step with no live row has no barrier before the next step's write)
      unsigned* lw = live + (t & 1) * 4;
      if (warp < WM) {
        const int b = b0 + warp * 32 + lane;
        const bool lv = b < B && __ldg(a.mask + static_cast<size_t>(b) * T + t) != 0.0f;
        const unsigned bits = __ballot_sync(0xffffffffu, lv);
        if (lane == 0) lw[warp] = bits;
      }
      __syncthreads();
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < WM; ++w) any |= lw[w];
      if (any == 0) {  // dgates[t] of the group is zero: dh_prev is the pass-through
#pragma unroll
        for (int p = 0; p < P; ++p) dh[p] = pass[p];
        continue;
      }

      // every block of the group has written its gate gradients of step t
      passed += nu;
      lstm::grid_sync(a.sync + group, passed);

      // (2) dh_prev[rows, units] = dgates[t][rows, :] . W[units, :]^T
      const unsigned bits = lw[wm];
      const bool tl[2] = {(bits & 0xffffu) != 0u, (bits >> 16) != 0u};
      float acc[2][2][4] = {};
      const int nchunks = (H4 + CK - 1) / CK;
      const float* src = a.dxproj + static_cast<size_t>(t) * H4;
      auto load = [&](int c, float* st) {  // R rows x CK floats; masked rows zero
        for (int i = tid; i < R * CK / 4; i += kThreads) {
          const int r = i / (CK / 4), col = (i % (CK / 4)) * 4;
          const int n = c * CK + col;
          const bool ok = ((lw[r / 32] >> (r % 32)) & 1u) && n < H4;
          cp_async16(st + r * LDS + col,
                     ok ? src + static_cast<size_t>(b0 + r) * T * H4 + n : a.dxproj, ok ? 16 : 0);
        }
      };
      load(0, stage);
      cp_async_commit();
      for (int c = 0; c < nchunks; ++c) {
        if (c + 1 < nchunks) {
          load(c + 1, stage + ((c + 1) & 1) * kStageFloats);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (tl[0] || tl[1]) {
          const float* st = stage + (c & 1) * kStageFloats;
#pragma unroll
          for (int kk = 0; kk < 32; kk += 8) {
            const int kl = wk * 32 + kk;  // column inside the chunk
            // past 4H the stage holds zeros and a row of Ws ends at recur_ld(H)
            if (c * CK + kl >= H4) break;
            FragB fb[2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float* wr = Ws + (nt * 8 + g) * ldw + c * CK + kl + q;
              fb[nt].set(wr[0], wr[4]);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (!tl[mt]) continue;
              const float* ar = st + (wm * 32 + mt * 16 + g) * LDS + kl + q;
              FragA fa;
              fa.set(ar[0], ar[8 * LDS], ar[4], ar[8 * LDS + 4]);
              mma3(acc[mt][0], fa, fb[0]);
              mma3(acc[mt][1], fa, fb[1]);
            }
          }
        }
        __syncthreads();
      }
      // sum the K slices in a fixed order
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * 32 + mt * 16 + g + 8 * h;
            float* o = red + (wk * R + row) * kU + nt * 8 + 2 * q;
            o[0] = acc[mt][nt][2 * h];
            o[1] = acc[mt][nt][2 * h + 1];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int idx = tid + p * kThreads;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WK; ++w) s += red[w * R * kU + idx];
        dh[p] = s + pass[p];
      }
    }

#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int idx = tid + p * kThreads;
      const int b = b0 + idx / kU, j = j0 + idx % kU;
      if (b >= B || j >= H) continue;
      a.dh0[static_cast<size_t>(b) * H + j] = dh[p];
      a.dc0[static_cast<size_t>(b) * H + j] = dc[p];
    }
    // the next group rewrites the live flags, the stage and the partials
    __syncthreads();
  }
}

constexpr int kRowChoices[3] = {32, 64, 128};

using Kernel = void (*)(const BwdArgs);

Kernel recurrence_kernel(int R) {
  return R == 32 ? lstm_bwd_recurrence<32>
                 : (R == 64 ? lstm_bwd_recurrence<64> : lstm_bwd_recurrence<128>);
}

int gemm_tiles(int H) { return ((H + kBM - 1) / kBM) * ((4 * H + kBN - 1) / kBN); }

size_t dw_smem(int B, int T, int splits) {
  const int nchunks = (B * T + kBK - 1) / kBK;
  const int per = (nchunks + splits - 1) / splits;
  return kGemmSmem + sizeof(unsigned) * ((per + 31) / 32);
}

}  // namespace

extern "C" {

// Shared memory one block of the recurrence (B) takes at this shape (bytes).
int lstm_bwd_smem_bytes(int B, int H) {
  (void)B;
  return static_cast<int>(sizeof(float) * recur_smem_floats(H));
}

// 32-bit words of device memory lstm_bwd() needs for its barriers and flags.
int lstm_bwd_sync_words(int B, int H) { return (B + 31) / 32 + gemm_tiles(H); }

// xproj/dxproj [B, T, 4H], w/dw [H, 4H], h0/c0/dh0/dc0 [B, H], mask
// [B, T], hs/cs/dhs/dcs [B, T, H]: float32, contiguous, on `device`;
// barrier: lstm_bwd_sync_words(B, H) 32-bit words of device memory.
// Returns 0, a cudaError_t, kSmemOver or kNotResident.
int lstm_bwd(const void* xproj, const void* w, const void* h0, const void* c0,
             const void* mask, const void* hs, const void* cs, const void* dhs,
             const void* dcs, void* dxproj, void* dw, void* dh0, void* dc0, void* barrier,
             int B, int T, int H, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_b = sizeof(float) * recur_smem_floats(H);
  if (smem_b > static_cast<size_t>(smem_max)) return lstm::kSmemOver;

  // (B)'s batch group: the smallest that lets every group run side by
  // side; when none does, groups of 128 rows, as many side by side as the
  // card holds and the rest in turn
  const int nu = (H + kU - 1) / kU;
  int R = 0, cap = 0;
  for (int r : kRowChoices) {
    cap = lstm::resident_capacity(recurrence_kernel(r), smem_b, device);
    if (cap < 0) return -cap;
    R = r;
    if (((B + r - 1) / r) * nu <= cap) break;
  }
  if (cap < nu) return lstm::kNotResident;

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
  a.sync = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  a.groups = (B + R - 1) / R;
  a.slots = std::min(a.groups, cap / nu);

  // (C)'s split: enough blocks to fill the card, at least 16 chunks a split
  const bool vec = H % 4 == 0;
  const Kernel dw_k = vec ? lstm_bwd_dw<true> : lstm_bwd_dw<false>;
  const int tiles = gemm_tiles(H);
  const int nchunks = (B * T + kBK - 1) / kBK;
  const int cap_c = lstm::resident_capacity(dw_k, dw_smem(B, T, 1), device);
  if (cap_c < 0) return -cap_c;
  a.splits = std::max(1, std::min({4, cap_c / tiles, nchunks / 16}));

  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int) * (a.groups + tiles), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // (A)
  const Kernel gates_k = vec ? lstm_bwd_gates<true> : lstm_bwd_gates<false>;
  err = cudaFuncSetAttribute(gates_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kGemmSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a((B * T + kBM - 1) / kBM, (4 * H + kBN - 1) / kBN);
  gates_k<<<grid_a, kThreads, kGemmSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // (B)
  int rc = lstm::launch_cooperative(recurrence_kernel(R), a, a.slots * nu, smem_b, device, st);
  if (rc != 0) return rc;

  // (C)
  const size_t smem_c = dw_smem(B, T, a.splits);
  if (a.splits > 1) {
    return lstm::launch_cooperative(dw_k, a, tiles * a.splits, smem_c, device, st);
  }
  err = cudaFuncSetAttribute(dw_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_k<<<tiles, kThreads, smem_c, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the recurrence (B) the card holds at once at this shape's
// shared memory (0 when a block cannot have that much), or minus a
// cudaError_t.  kernels/rnn.py's gate needs ceil(H / 16): one slot.
int lstm_bwd_capacity(int B, int H, int device) {
  (void)B;
  return lstm::resident_capacity(lstm_bwd_recurrence<128>,
                                 sizeof(float) * recur_smem_floats(H), device);
}

const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
