// Fused GRU backward for Hopper (sm_90a), float32: K8b.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py:288 _gru_bwd_kernel
// (launched by gru_fused_grad through pl.pallas_call): the reverse-time
// GRU backward from the forward's saved hs [B, T, H] and the cotangent
// dhs [B, T, H].  It recomputes the gates [update u | reset r | candidate
// c] from hs[t-1] (h0 at t = 0), folds (1 - m) into the dh carry so masked
// steps pass the gradient straight through, and emits dxproj [B, T, 3H]
// (da = [du', dr'] and db, the pre-activation gradients), dw [H, 3H] =
// [h_{t-1}^T da | (r ⊙ h_{t-1})^T db] summed over (row, step), and dh0.
//
// The TPU kernel walks the reversed time axis on one core with the dh
// carry and the whole dW accumulator in VMEM.  Only the two products
// against the carry are serial, so here the work is three launches on
// the stream, as K7's (lstm_bwd.cu):
//
//   (A) gru_bwd_gates: the gates of every (row, step) at once, since hs
//       holds every h_{t-1}: two GEMMs over the B*T rows, h_prev . w_uz
//       (u and r, and r ⊙ h_prev into the rh scratch), then, after a grid
//       barrier, (r ⊙ h_prev) . w_c (c).  One cooperative persistent
//       launch that walks the output tiles of each GEMM in turn.  The
//       gates go into dxproj's own buffer, which (B) overwrites with the
//       gradients.
//   (B) gru_bwd_recurrence: the serial part.  One cooperative persistent
//       launch of (slots of batch groups of R rows) x (blocks of U hidden
//       units); each group has its own barrier counter, and a slot takes
//       its groups in turn, so any batch runs once ceil(H / U) blocks are
//       resident.  A block keeps w[its U units, :] (the rows of w_uz^T
//       and w_c^T it needs) in shared memory for the whole sequence: U =
//       16 up to H = 896, and 8 past it, where 16 units' rows no longer
//       fit a block (8 units take H up to 1,056 on an H100's 132 SMs).  A
//       step t:
//         1. the block's own (row, unit) pairs: dh_total, du, db; db goes
//            into dxproj[t]; arrive at the group barrier;
//         2. wait; drh = db . w_c^T over every unit's db of the group's live
//            rows, for the block's units; dr and da = [du', dr'] into
//            dxproj[t]; arrive;
//         3. wait; dh_{t-1} = the pass-through parts + da . w_uz^T.
//       Two barriers a step is the least: da_r needs every unit's drh, and
//       dh_{t-1} every unit's da.  Each product reads the group's LIVE rows
//       only, packed, by cp.async through L2 (rows masked at t have zero
//       gradients); a group with no live row at t skips both products and
//       both barriers.  A block arrives right after its writes and fetches
//       the next step's inputs while the others arrive.
//   (C) gru_bwd_dw: dw = [Hprev^T . da | RH^T . db] as one product over
//       the B*T rows, split K-wise when the output tiles alone cannot fill
//       the card; a 32-row chunk whose rows are all masked is skipped (a
//       block lists its live chunks a window of 1,024 at a time, so its
//       shared memory does not grow with B*T).  The splits of a tile add
//       into dw in the fixed order 0, 1, 2, ... (each waits for the
//       previous one's flag), so reruns are bit-identical.
//
// Every product is split TF32 on the tensor cores (tf32x3.cuh): three
// mma.sync products a term, each term summed in a fresh accumulator and
// added with a rounded float add (the tensor cores truncate as they
// accumulate).  No atomics but the barrier and flag counters.
//
// Why the in-place reuse of dxproj is safe: the gates of (row b, step t,
// unit j) are read only by the block that owns (b's group, j), before it
// writes that pair's gradients over them; other blocks read db of step t
// only after the group's first barrier of step t and da after the second,
// which every writer of step t has passed.  Masked pairs get zeros.
//
// Bound.  At the machine-translation shape B = 64, T = 32, H = 256 the
// products are 18 * H^2 float32 operations per live (row, step): the gate
// recompute (2 * H * 3H), drh (2 * H * H), da . w_uz^T (2 * 2H * H) and dw
// (2 * H * 3H), 2.42 GFLOP at full lengths, over about 16 MB of inputs
// and outputs.  In split TF32 they run at a third of the tensor cores'
// TF32 rate (165 TFLOP/s on an H100 SXM): 0.015 ms at full lengths.  The
// floor in practice is (B)'s T dependent steps, each two group barriers
// and two reads of the group's rows from L2; the times are in PERF.md.
//
// Entry point: gru_bwd(), a plain C function called through ctypes on
// PyTorch's current stream.  It zeroes the barriers and flags, launches
// (A), (B), (C) and returns 0, a cudaError_t, or kSmemOver/kNotResident
// when the shape cannot run; it never synchronises and allocates nothing.

#include <algorithm>

#include "lstm_common.cuh"
#include "tf32x3.cuh"

namespace {

using lstm::group_arrive;
using lstm::group_wait;
using lstm::kThreads;
using lstm::load_units;
using lstm::round_up;
using lstm::sigmoidf;
using lstm::store_units;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::mma_tf32;
using tf32x3::mma_tf32_first;

struct BwdArgs {
  const float* xproj;  // [B, T, 3H]
  const float* w;      // [H, 3H]
  const float* h0;     // [B, H]
  const float* mask;   // [B, T]
  const float* hs;     // [B, T, H]
  const float* dhs;    // [B, T, H]
  float* dxproj;       // [B, T, 3H]: the gates after (A), their gradients after (B)
  float* dw;           // [H, 3H]
  float* dh0;          // [B, H]
  float* rh;           // [B, T, H]: r ⊙ h_{t-1}, from (A)
  unsigned int* sync;  // [1] (A)'s grid barrier, [groups] (B)'s, [tiles] (C)'s split flags
  int B, T, H;
  int groups;          // (B): batch groups of R rows
  int slots;           // (B): groups that run side by side
  int splits;          // (C): K-wise splits of each dw tile
  int aligned;         // every tensor starts on a 16-byte boundary
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
// whose row k starts at row(k); VEC: N % 4 == 0 and rows 16-byte aligned
template <bool VEC, typename RowFn>
__device__ __forceinline__ void load_b(float* Bs, RowFn row, int k0, int K, int n0, int N,
                                       const float* any) {
  if (VEC) {
    for (int i = threadIdx.x; i < kBK * kBN / 4; i += kThreads) {
      const int kk = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const bool ok = k0 + kk < K && n0 + c < N;
      cp_async16(Bs + kk * kLdN + c, ok ? row(k0 + kk) + n0 + c : any, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      const bool ok = k0 + kk < K && n0 + c < N;
      cp_async4(Bs + kk * kLdN + c, ok ? row(k0 + kk) + n0 + c : any, ok ? 4 : 0);
    }
  }
}

// A tile [m0, m0 + 64) x [k0, k0 + 32): A_KM false, stored [m][k] from an
// operand whose row m (K contiguous values) starts at row(m); A_KM true,
// stored [k][m] from an operand stored transposed, row k (M contiguous
// values) at row(k)
template <bool VEC, bool A_KM, typename RowFn>
__device__ __forceinline__ void load_a(float* As, RowFn row, int m0, int M, int k0, int K,
                                       const float* any) {
  constexpr int kOuter = A_KM ? kBK : kBM, kInner = A_KM ? kBM : kBK;
  constexpr int kLd = A_KM ? kLdM : kLdK;
  const int o0 = A_KM ? k0 : m0, on = A_KM ? K : M;
  const int i0 = A_KM ? m0 : k0, in = A_KM ? M : K;
  if (VEC) {
    for (int i = threadIdx.x; i < kOuter * kInner / 4; i += kThreads) {
      const int o = i / (kInner / 4), c = (i % (kInner / 4)) * 4;
      const bool ok = o0 + o < on && i0 + c < in;
      cp_async16(As + o * kLd + c, ok ? row(o0 + o) + i0 + c : any, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kOuter * kInner; i += kThreads) {
      const int o = i / kInner, c = i % kInner;
      const bool ok = o0 + o < on && i0 + c < in;
      cp_async4(As + o * kLd + c, ok ? row(o0 + o) + i0 + c : any, ok ? 4 : 0);
    }
  }
}

// acc += A . B over one staged 32-deep tile, for this warp's 32 x 32
// (warp row wm of 2, warp column wn of 4), in split TF32: a term (one
// k8-step of one 16 x 8 tile) sums its three products in a fresh
// accumulator; a dead 16-row tile is skipped
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
      const int m = wm * 32 + mt * 16 + g;
      if (A_KM) {
        const float* p = As + (kk + q) * kLdM + m;
        fa[mt].set(p[0], p[8], p[4 * kLdM], p[4 * kLdM + 8]);
      } else {
        const float* p = As + m * kLdK + kk + q;
        fa[mt].set(p[0], p[8 * kLdK], p[4], p[8 * kLdK + 4]);
      }
    }
    FragB fb[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* p = Bs + (kk + q) * kLdN + wn * 32 + nt * 8 + g;
      fb[nt].set(p[0], p[4 * kLdN]);
    }
    float tmp[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (live[mt]) mma_tf32_first(tmp[mt][nt], fa[mt].lo, fb[nt].hi);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (live[mt]) mma_tf32(tmp[mt][nt], fa[mt].hi, fb[nt].lo);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (!live[mt]) continue;
        mma_tf32(tmp[mt][nt], fa[mt].hi, fb[nt].hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += tmp[mt][nt][e];
      }
    }
  }
}

__device__ __forceinline__ void clear(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
}

// One output tile: acc += A[m0:, :K] . B[:K, n0:] over the chunks
// `chunk(i)` (i < n) of kBK rows of the reduction axis, three stages in
// flight
template <bool VEC, bool A_KM, typename ARow, typename BRow, typename Chunk>
__device__ __forceinline__ void gemm_tile(float* smem, ARow arow, BRow brow, Chunk chunk, int n,
                                          int m0, int M, int n0, int N, int K, const float* any,
                                          int wm, int wn, const bool (&live)[2],
                                          float (&acc)[2][4][4]) {
  auto stage = [&](int i, int s) {
    float* st = smem + s * kGemmStage;
    load_a<VEC, A_KM>(st, arow, m0, M, chunk(i) * kBK, K, any);
    load_b<VEC>(st + kTileA, brow, chunk(i) * kBK, K, n0, N, any);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) stage(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i has landed, and chunk i - 1's stage is free
    if (i + kStages - 1 < n) stage(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const float* st = smem + (i % kStages) * kGemmStage;
    if (live[0] || live[1]) mma_tile<A_KM>(st, st + kTileA, acc, wm, wn, live);
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free for the next tile
}

// (A): dxproj[m, 0:2H] = sigmoid(Hprev[m] . w[:, 0:2H] + xproj[m, 0:2H])
// (u, r) and rh[m] = r ⊙ Hprev[m]; then, after a grid barrier,
// dxproj[m, 2H:3H] = tanh(rh[m] . w[:, 2H:3H] + xproj[m, 2H:3H]) (c), over
// the B*T rows m.  A warp's 16-row tile with no live row is not multiplied
// (its gates are never read); its rh rows are written as zeros, so that
// (C), which reads rh for every row of a chunk with a live row, multiplies
// finite values by the masked rows' zero db.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) gru_bwd_gates(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, H3 = 3 * H, M = a.B * a.T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int tiles_m = (M + kBM - 1) / kBM;
  const int nk = (H + kBK - 1) / kBK;
  auto chunk = [](int i) { return i; };
  for (int part = 0; part < 2; ++part) {
    const int N = part == 0 ? 2 * H : H;
    const int tiles = tiles_m * ((N + kBN - 1) / kBN);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
      bool live[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = m0 + wm * 32 + mt * 16 + g;
        live[mt] = __any_sync(0xffffffffu, live_at(a, r, M) || live_at(a, r + 8, M));
      }
      float acc[2][4][4];
      clear(acc);
      if (part == 0) {
        gemm_tile<VEC, false>(
            smem, [&](int m) { return hprev_row(a, m); },
            [&](int k) { return a.w + static_cast<size_t>(k) * H3; }, chunk, nk, m0, M, n0, N, H,
            a.w, wm, wn, live, acc);
      } else {
        gemm_tile<VEC, false>(
            smem, [&](int m) { return a.rh + static_cast<size_t>(m) * H; },
            [&](int k) { return a.w + static_cast<size_t>(k) * H3 + 2 * H; }, chunk, nk, m0, M,
            n0, N, H, a.w, wm, wn, live, acc);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + wm * 32 + mt * 16 + g + 8 * (e >> 1);
            const int n = n0 + wn * 32 + nt * 8 + 2 * q + (e & 1);
            if (m >= M || n >= N) continue;
            const size_t row = static_cast<size_t>(m);
            if (part == 0) {
              if (!live[mt]) {
                if (n >= H) a.rh[row * H + n - H] = 0.0f;
                continue;
              }
              const float v = sigmoidf(acc[mt][nt][e] + __ldg(a.xproj + row * H3 + n));
              a.dxproj[row * H3 + n] = v;
              if (n >= H) a.rh[row * H + n - H] = v * __ldg(hprev_row(a, m) + n - H);
            } else if (live[mt]) {
              a.dxproj[row * H3 + 2 * H + n] =
                  tanhf(acc[mt][nt][e] + __ldg(a.xproj + row * H3 + 2 * H + n));
            }
          }
        }
      }
    }
    // every rh row is written before the second product reads it
    if (part == 0) lstm::grid_sync(a.sync, gridDim.x);
  }
}

// (C): dw[:, 0:2H] = Hprev^T . da and dw[:, 2H:3H] = RH^T . db over the B*T
// rows: tile blockIdx.x % tiles (the tiles of the first part, then of the
// second), split blockIdx.x / tiles of the 32-row chunks; the splits of a
// tile add into dw in order.  Two blocks an SM.
constexpr int kWin = 1024;  // chunks a window of the live-chunk list
constexpr size_t kDwSmem =
    kGemmSmem + sizeof(unsigned) * (kWin / 32) + sizeof(int) * (kWin + 1);

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2) gru_bwd_dw(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  unsigned* flags = reinterpret_cast<unsigned*>(smem + kStages * kGemmStage);
  int* list = reinterpret_cast<int*>(flags + kWin / 32);  // [kWin] chunks, then the count
  const int H = a.H, H3 = 3 * H, K = a.B * a.T;
  const int tiles_m = (H + kBM - 1) / kBM;
  const int tiles0 = tiles_m * ((2 * H + kBN - 1) / kBN);
  const int tiles = tiles0 + tiles_m * ((H + kBN - 1) / kBN);
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int part = tile < tiles0 ? 0 : 1;
  const int pt = part == 0 ? tile : tile - tiles0;
  const int N = part == 0 ? 2 * H : H, off = part == 0 ? 0 : 2 * H;
  const int m0 = (pt % tiles_m) * kBM, n0 = (pt / tiles_m) * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int nchunks = (K + kBK - 1) / kBK;
  const int per = (nchunks + a.splits - 1) / a.splits;
  const int c0 = split * per, c1 = min(nchunks, c0 + per);
  const bool live[2] = {true, true};
  float acc[2][4][4];
  clear(acc);
  auto arow = [&](int k) {
    return part == 0 ? hprev_row(a, k) : a.rh + static_cast<size_t>(k) * H;
  };
  for (int w0 = c0; w0 < c1; w0 += kWin) {
    const int w1 = min(c1, w0 + kWin), nwords = (w1 - w0 + 31) / 32;
    // flags: bit i of word w is set when chunk w0 + 32 w + i has a live row
    for (int w = warp; w < nwords; w += kThreads / 32) {
      const int c = w0 + 32 * w + lane;
      bool lv = false;
      if (c < w1) {
#pragma unroll 8
        for (int r = 0; r < kBK; ++r) lv |= live_at(a, c * kBK + r, K);
      }
      const unsigned bits = __ballot_sync(0xffffffffu, lv);
      if (lane == 0) flags[w] = bits;
    }
    __syncthreads();
    // the window's live chunks in order: list[i] is the i-th, list[kWin] of them
    if (tid == 0) {
      int n = 0;
      for (int w = 0; w < nwords; ++w) {
        for (unsigned bits = flags[w]; bits; bits &= bits - 1) list[n++] = w0 + 32 * w + __ffs(bits) - 1;
      }
      list[kWin] = n;
    }
    __syncthreads();
    // gemm_tile ends on a block barrier: the list is free for the next window
    gemm_tile<VEC, true>(
        smem, arow, [&](int k) { return a.dxproj + static_cast<size_t>(k) * H3 + off; },
        [&](int i) { return list[i]; }, list[kWin], m0, H, n0, N, K, a.w, wm, wn, live, acc);
  }

  unsigned int* flag = a.sync + 1 + a.groups + tile;
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
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * (e >> 1);
        const int n = n0 + wn * 32 + nt * 8 + 2 * q + (e & 1);
        if (m >= H || n >= N) continue;
        float* p = a.dw + static_cast<size_t>(m) * H3 + off + n;
        *p = split > 0 ? __ldcg(p) + acc[mt][nt][e] : acc[mt][nt][e];
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

constexpr int kWideH = 896;            // the widest H that takes 16 units a block; 8 past it
constexpr int kBufs = 3;               // chunks of the group's rows in flight
constexpr int kChunk = 4096;           // floats a chunk: R rows x 4096 / R columns
constexpr int kStageFloats = 13824;    // max over R of kBufs x R x (kChunk / R + 4); holds the partials too
constexpr int kListInts = 2 * (2 * 128 + 1);  // two steps' lists: packed rows, each row's place, the count

// A row of the block's W: w[j, 0:2H] and w[j, 2H:3H], each zero-padded to
// a multiple of every chunk width (32, 64, 128) so a chunk never reads past
// its part, plus 4 so fragment reads of the 8 rows miss each other's banks
__host__ __device__ inline int wc_off(int H) { return round_up(2 * H, 128); }
__host__ __device__ inline int w_ld(int H) { return wc_off(H) + round_up(H, 128) + 4; }

// hidden units a block owns at this H
inline int bwd_units(int H) { return H <= kWideH ? 16 : 8; }

size_t recur_smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(bwd_units(H)) * w_ld(H) + kStageFloats) +
         sizeof(int) * kListInts;
}

// acc[mt][nt] += A[packed rows of m-tile mt] . Ws[units of n-tile nt, k]^T
// over this warp's two k8-steps of a staged chunk, in split TF32: NMT live
// m-tiles of 16 packed rows (rows wm * 32 ..), the NT n-tiles of the
// block's 8 NT units; each term sums its three products in a fresh
// accumulator
template <int NMT, int NT, int WK, int LDS>
__device__ __forceinline__ void chunk_product(const float* st, const float* Ws, int ldw, int c0,
                                              int wm, int wk, float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int kl = (ks * WK + wk) * 8;  // column inside the chunk
    FragA fa[NMT];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      const float* ar = st + (wm * 32 + mt * 16 + g) * LDS + kl + q;
      fa[mt].set(ar[0], ar[8 * LDS], ar[4], ar[8 * LDS + 4]);
    }
    FragB fb[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* wr = Ws + (nt * 8 + g) * ldw + c0 + kl + q;
      fb[nt].set(wr[0], wr[4]);
    }
    float tmp[NMT][NT][4];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32_first(tmp[mt][nt], fa[mt].lo, fb[nt].hi);
    }
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(tmp[mt][nt], fa[mt].hi, fb[nt].lo);
    }
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(tmp[mt][nt], fa[mt].hi, fb[nt].hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += tmp[mt][nt][e];
      }
    }
  }
}

// Batch groups of R rows (R / 32 warp rows x 8 / (R / 32) warp K-slices in
// the products) and U hidden units: blockIdx.x = slot * nu + unit block,
// and the slot's groups slot, slot + slots, ... one after the other.
template <int R, int U>
__global__ void __launch_bounds__(kThreads, 1) gru_bwd_recurrence(const BwdArgs a) {
  constexpr int NT = U / 8;              // the units' n-tiles
  constexpr int kRedLd = U + 8;          // a row of the K-slices' partial sums
  constexpr int WM = R / 32, WK = 8 / WM;
  constexpr int CK = kChunk / R, LDS = CK + 4, kBuf = R * LDS;
  constexpr int P = R * U / kThreads;    // consecutive units a thread carries in its row
  constexpr int TPR = U / P;             // threads a row
  static_assert(kBufs * kBuf <= kStageFloats && WK * R * kRedLd <= kStageFloats, "layout");
  static_assert(U % 8 == 0 && P >= 1, "whole n-tiles; a pair a thread at least");
  static_assert(CK / 8 == 2 * WK, "two k8-steps a warp a chunk");
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, H3 = 3 * H;
  const int ldw = w_ld(H), cw = wc_off(H);
  float* Ws = smem;                      // [U][ldw]: w[j0 + u, 0:2H] | w[j0 + u, 2H:3H]
  float* stage = Ws + U * ldw;           // kBufs x [R][LDS]; then [WK][R][kRedLd]
  int* lists = reinterpret_cast<int*>(stage + kStageFloats);  // [2][2R + 1]
  const int nu = (H + U - 1) / U;
  const int j0 = (blockIdx.x % nu) * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp % WM, wk = warp / WM;

  for (int i = tid; i < U * (ldw - 4); i += kThreads) {
    const int u = i / (ldw - 4), c = i % (ldw - 4), j = j0 + u;
    const int n = c < cw ? (c < 2 * H ? c : -1) : (c - cw < H ? 2 * H + c - cw : -1);
    Ws[u * ldw + c] = (j < H && n >= 0) ? __ldg(a.w + static_cast<size_t>(j) * H3 + n) : 0.0f;
  }
  // this thread's pairs: row r of the group, units u0 .. u0 + P - 1
  const int r = tid / TPR, u0 = (tid % TPR) * P;
  const int n_units = min(P, H - (j0 + u0));  // the units that exist (may be <= 0)
  const bool vec = a.aligned && H % P == 0;   // rows of P floats aligned
  const bool vec4 = a.aligned && H % 4 == 0;  // rows of dxproj in 16-byte pieces

  for (int group = blockIdx.x / nu; group < a.groups; group += a.slots) {
    const int b0 = group * R;
    const int b = b0 + r;
    const bool mine = b < B && n_units > 0;
    unsigned int* count = a.sync + 1 + group;
    unsigned int passed = 0;
    float dh[P];
    // this pair's inputs at step t, loaded a step ahead: mask, dhs, the
    // gates u, r, c (from (A)) and h_{t-1}
    float nm = 0.0f, ndh[P], nug[P], nrg[P], ncg[P], nhp[P];
    auto fetch = [&](int t) {
      if (!mine) return;
      const size_t bt = static_cast<size_t>(b) * T + t;
      const int j = j0 + u0;
      nm = __ldg(a.mask + bt);
      load_units<P>(a.dhs + bt * H + j, n_units, vec, ndh);
      load_units<P, true>(a.dxproj + bt * H3 + j, n_units, vec, nug);
      load_units<P, true>(a.dxproj + bt * H3 + H + j, n_units, vec, nrg);
      load_units<P, true>(a.dxproj + bt * H3 + 2 * H + j, n_units, vec, ncg);
      load_units<P>(t == 0 ? a.h0 + static_cast<size_t>(b) * H + j : a.hs + (bt - 1) * H + j,
                    n_units, vec, nhp);
    };
#pragma unroll
    for (int p = 0; p < P; ++p) dh[p] = 0.0f;
    fetch(T - 1);

    // the group's live rows at a step, packed in order: warp 0 builds the
    // list of step t (into lists[t & 1]) from mask values it loaded a step
    // ahead (R / 32 per lane)
    float mv[R / 32];
    auto load_mask = [&](int t) {
#pragma unroll
      for (int w32 = 0; w32 < R / 32; ++w32) {
        const int bb = b0 + w32 * 32 + lane;
        mv[w32] = bb < B ? __ldg(a.mask + static_cast<size_t>(bb) * T + t) : 0.0f;
      }
    };
    auto make_list = [&](int t) {
      int* L = lists + (t & 1) * (2 * R + 1);
      int n = 0;
#pragma unroll
      for (int w32 = 0; w32 < R / 32; ++w32) {
        const int rr = w32 * 32 + lane;
        const bool lv = mv[w32] != 0.0f;
        const unsigned bits = __ballot_sync(0xffffffffu, lv);
        const int at = n + __popc(bits & ((1u << lane) - 1u));
        L[R + rr] = lv ? at : -1;
        if (lv) L[at] = rr;
        n += __popc(bits);
      }
      if (lane == 0) L[2 * R] = n;
      if (t > 0) load_mask(t - 1);
    };
    if (warp == 0) {
      load_mask(T - 1);
      make_list(T - 1);
    }
    __syncthreads();

    for (int t = T - 1; t >= 0; --t) {
      const int* L = lists + (t & 1) * (2 * R + 1);
      const int n_live = L[2 * R];
      const float m = nm;
      float ug[P], rg[P], hp[P], du[P], pass[P], db[P];
      const bool live_row = mine && m != 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        ug[p] = nug[p]; rg[p] = nrg[p]; hp[p] = nhp[p];
        const float dh_total = ndh[p] + dh[p];
        if (!live_row) {  // a masked step passes dh through (its gates were never computed)
          du[p] = db[p] = 0.0f;
          pass[p] = dh_total;
          continue;
        }
        const float din = m * dh_total;
        const float c = ncg[p];
        du[p] = din * (hp[p] - c);
        pass[p] = din * ug[p] + (1.0f - m) * dh_total;
        db[p] = din * (1.0f - ug[p]) * (1.0f - c * c);
      }
      if (mine) {
        // db into the candidate slots; a masked pair's gradients are zeros
        float* dx = a.dxproj + (static_cast<size_t>(b) * T + t) * H3 + j0 + u0;
        float zero[P];
#pragma unroll
        for (int p = 0; p < P; ++p) zero[p] = 0.0f;
        store_units<P>(dx + 2 * H, n_units, vec, db);
        if (!live_row) {
          store_units<P>(dx, n_units, vec, zero);
          store_units<P>(dx + H, n_units, vec, zero);
        }
      }
      if (n_live == 0) {  // no live row in the group: dh_{t-1} is the pass-through
#pragma unroll
        for (int p = 0; p < P; ++p) dh[p] = pass[p];
        if (t > 0) fetch(t - 1);
        if (warp == 0 && t > 0) make_list(t - 1);
        __syncthreads();
        continue;
      }
      group_arrive(count);
      if (t > 0) fetch(t - 1);
      if (warp == 0 && t > 0) make_list(t - 1);
      const int n16 = round_up(n_live, 16);
      const int mts = min(2, max(0, (n_live - wm * 32 + 15) / 16));  // this warp's live m-tiles
      const int pk = mine ? L[R + r] : -1;                           // this row's packed place
      // out[packed row, U units] = X[packed rows, 0:K] . Ws[units, c0 + 0:K]^T,
      // X's row b starting at src + b * T * 3H; the K-slices' partial sums
      // are left in the stage ([WK][R][kRedLd])
      auto product = [&](const float* src, int K, int c0) {
        const int nch = (K + CK - 1) / CK;
        auto load = [&](int c, float* st) {  // packed rows < n16; rows past n_live and columns past K zero
          if (vec4) {
            for (int i = tid; i < n16 * (CK / 4); i += kThreads) {
              const int rr = i / (CK / 4), col = (i % (CK / 4)) * 4, k = c * CK + col;
              const bool ok = rr < n_live && k < K;
              cp_async16(st + rr * LDS + col,
                         ok ? src + static_cast<size_t>(b0 + L[rr]) * T * H3 + k : a.w,
                         ok ? 16 : 0);
            }
          } else {
            for (int i = tid; i < n16 * CK; i += kThreads) {
              const int rr = i / CK, col = i % CK, k = c * CK + col;
              const bool ok = rr < n_live && k < K;
              cp_async4(st + rr * LDS + col,
                        ok ? src + static_cast<size_t>(b0 + L[rr]) * T * H3 + k : a.w,
                        ok ? 4 : 0);
            }
          }
        };
#pragma unroll
        for (int s = 0; s < kBufs - 1; ++s) {
          if (s < nch) load(s, stage + s * kBuf);
          cp_async_commit();
        }
        float acc[2][NT][4] = {};
        for (int c = 0; c < nch; ++c) {
          cp_async_wait<kBufs - 2>();
          __syncthreads();  // chunk c has landed, and chunk c - 1's buffer is free
          if (c + kBufs - 1 < nch) load(c + kBufs - 1, stage + ((c + kBufs - 1) % kBufs) * kBuf);
          cp_async_commit();
          const float* st = stage + (c % kBufs) * kBuf;
          if (mts == 2) {
            chunk_product<2, NT, WK, LDS>(st, Ws, ldw, c0 + c * CK, wm, wk, acc);
          } else if (mts == 1) {
            chunk_product<1, NT, WK, LDS>(st, Ws, ldw, c0 + c * CK, wm, wk, acc);
          }
        }
        cp_async_wait<0>();
        __syncthreads();  // the stage now holds the K-slices' partial sums
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= mts) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = wm * 32 + mt * 16 + g + 8 * hf;
              *reinterpret_cast<float2*>(stage + (wk * R + row) * kRedLd + nt * 8 + 2 * q) =
                  make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
            }
          }
        }
        __syncthreads();
      };
      // sum of this pair's K-slice partials, in a fixed order
      auto partial = [&](int p) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WK; ++w) s += stage[(w * R + pk) * kRedLd + u0 + p];
        return s;
      };
      const float* dx_t = a.dxproj + static_cast<size_t>(t) * H3;

      // every block of the group has written db of step t
      passed += nu;
      group_wait(count, passed);
      product(dx_t + 2 * H, H, cw);  // drh = db . w_c^T
      if (live_row) {
        float da_u[P], da_r[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float drh = partial(p);
          const float dr = drh * hp[p];
          pass[p] = pass[p] + drh * rg[p];
          da_u[p] = du[p] * ug[p] * (1.0f - ug[p]);
          da_r[p] = dr * rg[p] * (1.0f - rg[p]);
        }
        float* dx = a.dxproj + (static_cast<size_t>(b) * T + t) * H3 + j0 + u0;
        store_units<P>(dx, n_units, vec, da_u);
        store_units<P>(dx + H, n_units, vec, da_r);
      }
      group_arrive(count);  // also: every thread has read its partials
      // every block of the group has written da of step t
      passed += nu;
      group_wait(count, passed);
      product(dx_t, 2 * H, 0);  // da . w_uz^T
#pragma unroll
      for (int p = 0; p < P; ++p) dh[p] = live_row ? partial(p) + pass[p] : pass[p];
      __syncthreads();  // the partials are read; the next step stages over them
    }

    if (mine) store_units<P>(a.dh0 + static_cast<size_t>(b) * H + j0 + u0, n_units, vec, dh);
    // the next group rewrites the lists and the stage
    __syncthreads();
  }
}

constexpr int kRowChoices[3] = {32, 64, 128};

using Kernel = void (*)(const BwdArgs);

template <int U>
Kernel recurrence_kernel(int R) {
  return R == 32 ? gru_bwd_recurrence<32, U>
                 : (R == 64 ? gru_bwd_recurrence<64, U> : gru_bwd_recurrence<128, U>);
}

Kernel recurrence_kernel(int R, int H) {
  return bwd_units(H) == 16 ? recurrence_kernel<16>(R) : recurrence_kernel<8>(R);
}

int dw_tiles(int H) {
  const int tm = (H + kBM - 1) / kBM;
  return tm * ((2 * H + kBN - 1) / kBN) + tm * ((H + kBN - 1) / kBN);
}

}  // namespace

extern "C" {

// Shared memory one block of the recurrence (B) takes at this shape (bytes).
int gru_bwd_smem_bytes(int B, int H) {
  (void)B;
  return static_cast<int>(recur_smem_bytes(H));
}

// 32-bit words of device memory gru_bwd() needs for its barriers and flags.
int gru_bwd_sync_words(int B, int H) { return 1 + (B + 31) / 32 + dw_tiles(H); }

// xproj/dxproj [B, T, 3H], w/dw [H, 3H], h0/dh0 [B, H], mask [B, T],
// hs/dhs/rh [B, T, H]: float32, contiguous, on `device`; barrier:
// gru_bwd_sync_words(B, H) 32-bit words of device memory.  Returns 0, a
// cudaError_t, kSmemOver or kNotResident.
int gru_bwd(const void* xproj, const void* w, const void* h0, const void* mask,
            const void* hs, const void* dhs, void* dxproj, void* dw, void* dh0, void* rh,
            void* barrier, int B, int T, int H, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_b = recur_smem_bytes(H);
  if (smem_b > static_cast<size_t>(smem_max)) return lstm::kSmemOver;

  // (B)'s batch group: the smallest that lets every group run side by
  // side; when none does, groups of 128 rows, as many side by side as the
  // card holds and the rest in turn
  const int nu = (H + bwd_units(H) - 1) / bwd_units(H);
  int R = 0, cap = 0;
  for (int r : kRowChoices) {
    cap = lstm::resident_capacity(recurrence_kernel(r, H), smem_b, device);
    if (cap < 0) return -cap;
    R = r;
    if (((B + r - 1) / r) * nu <= cap) break;
  }
  if (cap < nu) return lstm::kNotResident;

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
  a.sync = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  a.aligned = ((reinterpret_cast<uintptr_t>(xproj) | reinterpret_cast<uintptr_t>(w) |
                reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(hs) |
                reinterpret_cast<uintptr_t>(dhs) | reinterpret_cast<uintptr_t>(dxproj) |
                reinterpret_cast<uintptr_t>(dw) | reinterpret_cast<uintptr_t>(dh0) |
                reinterpret_cast<uintptr_t>(rh)) % 16) == 0;
  a.groups = (B + R - 1) / R;
  a.slots = std::min(a.groups, cap / nu);

  // (C)'s split: up to 4, enough blocks to fill the card, at least 8 chunks a split
  const bool vec = a.aligned && H % 4 == 0;
  const Kernel dw_k = vec ? gru_bwd_dw<true> : gru_bwd_dw<false>;
  const int tiles = dw_tiles(H);
  const int nchunks = (B * T + kBK - 1) / kBK;
  const int cap_c = lstm::resident_capacity(dw_k, kDwSmem, device);
  if (cap_c < 0) return -cap_c;
  a.splits = std::max(1, std::min({4, cap_c / tiles, nchunks / 8}));

  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int) * (1 + a.groups + tiles), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // (A): as many blocks as the first product has tiles, up to what the card holds
  const Kernel gates_k = vec ? gru_bwd_gates<true> : gru_bwd_gates<false>;
  const int cap_a = lstm::resident_capacity(gates_k, kGemmSmem, device);
  if (cap_a < 0) return -cap_a;
  const int tiles_a = ((B * T + kBM - 1) / kBM) * ((2 * H + kBN - 1) / kBN);
  int rc = lstm::launch_cooperative(gates_k, a, std::min(tiles_a, cap_a), kGemmSmem, device, st);
  if (rc != 0) return rc;

  // (B)
  rc = lstm::launch_cooperative(recurrence_kernel(R, H), a, a.slots * nu, smem_b, device, st);
  if (rc != 0) return rc;

  // (C)
  if (a.splits > 1) {
    return lstm::launch_cooperative(dw_k, a, tiles * a.splits, kDwSmem, device, st);
  }
  err = cudaFuncSetAttribute(dw_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDwSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_k<<<tiles, kThreads, kDwSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the recurrence (B) the card holds at once at this shape's
// shared memory (0 when a block cannot have that much), or minus a
// cudaError_t.  kernels/rnn.py's gate needs ceil(H / 16) up to H = 896
// and ceil(H / 8) past it: one slot.
int gru_bwd_capacity(int B, int H, int device) {
  (void)B;
  return lstm::resident_capacity(recurrence_kernel(128, H), recur_smem_bytes(H), device);
}

const char* gru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
