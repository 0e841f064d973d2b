// Fused GRU forward for Hopper (sm_90a), float32: K8a.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py:272 _gru_fwd_kernel
// (launched by gru_fused through pl.pallas_call): the whole-sequence GRU
// over xproj [B, T, 3H] (x·Wx + b, gates [update | reset | candidate])
// with the recurrent weight w [H, 3H], the initial state h0 [B, H] and
// the length mask [B, T]:
//   u = sigmoid(x_u + h w_u),  r = sigmoid(x_r + h w_r),
//   c = tanh(x_c + (r ⊙ h) w_c),  h' = u ⊙ h + (1 - u) ⊙ c,
// and a step takes m * h' + (1 - m) * h (a masked step carries h).  It
// writes hs [B, T, H] and nothing else: the backward (gru_bwd.cu)
// recomputes the gates.
//
// Design.  The TPU walked a grid of T sequential steps with w resident in
// VMEM and h in VMEM scratch.  Here the recurrence runs as K6's
// (lstm_fwd.cu) does, in one cooperative persistent launch, with K8b's
// (gru_bwd.cu) two barriers a step:
//
// - Batch rows are independent, so the grid is (slots of batch groups of
//   R rows) x (blocks of U hidden units), and each group barriers on its
//   own counter.  A slot takes the groups slot, slot + slots, ... in
//   turn, so any B runs once ceil(H / U) blocks are resident.  R is the
//   smallest of 32, 64 and 128 that lets every group run side by side
//   (machine translation's B = 64 at H = 256: 2 groups x 16 blocks).
// - A block keeps w[:, the 3U gate columns of its U units] in shared
//   memory for the whole sequence, transposed, and splits it into TF32 hi
//   and lo parts as it reads it.  U is 16 up to H = 896 (48 x H floats,
//   48 KB at H = 256) and 8 past it, where 16 units' columns no longer fit
//   a block (8 units take H up to 1,056 on an H100's 132 SMs).
// - A step has two products, since the candidate's needs r ⊙ h_{t-1} of
//   every unit:
//     1. wait until the group's blocks have written hs[t-1]; h_{t-1} of
//        the group's live rows . w[:, update and reset columns]; u and r
//        of the block's (row, unit) pairs; r ⊙ h_{t-1} into the [B, H]
//        scratch; arrive;
//     2. wait until every unit's r ⊙ h_{t-1} is in; (r ⊙ h_{t-1}) of the
//        live rows . w[:, candidate columns]; c and h_t; hs[t]; arrive.
//   Each product reads the group's LIVE rows at t (mask != 0), packed
//   together, by cp.async through L2 in 4096-float chunks, three buffers
//   deep, and multiplies in split TF32 on the tensor cores (tf32x3.cuh:
//   three mma.sync products a term, each term summed in a fresh
//   accumulator and added with a rounded float add, as the tensor cores
//   truncate as they accumulate).  Each warp takes 32 packed rows over
//   one K-slice; the K-slices' partial sums meet in shared memory and are
//   added in a fixed order.  A 16-row tile with no live row does no
//   product, and a group with no live row at t skips both products and
//   both waits.
// - The group barrier is split (lstm_common.cuh): a block arrives right
//   after its writes, builds the next step's list of live rows and loads
//   the next step's gate inputs while the others arrive, and waits only
//   before a product.
// - The cell runs in float32 on (row, unit) pairs held by fixed threads:
//   h stays in registers from step to step, u between the two products,
//   and xproj's three gate values come by vector loads issued a step
//   ahead.  A masked pair carries h; a live one takes m * h' + (1 - m) * h.
// - Deterministic: the only atomics are the group barriers' counters.
//
// Bound.  At machine translation's shape B = 64, T = 32, H = 256 the
// products are 2 * H * 3H float32 operations per live (row, step): 805
// MFLOP at full lengths, about 0.5 GFLOP for its ragged lengths 8..32,
// over about 9.2 MB of xproj, w, h0, mask and hs.  In split TF32 they run
// at a third of the tensor cores' TF32 rate (165 TFLOP/s on an H100 SXM):
// 0.0049 ms at full lengths, about 0.003 ms ragged.  The floor in practice
// is the T dependent steps, each two group barriers and two reads of the
// group's rows from L2; the times are in PERF.md.
//
// Entry point: gru_fwd(), a plain C function called through ctypes on
// PyTorch's current stream.  It zeroes the group barriers, launches and
// returns 0, a cudaError_t, or kSmemOver/kNotResident when the shape
// cannot run; it never synchronises and allocates nothing.

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

struct FwdArgs {
  const float* xproj;  // [B, T, 3H]
  const float* w;      // [H, 3H]
  const float* h0;     // [B, H]
  const float* mask;   // [B, T]
  float* hs;           // [B, T, H]
  float* rh;           // [B, H] scratch: r ⊙ h_{t-1} of the step's live rows
  unsigned int* sync;  // [groups] group barriers
  int B, T, H;
  int groups;          // batch groups of R rows
  int slots;           // groups that run side by side
  int aligned;         // every tensor starts on a 16-byte boundary
};

constexpr int kWideH = 896;            // the widest H that takes 16 units a block; 8 past it
constexpr int kBufs = 3;               // chunks of the group's rows in flight
constexpr int kChunk = 4096;           // floats a chunk: R rows x 4096 / R columns
constexpr int kStageFloats = 13824;    // max over R of kBufs x R x (kChunk / R + 4); holds the partials too
constexpr int kListInts = 2 * 128 + 4;  // a step's packed rows, each row's place, the count

// hidden units a block owns at this H
inline int fwd_units(int H) { return H <= kWideH ? 16 : 8; }

// w's rows, padded to a multiple of every chunk width (32, 64, 128) so a
// chunk never reads past them, plus 4 so fragment reads miss each other's banks
__host__ __device__ inline int w_ld(int H) { return round_up(H, 128) + 4; }

size_t fwd_smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(3 * fwd_units(H)) * w_ld(H) + kStageFloats) +
         sizeof(int) * kListInts;
}

// acc[mt][nt] += A[packed rows of m-tile mt] . W[k-step, columns of n-tile
// nt] over this warp's two k8-steps of a staged chunk, in split TF32: NMT
// live m-tiles of 16 packed rows (rows wm * 32 ..), all NT n-tiles; each
// term sums its three products in a fresh accumulator
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

// out[packed row, NT * 8 columns] = X[packed rows, 0:H] . Ws[columns, 0:H]^T
// for the group's n_live live rows (packed row rr is row b0 + L[rr], at
// src + row * stride), leaving the K-slices' partial sums in the stage
// ([WK][R][kRedLd]).  Every thread of the block calls it.
template <int R, int NT, int kRedLd>
__device__ __forceinline__ void step_product(const float* src, size_t stride, int H, int n_live,
                                             const int* L, int b0, const float* Ws, int ldw,
                                             float* stage, bool vec4, const float* any) {
  constexpr int WM = R / 32, WK = 8 / WM;
  constexpr int CK = kChunk / R, LDS = CK + 4, kBuf = R * LDS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp % WM, wk = warp / WM;
  const int n16 = round_up(n_live, 16);
  const int nch = (H + CK - 1) / CK;
  auto load = [&](int c, float* st) {  // packed rows < n16; rows past n_live and columns past H zero
    if (vec4) {
      for (int i = tid; i < n16 * (CK / 4); i += kThreads) {
        const int rr = i / (CK / 4), col = (i % (CK / 4)) * 4, k = c * CK + col;
        const bool ok = rr < n_live && k < H;
        cp_async16(st + rr * LDS + col, ok ? src + static_cast<size_t>(b0 + L[rr]) * stride + k : any,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < n16 * CK; i += kThreads) {
        const int rr = i / CK, col = i % CK, k = c * CK + col;
        const bool ok = rr < n_live && k < H;
        cp_async4(st + rr * LDS + col, ok ? src + static_cast<size_t>(b0 + L[rr]) * stride + k : any,
                  ok ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kBufs - 1; ++s) {
    if (s < nch) load(s, stage + s * kBuf);
    cp_async_commit();
  }
  const int mts = min(2, max(0, (n_live - wm * 32 + 15) / 16));  // this warp's live m-tiles
  float acc[2][NT][4] = {};
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kBufs - 2>();
    __syncthreads();  // chunk c has landed, and chunk c - 1's buffer is free
    if (c + kBufs - 1 < nch) load(c + kBufs - 1, stage + ((c + kBufs - 1) % kBufs) * kBuf);
    cp_async_commit();
    const float* st = stage + (c % kBufs) * kBuf;
    if (mts == 2) {
      chunk_product<2, NT, WK, LDS>(st, Ws, ldw, c * CK, wm, wk, acc);
    } else if (mts == 1) {
      chunk_product<1, NT, WK, LDS>(st, Ws, ldw, c * CK, wm, wk, acc);
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
}

// Batch groups of R rows (R / 32 warp rows x 8 / (R / 32) warp K-slices in
// the products) and U hidden units: blockIdx.x = slot * nu + unit block,
// and the slot's groups slot, slot + slots, ... one after the other.
template <int R, int U>
__global__ void __launch_bounds__(kThreads, 1) gru_fwd_recurrence(const FwdArgs a) {
  constexpr int kCols = 3 * U;           // gate columns: column c is gate c / U of unit c % U
  constexpr int kRedLd = 2 * U + 8;      // a row of the K-slices' partial sums
  constexpr int WM = R / 32, WK = 8 / WM;
  constexpr int P = R * U / kThreads;    // consecutive units a thread carries in its row
  constexpr int TPR = U / P;             // threads a row
  static_assert(WK * R * kRedLd <= kStageFloats, "layout");
  static_assert(kBufs * R * (kChunk / R + 4) <= kStageFloats, "layout");
  static_assert(U % 8 == 0 && P >= 1, "whole n-tiles; a pair a thread at least");
  static_assert((kChunk / R) / 8 == 2 * WK, "two k8-steps a warp a chunk");
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, H3 = 3 * H;
  const int ldw = w_ld(H);
  float* Ws = smem;                           // [kCols][ldw]: w[k, col] at Ws[col * ldw + k]
  float* stage = Ws + kCols * ldw;            // kBufs x [R][LDS]; then [WK][R][kRedLd]
  int* L = reinterpret_cast<int*>(stage + kStageFloats);  // [R] packed rows, [R] places, count
  const int nu = (H + U - 1) / U;
  const int j0 = (blockIdx.x % nu) * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < round_up(H, 128) * kCols; i += kThreads) {
    const int k = i / kCols, c = i % kCols, j = j0 + c % U;
    Ws[c * ldw + k] = (k < H && j < H) ? __ldg(a.w + static_cast<size_t>(k) * H3 + (c / U) * H + j)
                                       : 0.0f;
  }
  // this thread's pairs: row r of the group, units u0 .. u0 + P - 1
  const int r = tid / TPR, u0 = (tid % TPR) * P;
  const int n_units = min(P, H - (j0 + u0));  // the units that exist (may be <= 0)
  const bool vec = a.aligned && H % P == 0;   // rows of P floats aligned
  const bool vec4 = a.aligned && H % 4 == 0;  // h rows in 16-byte pieces

  for (int group = blockIdx.x / nu; group < a.groups; group += a.slots) {
    const int b0 = group * R;
    const int b = b0 + r;
    const bool mine = b < B && n_units > 0;
    unsigned int* count = a.sync + group;
    unsigned int arrived = 0;  // the group's arrivals this block has waited for or made
    float hc[P], nx[3][P], nm = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) hc[p] = 0.0f;
    if (mine) load_units<P>(a.h0 + static_cast<size_t>(b) * H + j0 + u0, n_units, vec, hc);
    // this pair's mask and gate inputs at step t, loaded a step ahead
    auto fetch = [&](int t) {
      if (!mine) return;
      const size_t bt = static_cast<size_t>(b) * T + t;
      nm = __ldg(a.mask + bt);
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        load_units<P>(a.xproj + bt * H3 + gt * H + j0 + u0, n_units, vec, nx[gt]);
      }
    };
    fetch(0);

    // the group's live rows at a step, packed in order: warp 0 builds the
    // list from mask values it loaded a step ahead (R / 32 per lane)
    float mv[R / 32];
    auto load_mask = [&](int t) {
#pragma unroll
      for (int w32 = 0; w32 < R / 32; ++w32) {
        const int bb = b0 + w32 * 32 + lane;
        mv[w32] = bb < B ? __ldg(a.mask + static_cast<size_t>(bb) * T + t) : 0.0f;
      }
    };
    auto make_list = [&](int t) {
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
      if (t + 1 < T) load_mask(t + 1);
    };
    if (warp == 0) {
      load_mask(0);
      make_list(0);
    }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      const int n_live = L[2 * R];
      const int pk = mine ? L[R + r] : -1;  // this row's packed place, -1 when masked at t
      // sum of this pair's K-slice partials of column col, in a fixed order
      auto partial = [&](int col) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WK; ++w) s += stage[(w * R + pk) * kRedLd + col];
        return s;
      };
      if (n_live > 0) {
        // 1. u and r: every block of the group has written hs[t - 1]
        if (t > 0) group_wait(count, arrived);
        const float* src = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
        const size_t stride = t == 0 ? static_cast<size_t>(H) : static_cast<size_t>(T) * H;
        step_product<R, 2 * U / 8, kRedLd>(src, stride, H, n_live, L, b0, Ws, ldw, stage, vec4,
                                           a.w);
        float ug[P];
        if (pk >= 0) {
          float rhv[P];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            ug[p] = sigmoidf(partial(u0 + p) + nx[0][p]);
            rhv[p] = sigmoidf(partial(U + u0 + p) + nx[1][p]) * hc[p];
          }
          store_units<P>(a.rh + static_cast<size_t>(b) * H + j0 + u0, n_units, vec, rhv);
        }
        group_arrive(count);  // also: every thread has read its partials
        arrived += nu;
        // 2. the candidate: every block of the group has written r ⊙ h_{t-1}
        group_wait(count, arrived);
        step_product<R, U / 8, kRedLd>(a.rh, static_cast<size_t>(H), H, n_live, L, b0,
                                       Ws + 2 * U * ldw, ldw, stage, vec4, a.w);
        if (pk >= 0) {
          const float m = nm;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float c = tanhf(partial(u0 + p) + nx[2][p]);
            const float h_new = ug[p] * hc[p] + (1.0f - ug[p]) * c;
            hc[p] = m * h_new + (1.0f - m) * hc[p];
          }
        }
      }
      if (mine) {
        store_units<P>(a.hs + (static_cast<size_t>(b) * T + t) * H + j0 + u0, n_units, vec, hc);
      }
      if (t + 1 < T) {
        // this block has written hs[t] and read the list and the stage:
        // arrive, then the next step's list and gate inputs while the
        // other blocks arrive (after the release, which would otherwise
        // wait for those loads too)
        group_arrive(count);
        arrived += nu;
        if (warp == 0) make_list(t + 1);
        fetch(t + 1);
        __syncthreads();
      }
    }
    // the next group rewrites the list and the stage
    __syncthreads();
  }
}

constexpr int kRowChoices[3] = {32, 64, 128};

using Kernel = void (*)(const FwdArgs);

template <int U>
Kernel recurrence_kernel(int R) {
  return R == 32 ? gru_fwd_recurrence<32, U>
                 : (R == 64 ? gru_fwd_recurrence<64, U> : gru_fwd_recurrence<128, U>);
}

Kernel recurrence_kernel(int R, int H) {
  return fwd_units(H) == 16 ? recurrence_kernel<16>(R) : recurrence_kernel<8>(R);
}

}  // namespace

extern "C" {

// Shared memory one block of gru_fwd takes at this shape (bytes).
int gru_fwd_smem_bytes(int B, int H) {
  (void)B;
  return static_cast<int>(fwd_smem_bytes(H));
}

// 32-bit words of device memory gru_fwd() needs for its group barriers.
int gru_fwd_sync_words(int B, int H) {
  (void)H;
  return (B + 31) / 32;
}

// xproj [B, T, 3H], w [H, 3H], h0 [B, H], mask [B, T], hs [B, T, H],
// rh [B, H]: float32, contiguous, on `device`; barrier:
// gru_fwd_sync_words(B, H) 32-bit words of device memory.  Returns 0, a
// cudaError_t, kSmemOver or kNotResident.
int gru_fwd(const void* xproj, const void* w, const void* h0, const void* mask, void* hs,
            void* rh, void* barrier, int B, int T, int H, int device, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = fwd_smem_bytes(H);
  if (smem > static_cast<size_t>(smem_max)) return lstm::kSmemOver;

  // the batch group: the smallest that lets every group run side by side;
  // when none does, groups of 128 rows, as many side by side as the card
  // holds and the rest in turn
  const int nu = (H + fwd_units(H) - 1) / fwd_units(H);
  int R = 0, cap = 0;
  for (int r : kRowChoices) {
    cap = lstm::resident_capacity(recurrence_kernel(r, H), smem, device);
    if (cap < 0) return -cap;
    R = r;
    if (((B + r - 1) / r) * nu <= cap) break;
  }
  if (cap < nu) return lstm::kNotResident;

  FwdArgs a{};
  a.xproj = static_cast<const float*>(xproj);
  a.w = static_cast<const float*>(w);
  a.h0 = static_cast<const float*>(h0);
  a.mask = static_cast<const float*>(mask);
  a.hs = static_cast<float*>(hs);
  a.rh = static_cast<float*>(rh);
  a.sync = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  a.aligned = ((reinterpret_cast<uintptr_t>(xproj) | reinterpret_cast<uintptr_t>(w) |
                reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(hs) |
                reinterpret_cast<uintptr_t>(rh)) % 16) == 0;
  a.groups = (B + R - 1) / R;
  a.slots = std::min(a.groups, cap / nu);
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int) * a.groups, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return lstm::launch_cooperative(recurrence_kernel(R, H), a, a.slots * nu, smem, device, st);
}

// Blocks of gru_fwd the card holds at once at this shape's shared memory
// (0 when a block cannot have that much), or minus a cudaError_t.
// kernels/rnn.py's gate needs ceil(H / 16) up to H = 896 and ceil(H / 8)
// past it: one slot.
int gru_fwd_capacity(int B, int H, int device) {
  (void)B;
  return lstm::resident_capacity(recurrence_kernel(128, H), fwd_smem_bytes(H), device);
}

const char* gru_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
