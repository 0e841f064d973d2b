// Fused LSTM forward for Hopper (sm_90a), float32: K6.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rnn.py:69 _lstm_fwd_kernel
// (launched by lstm_fused through pl.pallas_call): the whole-sequence
// LSTM over xproj [B, T, 4H] (x·Wx + b, gates i, f, g, o) with the
// recurrent weight w [H, 4H], the initial state h0/c0 [B, H] and the
// length mask [B, T]; a masked step passes h and c through.  It writes
// hs and cs [B, T, H], and nothing else: the backward (lstm_bwd.cu)
// recomputes the gates.
//
// Design.  The TPU walked a grid of T sequential steps with W resident
// in VMEM and h/c in VMEM scratch.  Here the recurrence runs as K7's
// (lstm_bwd.cu) does, in one cooperative persistent launch:
//
// - Batch rows are independent, so the grid is (slots of batch groups of
//   R rows) x (blocks of U hidden units), and each group barriers on its
//   own counter once a step.  A slot takes the groups slot, slot + slots,
//   ... in turn, so any B runs once ceil(H / U) blocks are resident.  R
//   is the smallest of 32, 64 and 128 that lets every group run side by
//   side (the bench's B = 128 at H = 512: 4 groups x 32 blocks).
// - A block keeps W[:, the 4U gate columns of its U units] in shared
//   memory for the whole sequence, transposed, and splits it into TF32 hi
//   and lo parts as it reads it.  U is 16 up to H = 512 (64 x H floats,
//   128 KB at H = 512; split in advance it would take 256 KB, more than a
//   block has) and 8 past it, where 16 units' W no longer fits a block
//   (32 x H floats, 128 KB at H = 1024: 128 blocks, and up to H = 1056 on
//   an H100's 132 SMs).  8 units a block read every row of h twice as
//   often from L2, so they are not taken where 16 fit.  Each W element is
//   read by one warp a step (R = 32), so it is split once a block a step
//   either way.
// - Each step, the rows of h_{t-1} (hs[:, t-1], written by the group's
//   blocks in the step before; h0 at t = 0) of the group's LIVE rows, packed
//   together, arrive by cp.async through L2 in 4096-float chunks, four
//   buffers deep (at R = 32 and H = 512 the whole step is in flight at
//   once).  The product is split TF32 on the tensor cores (tf32x3.cuh:
//   three mma.sync products a term): each warp takes 32 packed rows x 4U
//   columns over one K-slice, each term sums in a fresh accumulator and is
//   added with a rounded float add (the tensor cores truncate as they
//   accumulate), and the eight terms of a half are interleaved as plain
//   asm.  Each element of h is read and split by one warp.  The K-slices'
//   partial sums meet in shared memory and are added in a fixed order.
// - The cell runs in float32 on (row, unit) pairs held by fixed threads:
//   the carries h and c stay in registers, xproj's four gate values come
//   by vector loads issued a step ahead, and hs[t], cs[t] are written once.
// - The group barrier is split: a block arrives as soon as it has written
//   hs[t] and builds the next step's list of live rows (from mask values
//   loaded a step ahead) while the others arrive; it waits only before a
//   product.
// - Dead work is skipped.  Rows masked at t are not packed: a 16-row tile
//   of packed rows exists only where a live row needs it, so a group's
//   product shrinks with its live rows, and a group with no live row at t
//   skips the product and the wait.  A masked row passes h and c
//   through; a live one takes m * new + (1 - m) * prev.
// - Deterministic: the only atomics are the group barriers' counters.
//
// Bound.  At the bench shape B = 128, T = 128, H = 512 the work is
// 2 * H * 4H float32 operations per live (row, step): 34.4 GFLOP at full
// lengths, 52% of it for the bench's ragged lengths 16..128, over about
// 205 MB of xproj, w, mask and hs/cs.  In split TF32 the operations run
// at a third of the tensor cores' TF32 rate (165 TFLOP/s on an H100 SXM):
// 0.208 ms full, 0.108 ms ragged; the bytes need 0.061 ms.  The floor in
// practice is the 128 dependent steps, each a group barrier plus a 64 KB
// read from L2 a block; the times are in PERF.md.
//
// Entry point: lstm_fwd(), a plain C function called through ctypes on
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
  const float* xproj;  // [B, T, 4H]
  const float* w;      // [H, 4H]
  const float* h0;     // [B, H]
  const float* c0;     // [B, H]
  const float* mask;   // [B, T]
  float* hs;           // [B, T, H]
  float* cs;           // [B, T, H]
  unsigned int* sync;  // [groups] group barriers
  int B, T, H;
  int groups;          // batch groups of R rows
  int slots;           // groups that run side by side
  int aligned;         // every tensor starts on a 16-byte boundary
};

constexpr int kWideH = 512;           // the widest H that takes 16 units a block; 8 past it
constexpr int kBufs = 4;              // chunks of h_{t-1} in flight
constexpr int kChunk = 4096;          // floats of h a chunk: R rows x 4096 / R columns
constexpr int kStageFloats = 18432;   // max over R of kBufs x R x (kChunk / R + 4); holds the partials too
constexpr int kListInts = 2 * 128 + 4;  // a step's packed rows, each row's place, the count

// hidden units a block owns at this H
inline int fwd_units(int H) { return H <= kWideH ? 16 : 8; }

// W's rows, padded to a multiple of every chunk width (32, 64, 128) so a
// chunk never reads past them, plus 4 so fragment reads miss each other's banks
__host__ __device__ inline int w_ld(int H) { return round_up(H, 128) + 4; }

size_t fwd_smem_bytes(int H) {
  return sizeof(float) * (static_cast<size_t>(4 * fwd_units(H)) * w_ld(H) + kStageFloats) +
         sizeof(int) * kListInts;
}

// acc[mt][nt] += A[rows of m-tile mt] . W[k-step, columns of n-tile nt]
// over this warp's two k8-steps of a staged chunk: NMT live m-tiles of 16
// packed rows (rows wm * 32 ..), all NT n-tiles, in split TF32.  A term
// (one k8-step of one 16 x 8 tile) sums its three products in a fresh
// accumulator; the eight terms of a half (2 m-tiles x 4 n-tiles) are
// interleaved.
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
#pragma unroll
    for (int half = 0; half < NT / 4; ++half) {
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* wr = Ws + ((half * 4 + j) * 8 + g) * ldw + c0 + kl + q;
        fb[j].set(wr[0], wr[4]);
      }
      float tmp[NMT][4][4];
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_first(tmp[mt][j], fa[mt].lo, fb[j].hi);
      }
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(tmp[mt][j], fa[mt].hi, fb[j].lo);
      }
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(tmp[mt][j], fa[mt].hi, fb[j].hi);
      }
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][half * 4 + j][e] += tmp[mt][j][e];
        }
      }
    }
  }
}

// Batch groups of R rows (R / 32 warp rows x 8 / (R / 32) warp K-slices in
// the product) and U hidden units: blockIdx.x = slot * nu + unit block,
// and the slot's groups slot, slot + slots, ... one after the other.
template <int R, int U>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_recurrence(const FwdArgs a) {
  constexpr int kCols = 4 * U;           // gate columns: column c is gate c / U of unit c % U
  constexpr int NT = kCols / 8;          // their n-tiles
  constexpr int kRedLd = kCols + 8;      // a row of the K-slices' partial sums
  constexpr int WM = R / 32, WK = 8 / WM;
  constexpr int CK = kChunk / R, LDS = CK + 4, kBuf = R * LDS;
  constexpr int P = R * U / kThreads;    // consecutive units a thread carries in its row
  constexpr int TPR = U / P;             // threads a row
  static_assert(kBufs * kBuf <= kStageFloats && WK * R * kRedLd <= kStageFloats, "layout");
  static_assert(NT % 4 == 0 && P >= 1, "whole halves of 4 n-tiles; a pair a thread at least");
  static_assert(CK / 8 == 2 * WK, "two k8-steps a warp a chunk");
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, T = a.T, H = a.H, H4 = 4 * H;
  const int ldw = w_ld(H);
  float* Ws = smem;                           // [kCols][ldw]: W[k, col] at Ws[col * ldw + k]
  float* stage = Ws + kCols * ldw;            // kBufs x [R][LDS]; then [WK][R][kRedLd]
  int* lists = reinterpret_cast<int*>(stage + kStageFloats);  // [kListInts]
  const int nu = (H + U - 1) / U;
  const int j0 = (blockIdx.x % nu) * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp % WM, wk = warp / WM;

  for (int i = tid; i < round_up(H, 128) * kCols; i += kThreads) {
    const int k = i / kCols, c = i % kCols, j = j0 + c % U;
    Ws[c * ldw + k] = (k < H && j < H) ? __ldg(a.w + static_cast<size_t>(k) * H4 + (c / U) * H + j)
                                       : 0.0f;
  }
  // this thread's pairs: row r of the group, units u0 .. u0 + P - 1
  const int r = tid / TPR, u0 = (tid % TPR) * P;
  const int n_units = min(P, H - (j0 + u0));  // the units that exist (may be <= 0)
  const bool vec = a.aligned && H % P == 0;   // rows of P floats aligned
  const bool vec4 = a.aligned && H % 4 == 0;  // h rows in 16-byte pieces
  const int nch = (H + CK - 1) / CK;

  for (int group = blockIdx.x / nu; group < a.groups; group += a.slots) {
    const int b0 = group * R;
    const int b = b0 + r;
    const bool mine = b < B && n_units > 0;
    float hc[P], cc[P], nx[4][P], nm = 0.0f;
    if (mine) {
      load_units<P>(a.h0 + static_cast<size_t>(b) * H + j0 + u0, n_units, vec, hc);
      load_units<P>(a.c0 + static_cast<size_t>(b) * H + j0 + u0, n_units, vec, cc);
    }
    // this pair's mask and gate inputs at step t, loaded a step ahead
    auto fetch = [&](int t) {
      if (!mine) return;
      const size_t bt = static_cast<size_t>(b) * T + t;
      nm = __ldg(a.mask + bt);
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        load_units<P>(a.xproj + bt * H4 + gt * H + j0 + u0, n_units, vec, nx[gt]);
      }
    };
    fetch(0);

    // the group's live rows at a step, packed in order: warp 0 builds the
    // list from mask values it loaded a step ahead (R / 32 per lane)
    int* L = lists;  // [R] packed rows, [R] each row's place or -1, the count
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
      if (n_live > 0) {
        // every block of the group has written hs[t - 1]
        if (t > 0) group_wait(a.sync + group, static_cast<unsigned>(t) * nu);
        // pre[packed row, 64 columns] = h_{t-1}[row] . W[:, columns]
        const float* src = t == 0 ? a.h0 : a.hs + static_cast<size_t>(t - 1) * H;
        const size_t stride = t == 0 ? static_cast<size_t>(H) : static_cast<size_t>(T) * H;
        const int n16 = round_up(n_live, 16);
        auto load = [&](int c, float* st) {  // packed rows < n16; rows past n_live and columns past H zero
          if (vec4) {
            for (int i = tid; i < n16 * (CK / 4); i += kThreads) {
              const int rr = i / (CK / 4), col = (i % (CK / 4)) * 4, k = c * CK + col;
              const bool ok = rr < n_live && k < H;
              cp_async16(st + rr * LDS + col,
                         ok ? src + static_cast<size_t>(b0 + L[rr]) * stride + k : a.w, ok ? 16 : 0);
            }
          } else {
            for (int i = tid; i < n16 * CK; i += kThreads) {
              const int rr = i / CK, col = i % CK, k = c * CK + col;
              const bool ok = rr < n_live && k < H;
              cp_async4(st + rr * LDS + col,
                        ok ? src + static_cast<size_t>(b0 + L[rr]) * stride + k : a.w, ok ? 4 : 0);
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
        float* red = stage;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= mts) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = wm * 32 + mt * 16 + g + 8 * hf;
              *reinterpret_cast<float2*>(red + (wk * R + row) * kRedLd + nt * 8 + 2 * q) =
                  make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
            }
          }
        }
        __syncthreads();
      }

      // the cell of this thread's pairs at t
      if (mine) {
        const int pk = L[R + r];
        if (pk >= 0) {
          const float m = nm;
          const float* red = stage + pk * kRedLd + u0;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            float pre[4];
#pragma unroll
            for (int gt = 0; gt < 4; ++gt) {
              float s = 0.0f;
#pragma unroll
              for (int w = 0; w < WK; ++w) s += red[w * R * kRedLd + gt * U + p];
              pre[gt] = s + nx[gt][p];
            }
            const float ig = sigmoidf(pre[0]);
            const float fg = sigmoidf(pre[1]);
            const float gg = tanhf(pre[2]);
            const float og = sigmoidf(pre[3]);
            const float c_new = fg * cc[p] + ig * gg;
            const float h_new = og * tanhf(c_new);
            cc[p] = m * c_new + (1.0f - m) * cc[p];
            hc[p] = m * h_new + (1.0f - m) * hc[p];
          }
        }
        const size_t o = (static_cast<size_t>(b) * T + t) * H + j0 + u0;
        store_units<P>(a.hs + o, n_units, vec, hc);
        store_units<P>(a.cs + o, n_units, vec, cc);
      }
      if (t + 1 < T) {
        // this block has written hs[t] and read the list and the stage:
        // arrive at the group's barrier (every step, so the count is
        // (t + 1) x nu once the group has), then the next step's list and
        // gate inputs while the other blocks arrive (after the release, which
        // would otherwise wait for those loads too)
        group_arrive(a.sync + group);
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
  return R == 32 ? lstm_fwd_recurrence<32, U>
                 : (R == 64 ? lstm_fwd_recurrence<64, U> : lstm_fwd_recurrence<128, U>);
}

Kernel recurrence_kernel(int R, int H) {
  return fwd_units(H) == 16 ? recurrence_kernel<16>(R) : recurrence_kernel<8>(R);
}

}  // namespace

extern "C" {

// Shared memory one block of lstm_fwd takes at this shape (bytes).
int lstm_fwd_smem_bytes(int B, int H) {
  (void)B;
  return static_cast<int>(fwd_smem_bytes(H));
}

// 32-bit words of device memory lstm_fwd() needs for its group barriers.
int lstm_fwd_sync_words(int B, int H) {
  (void)H;
  return (B + 31) / 32;
}

// xproj [B, T, 4H], w [H, 4H], h0/c0 [B, H], mask [B, T], hs/cs [B, T, H]:
// float32, contiguous, on `device`; barrier: lstm_fwd_sync_words(B, H)
// 32-bit words of device memory.  Returns 0, a cudaError_t, kSmemOver or
// kNotResident.
int lstm_fwd(const void* xproj, const void* w, const void* h0, const void* c0,
             const void* mask, void* hs, void* cs, void* barrier, int B, int T, int H,
             int device, void* stream) {
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
  a.c0 = static_cast<const float*>(c0);
  a.mask = static_cast<const float*>(mask);
  a.hs = static_cast<float*>(hs);
  a.cs = static_cast<float*>(cs);
  a.sync = static_cast<unsigned int*>(barrier);
  a.B = B; a.T = T; a.H = H;
  a.aligned = ((reinterpret_cast<uintptr_t>(xproj) | reinterpret_cast<uintptr_t>(w) |
                reinterpret_cast<uintptr_t>(h0) | reinterpret_cast<uintptr_t>(c0) |
                reinterpret_cast<uintptr_t>(hs) | reinterpret_cast<uintptr_t>(cs)) % 16) == 0;
  a.groups = (B + R - 1) / R;
  a.slots = std::min(a.groups, cap / nu);
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int) * a.groups, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return lstm::launch_cooperative(recurrence_kernel(R, H), a, a.slots * nu, smem, device, st);
}

// Blocks of lstm_fwd the card holds at once at this shape's shared memory
// (0 when a block cannot have that much), or minus a cudaError_t.
// kernels/rnn.py's gate needs ceil(H / 16) up to H = 512 and ceil(H / 8)
// past it: one slot.
int lstm_fwd_capacity(int B, int H, int device) {
  (void)B;
  return lstm::resident_capacity(recurrence_kernel(128, H), fwd_smem_bytes(H), device);
}

const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
