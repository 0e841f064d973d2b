// Flash-attention backward for Hopper (sm_90a), float32: K2 (dq) and K3
// (dk, dv).
//
// Replaces the Pallas kernels paddle_tpu/kernels/attention.py:459
// _flash_bwd_dq_kernel and :507 _flash_bwd_dkv_kernel (both launched by
// _pallas_bwd through pl.pallas_call), the FlashAttention-2 backward:
// from the forward's base-2 LSE and delta = rowsum(dO * O) (computed
// outside the kernels, in float32, as the reference does), each kernel
// recomputes the probabilities p = exp2(s - lse) of its tiles, and the
// same dropout bits as the forward, instead of reading a stored
// [Tq, Tk] matrix.  With dp = (dO . v) * drop and ds = p * (dp - delta):
//
//   flash_attn_bwd_dq:  dq = sm_scale * sum_k ds * k      (q-tiled grid)
//   flash_attn_bwd_dkv: dv = sum_q (p * drop) * dO,
//                       dk = sm_scale * sum_q ds * q      (k-tiled grid)
//
// The two grids split the work so that neither needs atomics, and a rerun
// gives the same bits.  lse and delta are inputs, so ring attention can
// pass its global (merged) values, as the reference's
// _pallas_bwd(..., delta=) allows.  The conventions shared with the
// forward are in flash_attn_common.cuh.
//
// Design.  The two kernels have one shape.  A block owns 64 rows of one
// (batch, head), one warp per 16 (K2: query rows, with Q pre-scaled into
// exp2 units and dO resident; K3: keys, with K and V resident), and
// streams the other side 32 rows a tile (K2: K and V; K3: Q pre-scaled
// and dO) through a two-stage cp.async ring, with each streamed key's
// mask bit and its part of the dropout hash (K2) or each streamed row's
// lse, delta and its part of the hash (K3).  Every product runs on the
// tensor cores in split TF32 (tf32x3.cuh: three mma.sync m16n8k8
// products a term, float32-equivalent):
//
//   K2, a warp and a tile:  S = Q . K^T and dP = dO . V^T (16 x 32, kept
//     as C fragments); p, the dropout and dS on the fragments; then
//     dq += dS . K with dS's C fragment as the A fragment (each 8 keys
//     taken in the order 0, 2, 4, 6, 1, 3, 5, 7, K's rows read likewise).
//   K3, transposed:  S^T = K . Q^T and dP^T = V . dO^T (16 keys x 32 rows);
//     dv += (P^T * drop) . dO and dk += dS^T . Q, both from C fragments.
//
// Each streamed tile is read by all four warps, twice in two layouts, so
// it is split into hi and lo parts once, by the block, in shared memory
// (hi in place of the float, lo beside it) after it lands; a warp's own
// resident rows are read by that warp alone and are split as the warp
// reads them.  S and dP take their fragments with ldmatrix and run
// interleaved; each product is a plain (not volatile) asm statement, so
// the compiler overlaps the three dependent products of a term with the
// other terms', and each term is summed in a fresh accumulator and added
// with one rounded float add (the tensor cores truncate as they
// accumulate, and a long chain into one accumulator drifts).
//
// Skipping follows the reference's LOGICAL tiles: a warp skips a
// streamed tile whose pairs it does not visit, and, where every row in
// play has softmax mass on an unmasked key (lse above -1e29), one whose
// pairs are all masked or causally excluded: their p is exactly 0.  A row
// whose keys are all masked gives each of its keys the share 1/n, so a
// tile it touches is never skipped.  Which tiles are live is worked out
// once, from the mask (K2) or lse (K3), before the loop; a tile no warp
// needs is not loaded.  Causal K2 launches its longest q-blocks first.
//
// Bound.  For B=32, H=8, T=256, D=64, ragged key masks (about half the
// keys valid), dropout 0.1: K2 does 6 * D operations on each (row, valid
// key) pair, 3.2 GFLOP (0.020 ms at split TF32's 165 TFLOP/s), on 84 MB
// (0.025 ms at 3.35 TB/s); K3 8 * D a pair, 4.3 GFLOP (0.026 ms), on 101
// MB (0.030 ms).  Both are bound by the bytes.  What holds them above it
// is the instruction stream around the products at 8 warps an SM: on an
// H100, mma.sync m16n8k8 TF32 peaks near 325 TFLOP/s (mma_rate.py), 108
// float32-equivalent in split TF32, and the kernels reach a fraction of
// that, their time going to fragment loads and splits, the accumulators'
// adds, and the exp2 and dropout hash of each score (PERF.md).
//
// Ring attention (flash_attn_common.cuh): flash_attn_bwd_dq_ring() and
// flash_attn_bwd_dkv_ring() run one hop's pairs as one launch of the same
// kernels instantiated for the ring, whose blocks read their pair's
// shards as rows of the whole tensors and add the pair's gradients to
// float32 accumulators where the plain kernels write them.
//
// Entry points: flash_attn_bwd_dq(), flash_attn_bwd_dkv() and their _ring
// twins, plain C functions called through ctypes on PyTorch's current
// stream.  Each launches and returns cudaGetLastError(); none
// synchronises or allocates.  flash_attn_bwd_occupancy() reports each kernel's registers,
// shared memory and resident blocks an SM.

#include "flash_attn_common.cuh"
#include "tf32x3.cuh"

namespace {

using flash::Args;
using flash::drop_of;
using flash::drop_threshold;
using flash::kNegInf;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::mma_tf32;
using tf32x3::mma_tf32_first;

constexpr int kRows = 64;      // rows a block owns (q rows for dq, keys for dk/dv)
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kTile = 32;      // streamed rows a tile
constexpr int kInfo = 4;       // words of per-row (per-key) info a streamed row
// a row whose lse is above this has softmax mass on an unmasked key, so a
// masked or causally excluded key gives it p = exp2(-1e30 - lse) = 0
constexpr float kHasMass = -1e29f;

template <int DP>
constexpr int smem_floats() {
  // resident [2][64][DP + 4], stages [2][2][32][DP + 4], lo [2][32][DP + 4],
  // info [2][kInfo][32]; the live-tile bits follow
  return (2 * kRows + 6 * kTile) * (DP + 4) + 2 * kInfo * kTile;
}

__host__ __device__ inline int bit_words(int ntiles) { return (ntiles + 31) / 32; }

// acc1[j] += a1 * b1[j] and acc2[j] += a2 * b2[j], j < 4, in split TF32
// (tf32x3::mma3's three products a term, small ones first).  The eight
// terms' products are interleaved, so each of the three dependent steps
// of a term overlaps the other seven's.  Each term is summed in a fresh
// accumulator, then added to acc with one rounded float add a value: the
// tensor cores truncate as they accumulate, so a long chain of mma.sync
// into one accumulator (32 deep over a T=256 tile loop, 3,000 at T=8192)
// drifts
__device__ __forceinline__ void mma3_add8(float (*acc1)[4], const FragA& a1,
                                          const FragB (&b1)[4], float (*acc2)[4],
                                          const FragA& a2, const FragB (&b2)[4]) {
  float t1[4][4], t2[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mma_tf32_first(t1[j], a1.lo, b1[j].hi);
    mma_tf32_first(t2[j], a2.lo, b2[j].hi);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mma_tf32(t1[j], a1.hi, b1[j].lo);
    mma_tf32(t2[j], a2.hi, b2[j].lo);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mma_tf32(t1[j], a1.hi, b1[j].hi);
    mma_tf32(t2[j], a2.hi, b2[j].hi);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc1[j][e] += t1[j][e];
      acc2[j][e] += t2[j][e];
    }
  }
}

// four 8 x 4-word blocks of shared memory, a register each: lane l gives
// the address of row l % 8 of block l / 8 (16 bytes, 16-byte aligned),
// and thread 4g + q receives word q of row g of every block, the
// mma.sync fragment layout
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const float* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// the B fragments of four 8-wide column tiles of a split stage in the
// C -> A layout: rows r0 + 2q (+1), columns c0 + 8j + g
template <int LD>
__device__ __forceinline__ void load_b4(FragB (&fb)[4], const float* Bh, const float* Bl,
                                        int r0, int c0, int g, int q) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = (r0 + 2 * q) * LD + c0 + 8 * j + g;
    const int o2 = o + LD;
    fb[j].hi[0] = __float_as_uint(Bh[o]);
    fb[j].hi[1] = __float_as_uint(Bh[o2]);
    fb[j].lo[0] = __float_as_uint(Bl[o]);
    fb[j].lo[1] = __float_as_uint(Bl[o2]);
  }
}

// cp.async of NR rows (from row r0) of two [n_rows, D] matrices into
// [NR][DP + 4] buffers, zero past n_rows and D: the resident rows
// (NR = 64) and the streamed tiles (NR = 32)
template <int DP, bool VEC, int NR>
__device__ void stage_rows(float* d1, float* d2, const float* s1, const float* s2, int r0,
                           int n_rows, int D, int tid) {
  constexpr int LD = DP + 4;
  if (VEC) {  // D % 4 == 0
    for (int i = tid; i < NR * DP / 4; i += kThreads) {
      const int j = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const bool ok = r0 + j < n_rows && c < D;
      const size_t off = static_cast<size_t>(r0 + j) * D + c;
      cp_async16(d1 + j * LD + c, ok ? s1 + off : s1, ok ? 16 : 0);
      cp_async16(d2 + j * LD + c, ok ? s2 + off : s2, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < NR * DP; i += kThreads) {
      const int j = i / DP, c = i - j * DP;
      const bool ok = r0 + j < n_rows && c < D;
      const size_t off = static_cast<size_t>(r0 + j) * D + c;
      cp_async4(d1 + j * LD + c, ok ? s1 + off : s1, ok ? 4 : 0);
      cp_async4(d2 + j * LD + c, ok ? s2 + off : s2, ok ? 4 : 0);
    }
  }
}

// x *= scale over the 64 resident rows (K2's Q into exp2 units, the
// same float32 product the reference takes)
template <int DP>
__device__ void scale_rows(float* x, float scale, int tid) {
  constexpr int LD = DP + 4;
  for (int i = tid; i < kRows * DP / 4; i += kThreads) {
    const int j = i / (DP / 4), c = (i % (DP / 4)) * 4;
    float4* p = reinterpret_cast<float4*>(x + j * LD + c);
    float4 v = *p;
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    *p = v;
  }
}

// split a landed stage once for the block: hi (of x * scale) in place of
// the float, lo into `lo`
template <int DP>
__device__ void split_stage(float* hi, float* lo, float scale, int tid) {
  constexpr int LD = DP + 4;
  for (int i = tid; i < kTile * DP / 4; i += kThreads) {
    const int j = i / (DP / 4), c = (i % (DP / 4)) * 4;
    float4* hp = reinterpret_cast<float4*>(hi + j * LD + c);
    float4 x = *hp;
    uint32_t h[4], l[4];
    tf32x3::split(x.x * scale, h[0], l[0]);
    tf32x3::split(x.y * scale, h[1], l[1]);
    tf32x3::split(x.z * scale, h[2], l[2]);
    tf32x3::split(x.w * scale, h[3], l[3]);
    *hp = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo + j * LD + c) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                    __uint_as_float(l[3]));
  }
}

// bits[t / 32] bit t % 32 = any (ANY) or all (!ANY) of pred(t * 32 + lane)
// over the 32 lanes, for the tiles t < ntiles; the warps share the words
// (eight tiles' loads are issued before any is reduced)
template <bool ANY, typename Pred>
__device__ void tile_bits(uint32_t* bits, int ntiles, int warp, int lane, Pred pred) {
  for (int w = warp; w < bit_words(ntiles); w += kThreads / 32) {
    bool mine = false;
    for (int j0 = 0; j0 < 32 && w * 32 + j0 < ntiles; j0 += 8) {
      bool v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = w * 32 + j0 + u;
        v[u] = t < ntiles ? pred(t * kTile + lane) : !ANY;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool r = ANY ? __any_sync(0xffffffffu, v[u]) : __all_sync(0xffffffffu, v[u]);
        if (lane == j0 + u) mine = r;
      }
    }
    const uint32_t word = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) bits[w] = word;
  }
}

__device__ __forceinline__ bool bit(const uint32_t* bits, int t) {
  return (bits[t >> 5] >> (t & 31)) & 1u;
}

// s += A1 . B1^T and dp += A2 . B2^T (16 x 32 each, C fragments), the
// two products' steps interleaved: A1, A2 the warp's 16 resident rows
// (raw float32, split here), B1, B2 the 32 streamed rows of split stages
// (K2: Q K^T and dO V^T; K3: K Q^T and V dO^T), every fragment read with
// ldmatrix.  The columns past D are zeros and are multiplied all the
// same: a loop that stops at D would put each 8 columns in a block of
// their own, and the mma.sync chains of one could not overlap the next's
template <int DP>
__device__ __forceinline__ void products_abt(float (&s)[4][4], float (&dp)[4][4],
                                             const float* A1, const float* A2,
                                             const float* B1h, const float* B1l,
                                             const float* B2h, const float* B2l, int lane) {
  constexpr int LD = DP + 4;
  // A's blocks: rows 0-7, 8-15 at column 0, then at column 4 (a0..a3);
  // B's: rows 0-7 at columns 0 and 4, then rows 8-15 (two 8-row tiles)
  const int ao = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
  const int bo = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int kd = 0; kd < DP; kd += 8) {
    uint32_t x1[4], x2[4];
    ldmatrix4(x1, A1 + ao + kd);
    ldmatrix4(x2, A2 + ao + kd);
    FragA f1, f2;
    f1.set(__uint_as_float(x1[0]), __uint_as_float(x1[1]), __uint_as_float(x1[2]),
           __uint_as_float(x1[3]));
    f2.set(__uint_as_float(x2[0]), __uint_as_float(x2[1]), __uint_as_float(x2[2]),
           __uint_as_float(x2[3]));
    FragB b1[4], b2[4];
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      const int o = pair * 16 * LD + bo + kd;
      uint32_t h1[4], l1[4], h2[4], l2[4];
      ldmatrix4(h1, B1h + o);
      ldmatrix4(l1, B1l + o);
      ldmatrix4(h2, B2h + o);
      ldmatrix4(l2, B2l + o);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        b1[2 * pair + u].hi[0] = h1[2 * u];
        b1[2 * pair + u].hi[1] = h1[2 * u + 1];
        b1[2 * pair + u].lo[0] = l1[2 * u];
        b1[2 * pair + u].lo[1] = l1[2 * u + 1];
        b2[2 * pair + u].hi[0] = h2[2 * u];
        b2[2 * pair + u].hi[1] = h2[2 * u + 1];
        b2[2 * pair + u].lo[0] = l2[2 * u];
        b2[2 * pair + u].lo[1] = l2[2 * u + 1];
      }
    }
    mma3_add8(s, f1, b1, dp, f2, b2);
  }
}

// acc (16 x DP, C fragments) += P . B: P 16 x 32 in C fragments, used as
// A fragments (keys 2q, 2q + 1 of each 8 as k = q, q + 4), B the 32
// streamed rows of a split stage read in the same order (all DP columns,
// as in products_abt; those past D are not stored).  Two 8-key tiles are
// taken at a time, their terms added to acc one after the other.
template <int DP>
__device__ __forceinline__ void product_pb(float (&acc)[DP / 8][4], const float (&p)[4][4],
                                           const float* Bh, const float* Bl, int g, int q) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int nt = 0; nt < 4; nt += 2) {
    FragA a1, a2;
    a1.set(p[nt][0], p[nt][2], p[nt][1], p[nt][3]);
    a2.set(p[nt + 1][0], p[nt + 1][2], p[nt + 1][1], p[nt + 1][3]);
#pragma unroll
    for (int dt0 = 0; dt0 < DP / 8; dt0 += 4) {
      FragB b1[4], b2[4];
      load_b4<LD>(b1, Bh, Bl, nt * 8, dt0 * 8, g, q);
      load_b4<LD>(b2, Bh, Bl, nt * 8 + 8, dt0 * 8, g, q);
      mma3_add8(acc + dt0, a1, b1, acc + dt0, a2, b2);
    }
  }
}

// acc1 += P1 . B1 and acc2 += P2 . B2 (as product_pb), the two products'
// steps interleaved: K3's dv += (P^T * drop) . dO and dk += dS^T . Q
template <int DP>
__device__ __forceinline__ void products_pb(float (&acc1)[DP / 8][4], const float (&p1)[4][4],
                                            const float* B1h, const float* B1l,
                                            float (&acc2)[DP / 8][4], const float (&p2)[4][4],
                                            const float* B2h, const float* B2l, int g, int q) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    FragA a1, a2;
    a1.set(p1[nt][0], p1[nt][2], p1[nt][1], p1[nt][3]);
    a2.set(p2[nt][0], p2[nt][2], p2[nt][1], p2[nt][3]);
#pragma unroll
    for (int dt0 = 0; dt0 < DP / 8; dt0 += 4) {
      FragB b1[4], b2[4];
      load_b4<LD>(b1, B1h, B1l, nt * 8, dt0 * 8, g, q);
      load_b4<LD>(b2, B2h, B2l, nt * 8, dt0 * 8, g, q);
      mma3_add8(acc1 + dt0, a1, b1, acc2 + dt0, a2, b2);
    }
  }
}

// the 16 x DP C fragments of a warp, times `scale`, into rows
// first_row + (0..15) of a [n_rows, D] matrix
template <int DP>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[DP / 8][4],
                                           int first_row, int n_rows, int D, float scale,
                                           int g, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = first_row + g + 8 * h;
    if (row >= n_rows) continue;
    float* op = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int d = dt * 8 + 2 * q;
      if (d < D) op[d] = acc[dt][2 * h] * scale;
      if (d + 1 < D) op[d + 1] = acc[dt][2 * h + 1] * scale;
    }
  }
}

// ring: the 16 x DP C fragments times `scale` (a pair's gradient rows)
// added to rows first_row + (0..15) of a float32 accumulator [n_rows, D]
// (written on the first hop); on the last, the sums go to `dst` instead
template <int DP>
__device__ __forceinline__ void sum_rows(float* acc, float* dst, const float (&g)[DP / 8][4],
                                         int first_row, int n_rows, int D, float scale,
                                         bool first, bool last, int gi, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = first_row + gi + 8 * h;
    if (row >= n_rows) continue;
    float* ap = acc + static_cast<size_t>(row) * D;
    float* op = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dt * 8 + 2 * q + e;
        if (d >= D) continue;
        const float x = g[dt][2 * h + e] * scale;
        (last ? op : ap)[d] = first ? x : ap[d] + x;
      }
    }
  }
}

template <int DP, bool VEC, bool RING>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a, const __grid_constant__ flash::Ring r) {
  constexpr int LD = DP + 4;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // [64][LD], pre-scaled
  float* Os = Qs + kRows * LD;             // dO [64][LD]
  float* Ks = Os + kRows * LD;             // [2][32][LD]: raw, then hi
  float* Vs = Ks + 2 * kTile * LD;         // [2][32][LD]
  float* KL = Vs + 2 * kTile * LD;         // [32][LD] lo
  float* VL = KL + kTile * LD;             // [32][LD] lo
  uint32_t* info = reinterpret_cast<uint32_t*>(VL + kTile * LD);  // [2][kInfo][32]
  uint32_t* any_valid = info + 2 * kInfo * kTile;                 // a bit a key tile
  __shared__ int w_kend[4], w_mass[4], w_last[4];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  // a ring launch's pair (the plain kernel keeps its own expressions)
  const flash::PairAt pc = flash::pair_at<RING>(a, r, bh, blockIdx.z);
  const int causal = RING ? pc.causal : a.causal;
  // causal: the last q-blocks visit the most keys, so they are launched
  // first and the short ones fill the tail
  const int row0 = static_cast<int>(causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const size_t qrow = RING ? pc.qrow : static_cast<size_t>(bh) * Tq;
  const size_t qoff = RING ? pc.qrow * D : static_cast<size_t>(bh) * Tq * D;
  const float* kbase = a.k + (RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D);
  const float* vbase = a.v + (RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D);
  const float* mrow =
      a.mask ? a.mask + (RING ? pc.mrow : static_cast<size_t>(b) * Tk) : nullptr;

  // the resident rows land with the first tile (Q is scaled after)
  stage_rows<DP, VEC, kRows>(Qs, Os, a.q + qoff, a.dout + qoff, row0, Tq, D, tid);

  // this thread's two rows (fragment rows g and g + 8 of its warp)
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const uint32_t seed = flash::seed_of<RING>(a, r, blockIdx.z);
  const uint32_t threshold = drop_threshold(a.rate);
  float lse[2], delta[2];
  int kend[2];
  uint32_t row_x[2], row_salt[2];
  bool mass = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    const bool ok = row < Tq;
    const size_t ridx = qrow + (ok ? row : 0);
    lse[h] = ok ? a.lse[ridx] : 0.0f;
    delta[h] = ok ? a.delta[ridx] : 0.0f;
    kend[h] = ok ? flash::key_end(row, Tk, causal, a.bq, a.bk) : 0;
    row_x[h] = flash::drop_row_x(row, a.bq);
    row_salt[h] = flash::drop_row_salt(row, a.bq, seed, bh);
    mass = mass && (!ok || lse[h] > kHasMass);
  }
  mass = __all_sync(0xffffffffu, mass);
  const int wfirst = row0 + warp * 16;
  const int wlast = min(wfirst + 15, Tq - 1);
  if (lane == 0) {
    w_kend[warp] = wfirst < Tq ? flash::key_end(wlast, Tk, causal, a.bq, a.bk) : 0;
    w_mass[warp] = mass;
    w_last[warp] = wlast;
  }
  const int last_row = min(row0 + kRows, Tq) - 1;
  const int kend_blk = min(flash::key_end(last_row, Tk, causal, a.bq, a.bk), Tk);
  const int ntiles = (kend_blk + kTile - 1) / kTile;
  tile_bits<true>(any_valid, ntiles, warp, lane, [&](int key) {
    return key < Tk && (mrow == nullptr || mrow[key] > 0.0f);
  });
  __syncthreads();

  // a key tile is live for warp w unless its pairs are unvisited, or every
  // row of w has mass and the tile's keys are all masked or causally past
  // the warp's last row
  auto live_for = [&](int t, int w) {
    const int k0 = t * kTile;
    if (k0 >= w_kend[w]) return false;
    if (!w_mass[w]) return true;
    return bit(any_valid, t) && !(causal && k0 > w_last[w]);
  };
  auto next_live = [&](int t) {
    for (; t < ntiles; ++t) {
      if (live_for(t, 0) || live_for(t, 1) || live_for(t, 2) || live_for(t, 3)) return t;
    }
    return ntiles;
  };
  auto load = [&](int t, int st) {
    const int k0 = t * kTile;
    stage_rows<DP, VEC, kTile>(Ks + st * kTile * LD, Vs + st * kTile * LD, kbase, vbase, k0,
                               Tk, D, tid);
    uint32_t* inf = info + st * kInfo * kTile;
    for (int j = tid; j < kTile; j += kThreads) {
      const int key = k0 + j;
      // the key's mask value (a key is valid where it is > 0), or 1
      if (mrow != nullptr) {
        cp_async4(inf + j, key < Tk ? mrow + key : mrow, key < Tk ? 4 : 0);
      } else {
        inf[j] = __float_as_uint(key < Tk ? 1.0f : 0.0f);
      }
      inf[kTile + j] = flash::drop_key_x(key, a.bk);
      inf[2 * kTile + j] = flash::drop_key_salt(key, a.bk);
    }
  };

  float dq[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.0f;

  int t = next_live(0);
  if (t < ntiles) load(t, 0);
  cp_async_commit();
  for (int st = 0, first = 1; t < ntiles; st ^= 1, first = 0) {
    const int tn = next_live(t + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with the last one
    if (tn < ntiles) load(tn, st ^ 1);
    cp_async_commit();
    if (first) scale_rows<DP>(Qs, a.scale_log2, tid);
    float* Kt = Ks + st * kTile * LD;
    float* Vt = Vs + st * kTile * LD;
    split_stage<DP>(Kt, KL, 1.0f, tid);
    split_stage<DP>(Vt, VL, 1.0f, tid);
    __syncthreads();
    if (live_for(t, warp)) {
      const int k0 = t * kTile;
      const uint32_t* inf = info + st * kInfo * kTile;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
      }
      products_abt<DP>(s, dp, Qs + warp * 16 * LD, Os + warp * 16 * LD, Kt, KL, Vt, VL,
                       lane);
      // dS = p * (dP * drop - delta); an unvisited key has p = 0, a masked
      // or causally excluded one scores the finite -1e30
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int jj = nt * 8 + 2 * q + (e & 1);
          const int key = k0 + jj;
          const bool keep = __uint_as_float(inf[jj]) > 0.0f && (!causal || key <= rows[h]);
          const float p = (key < kend[h] && key < Tk)
                              ? exp2f((keep ? s[nt][e] : kNegInf) - lse[h])
                              : 0.0f;
          float dpv = dp[nt][e];
          if (a.rate > 0.0f) {
            dpv *= drop_of(row_x[h], row_salt[h], inf[kTile + jj], inf[2 * kTile + jj],
                           threshold, a.keep_scale);
          }
          s[nt][e] = p * (dpv - delta[h]);
        }
      }
      product_pb<DP>(dq, s, Kt, KL, g, q);
    }
    t = tn;
  }
  cp_async_wait<0>();  // the resident rows, where no tile was live
  if constexpr (RING) {
    sum_rows<DP>(r.acc + qoff, a.out + qoff, dq, row0 + warp * 16, Tq, D, a.grad_scale,
                 (pc.flags & flash::kRingFirst) != 0u, (pc.flags & flash::kRingLastQ) != 0u, g, q);
  } else {
    store_rows<DP>(a.out + qoff, dq, row0 + warp * 16, Tq, D, a.grad_scale, g, q);
  }
}

template <int DP, bool VEC, bool RING>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Args a, const __grid_constant__ flash::Ring r) {
  constexpr int LD = DP + 4;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                        // [64][LD]
  float* Vs = Ks + kRows * LD;             // [64][LD]
  float* Qs = Vs + kRows * LD;             // [2][32][LD]: raw, then hi (pre-scaled)
  float* Os = Qs + 2 * kTile * LD;         // dO [2][32][LD]
  float* QL = Os + 2 * kTile * LD;         // [32][LD] lo
  float* OL = QL + kTile * LD;             // [32][LD] lo
  uint32_t* info = reinterpret_cast<uint32_t*>(OL + kTile * LD);  // [2][kInfo][32]
  uint32_t* all_mass = info + 2 * kInfo * kTile;                  // a bit a row tile
  __shared__ int w_rbeg[4], w_any[4], w_first[4];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  // a ring launch's pair (the plain kernel keeps its own expressions)
  const flash::PairAt pc = flash::pair_at<RING>(a, r, bh, blockIdx.z);
  const int causal = RING ? pc.causal : a.causal;
  const int key0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const size_t koff = RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D;
  const float* qbase = a.q + (RING ? pc.qrow * D : static_cast<size_t>(bh) * Tq * D);
  const float* dobase = a.dout + (RING ? pc.qrow * D : static_cast<size_t>(bh) * Tq * D);
  const float* lbase = a.lse + (RING ? pc.qrow : static_cast<size_t>(bh) * Tq);
  const float* dbase = a.delta + (RING ? pc.qrow : static_cast<size_t>(bh) * Tq);

  // the resident rows land with the first tile
  stage_rows<DP, VEC, kRows>(Ks, Vs, a.k + koff, a.v + koff, key0, Tk, D, tid);

  // this thread's two keys (fragment rows g and g + 8 of its warp)
  const int keys[2] = {key0 + warp * 16 + g, key0 + warp * 16 + g + 8};
  const uint32_t seed = flash::seed_of<RING>(a, r, blockIdx.z);
  const uint32_t threshold = drop_threshold(a.rate);
  bool valid[2];
  int rbeg[2];
  uint32_t key_x[2], key_salt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = keys[h];
    const bool ok = key < Tk;
    valid[h] = ok && (a.mask == nullptr ||
                      a.mask[(RING ? pc.mrow : static_cast<size_t>(b) * Tk) + key] > 0.0f);
    rbeg[h] = ok ? flash::row_begin(key, Tq, causal, a.bq, a.bk) : Tq;
    key_x[h] = flash::drop_key_x(key, a.bk);
    key_salt[h] = flash::drop_key_salt(key, a.bk);
  }
  const bool any = __any_sync(0xffffffffu, valid[0] || valid[1]);
  const int wfirst = key0 + warp * 16;
  if (lane == 0) {
    w_rbeg[warp] = wfirst < Tk ? flash::row_begin(wfirst, Tq, causal, a.bq, a.bk) : 1 << 30;
    w_any[warp] = any;
    w_first[warp] = wfirst;
  }
  const int ntiles = (Tq + kTile - 1) / kTile;
  tile_bits<false>(all_mass, ntiles, warp, lane,
                   [&](int row) { return row >= Tq || lbase[row] > kHasMass; });
  __syncthreads();

  // a row tile is live for warp w unless its pairs are unvisited, or every
  // row of it has mass and the warp's keys are all masked or causally past
  // the tile's last row
  auto live_for = [&](int t, int w) {
    const int i0 = t * kTile;
    if (i0 + kTile <= w_rbeg[w]) return false;
    if (!bit(all_mass, t)) return true;
    return w_any[w] && !(causal && i0 + kTile - 1 < w_first[w]);
  };
  auto next_live = [&](int t) {
    for (; t < ntiles; ++t) {
      if (live_for(t, 0) || live_for(t, 1) || live_for(t, 2) || live_for(t, 3)) return t;
    }
    return ntiles;
  };
  auto load = [&](int t, int st) {
    const int i0 = t * kTile;
    stage_rows<DP, VEC, kTile>(Qs + st * kTile * LD, Os + st * kTile * LD, qbase, dobase, i0,
                               Tq, D, tid);
    uint32_t* inf = info + st * kInfo * kTile;
    for (int j = tid; j < kTile; j += kThreads) {
      const int row = i0 + j;
      const bool ok = row < Tq;
      cp_async4(inf + j, ok ? lbase + row : lbase, ok ? 4 : 0);
      cp_async4(inf + kTile + j, ok ? dbase + row : dbase, ok ? 4 : 0);
      inf[2 * kTile + j] = flash::drop_row_x(row, a.bq);
      inf[3 * kTile + j] = flash::drop_row_salt(row, a.bq, seed, bh);
    }
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.0f;
  }

  // the block starts at the reference's clamped first q-block of its
  // first key (_first_qb), a multiple of bq and so of the tile
  int t = next_live(flash::row_begin(key0, Tq, causal, a.bq, a.bk) / kTile);
  if (t < ntiles) load(t, 0);
  cp_async_commit();
  for (int st = 0; t < ntiles; st ^= 1) {
    const int tn = next_live(t + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with the last one
    if (tn < ntiles) load(tn, st ^ 1);
    cp_async_commit();
    float* Qt = Qs + st * kTile * LD;
    float* Ot = Os + st * kTile * LD;
    split_stage<DP>(Qt, QL, a.scale_log2, tid);
    split_stage<DP>(Ot, OL, 1.0f, tid);
    __syncthreads();
    if (live_for(t, warp)) {
      const int i0 = t * kTile;
      const uint32_t* inf = info + st * kInfo * kTile;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
      }
      products_abt<DP>(s, dp, Ks + warp * 16 * LD, Vs + warp * 16 * LD, Qt, QL, Ot, OL,
                       lane);
      // P^T * drop into s, dS^T = P^T * (dP^T * drop - delta) into dp; an
      // unvisited row has p = 0, a masked or causally excluded key scores
      // the finite -1e30
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int jj = nt * 8 + 2 * q + (e & 1);
          const int row = i0 + jj;
          const bool keep = valid[h] && (!causal || keys[h] <= row);
          const float p = (row >= rbeg[h] && row < Tq)
                              ? exp2f((keep ? s[nt][e] : kNegInf) -
                                      __uint_as_float(inf[jj]))
                              : 0.0f;
          float drop = 1.0f;
          if (a.rate > 0.0f) {
            drop = drop_of(inf[2 * kTile + jj], inf[3 * kTile + jj], key_x[h], key_salt[h],
                           threshold, a.keep_scale);
          }
          s[nt][e] = p * drop;
          dp[nt][e] = p * (dp[nt][e] * drop - __uint_as_float(inf[kTile + jj]));
        }
      }
      products_pb<DP>(dv, s, Ot, OL, dk, dp, Qt, QL, g, q);
    }
    t = tn;
  }
  cp_async_wait<0>();  // the resident rows, where no tile was live
  if constexpr (RING) {
    const bool first = (pc.flags & flash::kRingFirst) != 0u;
    const bool last = (pc.flags & flash::kRingLastKv) != 0u;
    sum_rows<DP>(r.acc + koff, a.dk + koff, dk, key0 + warp * 16, Tk, D, a.grad_scale, first,
                 last, g, q);
    sum_rows<DP>(r.acc2 + koff, a.dv + koff, dv, key0 + warp * 16, Tk, D, 1.0f, first, last, g,
                 q);
  } else {
    store_rows<DP>(a.dk + koff, dk, key0 + warp * 16, Tk, D, a.grad_scale, g, q);
    store_rows<DP>(a.dv + koff, dv, key0 + warp * 16, Tk, D, 1.0f, g, q);
  }
}

// dynamic shared memory of a launch: the fixed part and the live-tile bits
template <int DP>
size_t smem_bytes(int n_streamed) {
  return sizeof(float) * (smem_floats<DP>() + bit_words((n_streamed + kTile - 1) / kTile));
}

template <typename K>
cudaError_t launch_kernel(K kernel, const Args& a, const flash::Ring& r, int n_pairs, int n_own,
                          size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // a ring launch: every pair's blocks, the pair in z
  const dim3 grid(a.B * a.H, (n_own + kRows - 1) / kRows, n_pairs);
  kernel<<<grid, kThreads, smem, st>>>(a, r);
  return cudaGetLastError();
}

template <int DP, bool RING>
cudaError_t launch_dq(const Args& a, const flash::Ring& r, cudaStream_t st) {
  const size_t smem = smem_bytes<DP>(a.Tk);
  const int n = RING ? r.n : 1;
  return a.D % 4 == 0
             ? launch_kernel(flash_bwd_dq_kernel<DP, true, RING>, a, r, n, a.Tq, smem, st)
             : launch_kernel(flash_bwd_dq_kernel<DP, false, RING>, a, r, n, a.Tq, smem, st);
}

template <int DP, bool RING>
cudaError_t launch_dkv(const Args& a, const flash::Ring& r, cudaStream_t st) {
  const size_t smem = smem_bytes<DP>(a.Tq);
  const int n = RING ? r.n : 1;
  return a.D % 4 == 0
             ? launch_kernel(flash_bwd_dkv_kernel<DP, true, RING>, a, r, n, a.Tk, smem, st)
             : launch_kernel(flash_bwd_dkv_kernel<DP, false, RING>, a, r, n, a.Tk, smem, st);
}

template <bool DQ, bool RING>
cudaError_t launch_d(const Args& a, const flash::Ring& r, cudaStream_t st) {
  if (a.D <= 32) return DQ ? launch_dq<32, RING>(a, r, st) : launch_dkv<32, RING>(a, r, st);
  if (a.D <= 64) return DQ ? launch_dq<64, RING>(a, r, st) : launch_dkv<64, RING>(a, r, st);
  return DQ ? launch_dq<128, RING>(a, r, st) : launch_dkv<128, RING>(a, r, st);
}

// registers a thread, static and dynamic shared memory a block, resident
// blocks an SM
template <typename K>
cudaError_t occupancy(K kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return cudaSuccess;
}

template <int DP>
cudaError_t occupancy_dp(int Tq, int Tk, int* out) {
  cudaError_t err = occupancy(flash_bwd_dq_kernel<DP, true, false>, smem_bytes<DP>(Tk), out);
  if (err != cudaSuccess) return err;
  return occupancy(flash_bwd_dkv_kernel<DP, true, false>, smem_bytes<DP>(Tq), out + 4);
}

bool bad_shape(int B, int H, int Tq, int Tk, int D, int bq, int bk) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
         bq <= 0 || bk <= 0 || (Tq + kRows - 1) / kRows > 65535 ||
         (Tk + kRows - 1) / kRows > 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* mask,
               const void* seed, const void* dout, const void* lse,
               const void* delta, int B, int H, int Tq, int Tk, int D,
               int causal, float scale_log2, float grad_scale, float rate,
               float keep_scale, int bq, int bk) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const float*>(mask);
  a.seed = static_cast<const int32_t*>(seed);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.causal = causal;
  a.scale_log2 = scale_log2;
  a.grad_scale = grad_scale;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.bq = bq; a.bk = bk;
  return a;
}

}  // namespace

extern "C" {

// q/dout/dq [B, H, Tq, D], k/v [B, H, Tk, D] float32; mask [B, Tk]
// float32 or null; seed [1] int32 or null; lse/delta [B*H, Tq] float32.
// dq_scale is sm_scale.  All contiguous and on `device`; the launch goes
// to `stream`.  Returns a cudaError_t.
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* mask, const void* seed, const void* dout,
                      const void* lse, const void* delta, void* dq, int B,
                      int H, int Tq, int Tk, int D, int causal,
                      float scale_log2, float dq_scale, float rate,
                      float keep_scale, int bq, int bk, int device,
                      void* stream) {
  if (bad_shape(B, H, Tq, Tk, D, bq, bk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = make_args(q, k, v, mask, seed, dout, lse, delta, B, H, Tq, Tk, D,
                     causal, scale_log2, dq_scale, rate, keep_scale, bq, bk);
  a.out = static_cast<float*>(dq);
  return static_cast<int>(
      launch_d<true, false>(a, flash::Ring{}, static_cast<cudaStream_t>(stream)));
}

// as flash_attn_bwd_dq, writing dk/dv [B, H, Tk, D]; dk_scale is
// sm_scale / scale_log2 (the q tile is held pre-scaled).
int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* mask, const void* seed, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int B, int H, int Tq, int Tk, int D, int causal,
                       float scale_log2, float dk_scale, float rate,
                       float keep_scale, int bq, int bk, int device,
                       void* stream) {
  if (bad_shape(B, H, Tq, Tk, D, bq, bk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = make_args(q, k, v, mask, seed, dout, lse, delta, B, H, Tq, Tk, D,
                     causal, scale_log2, dk_scale, rate, keep_scale, bq, bk);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return static_cast<int>(
      launch_d<false, false>(a, flash::Ring{}, static_cast<cudaStream_t>(stream)));
}

// Ring attention's hop launches (flash_attn_common.cuh): q/dout [B, H, sp
// * Sq, D], k/v [B, H, sp * Sk, D] float32 whole; mask [B, sp * Sk]
// float32 or null; seeds [sp, sp] int32; lse/delta [B*H, sp * Sq]
// float32; the n_pairs entries of `pairs` (host memory, i | j << 12 |
// flags << 24).  K2 adds each pair's dq to acc1 [B, H, sp * Sq, D]
// float32 and writes out1 (may be acc1) on a q shard's last pair; K3 its
// dk, dv to acc1, acc2 [B, H, sp * Sk, D] and writes out1, out2 on a kv
// shard's last pair.  o and delta_out must be null (the float32 K2 reads
// delta).  grad_scale as flash_attn_bwd_dq's dq_scale or
// flash_attn_bwd_dkv's dk_scale.  Returns a cudaError_t.
static int bwd_ring(bool dq, const void* q, const void* k, const void* v, const void* mask,
                    const void* seeds, const void* dout, const void* lse, const void* delta,
                    const void* o, const void* delta_out, void* acc1, void* acc2, void* out1,
                    void* out2, int B, int H, int sp, int Sq, int Sk, int D, float scale_log2,
                    float grad_scale, float rate, float keep_scale, int bq, int bk, int n_pairs,
                    const uint32_t* pairs, int device, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, bq, bk) || sp <= 0 || sp >= 4096 || n_pairs <= 0 ||
      n_pairs > flash::kRingMaxPairs || seeds == nullptr || delta == nullptr || o != nullptr ||
      delta_out != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = make_args(q, k, v, mask, nullptr, dout, lse, delta, B, H, Sq, Sk, D, 0, scale_log2,
                     grad_scale, rate, keep_scale, bq, bk);
  flash::Ring r{};
  r.n = n_pairs;
  r.sp = sp;
  r.Sq = Sq;
  r.Sk = Sk;
  r.seeds = static_cast<const int32_t*>(seeds);
  r.acc = static_cast<float*>(acc1);
  r.acc2 = static_cast<float*>(acc2);
  for (int i = 0; i < n_pairs; ++i) r.pair[i] = pairs[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dq) {
    a.out = static_cast<float*>(out1);
    return static_cast<int>(launch_d<true, true>(a, r, st));
  }
  a.dk = static_cast<float*>(out1);
  a.dv = static_cast<float*>(out2);
  return static_cast<int>(launch_d<false, true>(a, r, st));
}

int flash_attn_bwd_dq_ring(const void* q, const void* k, const void* v, const void* mask,
                           const void* seeds, const void* dout, const void* lse,
                           const void* delta, const void* o, void* delta_out, void* dq_acc,
                           void* dq, int B, int H, int sp, int Sq, int Sk, int D,
                           float scale_log2, float dq_scale, float rate, float keep_scale,
                           int bq, int bk, int n_pairs, const uint32_t* pairs, int device,
                           void* stream) {
  return bwd_ring(true, q, k, v, mask, seeds, dout, lse, delta, o, delta_out, dq_acc, nullptr,
                  dq, nullptr, B, H, sp, Sq, Sk, D, scale_log2, dq_scale, rate, keep_scale, bq,
                  bk, n_pairs, pairs, device, stream);
}

int flash_attn_bwd_dkv_ring(const void* q, const void* k, const void* v, const void* mask,
                            const void* seeds, const void* dout, const void* lse,
                            const void* delta, void* dk_acc, void* dv_acc, void* dk, void* dv,
                            int B, int H, int sp, int Sq, int Sk, int D, float scale_log2,
                            float dk_scale, float rate, float keep_scale, int bq, int bk,
                            int n_pairs, const uint32_t* pairs, int device, void* stream) {
  return bwd_ring(false, q, k, v, mask, seeds, dout, lse, delta, nullptr, nullptr, dk_acc,
                  dv_acc, dk, dv, B, H, sp, Sq, Sk, D, scale_log2, dk_scale, rate, keep_scale,
                  bq, bk, n_pairs, pairs, device, stream);
}

// out[0..3]: K2's registers a thread, static and dynamic shared memory
// (bytes) a block and resident blocks an SM at head dim D and lengths
// Tq, Tk (D % 4 == 0); out[4..7]: the same for K3.  Returns a cudaError_t.
int flash_attn_bwd_occupancy(int D, int Tq, int Tk, int device, int* out) {
  if (bad_shape(1, 1, Tq, Tk, D, 1, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D <= 32) return static_cast<int>(occupancy_dp<32>(Tq, Tk, out));
  if (D <= 64) return static_cast<int>(occupancy_dp<64>(Tq, Tk, out));
  return static_cast<int>(occupancy_dp<128>(Tq, Tk, out));
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
