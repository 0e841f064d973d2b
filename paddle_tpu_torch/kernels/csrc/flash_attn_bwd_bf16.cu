// Flash-attention backward for Hopper (sm_90a), bfloat16: K2 (dq) and K3
// (dk, dv) in their bfloat16 mode.
//
// Replace the Pallas kernels paddle_tpu/kernels/attention.py:459
// _flash_bwd_dq_kernel and :507 _flash_bwd_dkv_kernel (launched by
// _pallas_bwd through pl.pallas_call) on bfloat16 q, k, v and dO, the
// dtype their products run in on the TPU.  They compute what
// flash_attn_bwd.cu computes in float32 (the same masks, logical-tile
// visits, dropout bits; lse and delta = rowsum(dO * O) float32 inputs, so
// ring attention can pass its global ones), with the reference's
// bfloat16 arithmetic, every product bfloat16 x bfloat16 with a float32
// sum:
//
//   s  = bf16(q * scale_log2) . K^T,  p = exp2(s - lse)
//   dp = (dO . V^T) * drop,           ds = bf16(p * (dp - delta))
//   flash_attn_bwd_dq_bf16:  dq = sm_scale * sum_k ds . K
//   flash_attn_bwd_dkv_bf16: dv = sum_q bf16(p * drop)^T . dO,
//                            dk = sm_scale * sum_q ds^T . q
//
// dk takes the UNscaled q, as the reference does (attention.py:544).
// dq, dk, dv are written in bfloat16.  p is computed from the saved LSE,
// so the kernels round exactly where the reference does; only the order
// of the float32 sums differs.  Where the caller passes no delta, K2
// computes it for its own rows (rowsum(dO * O) in float32, reading O once)
// and writes it to a [B*H, Tq] float32 buffer, which K3 then reads: the
// backward's delta costs no pass of its own.
//
// Design (sm90.cuh).  A block is three warpgroups: two consumers, each
// owning 64 rows (K2: query rows, with the pre-scaled q~ = bf16(q *
// scale_log2) and dO resident in shared memory; K3: keys, with K and V
// resident), and a producer.  The producer streams the other side in
// 64-row tiles through a ring of three to six shared-memory stages, as
// many as fit (K2: K and V; K3: q and dO), with TMA loads and mbarriers
// (load: the TMA bytes; full: the producer's own writes; empty: the
// consumers are done), and with each tile the per-row values the
// consumers need (K2: the keys' mask bits and their parts of the dropout
// hash; K3: the rows' lse, delta and parts of the hash), read from device
// memory a tile ahead.  In K3 the producer also writes the tile's
// pre-scaled copy q~ (the operand of S^T; dk takes the unscaled q), after
// the next tile's loads are issued.  The
// producer decides which tiles a consumer visits, and skips a tile both
// consumers skip: one whose pairs are unvisited (the reference's logical
// tiles), or, where every row in play has softmax mass on an unmasked key
// (kHasMass), whose pairs are all masked or causally excluded (their p is
// exactly 0).  It marks a tile full for a consumer where every pair is
// visited, unmasked and causally allowed (p needs no tests), and gives the
// consumers the tile's index, or -1 at the end.  Every product is a
// warpgroup wgmma m64nNk16 (bfloat16 in, float32 sums): K2: S = q~ . K^T
// and dP = dO . V^T (A and B from shared memory, K-major), then dQ +=
// bf16(dS) . K with A from registers (the C fragments of S, packed) and B
// the K tile read MN-major; K3: S^T = K . q~^T and dP^T = V . dO^T, then
// dV += bf16(P^T drop) . dO and dK += bf16(dS^T) . q, A from registers;
// the two consumers' groups interleave on the tensor cores.  Flags read
// from shared memory are broadcast from lane 0 (uniform()), so the
// compiler keeps each wgmma group whole.  setmaxnreg moves registers from
// the producer (24) to the consumers (240), but ptxas keeps the
// consumers' code near 168 all the same: K3 at D = 128, whose dK and dV
// alone take 128 registers a thread, spills and serializes its groups.
// No atomics: a rerun is bit for bit.  Causal K2 launches its longest
// q-blocks first; K3's longest blocks (the first keys) are first anyway.
//
// TMA reads a 3-D view [B*H, T, D] of each tensor, so the ragged end of
// a sequence and the columns past D (D < 64, or 64 < D < 128) are filled
// with zeros.  TMA needs a row stride that is a multiple of 16 bytes and
// 16-byte aligned bases; for a tensor it cannot describe (D % 8 != 0, or
// a base off 16 bytes), the same kernel's producer stages the rows with
// plain loads into the same swizzled layout (16-byte cp.async needs the
// same alignment).
//
// Bound.  For B=32, H=8, T=256, D=64: K2 does three products (6 * D
// operations a pair, 3.2 GFLOP, 3.3 us at 989 TFLOP/s dense bf16) on
// 42 MB in bfloat16 (q, k, v, dO read, dq written; mask, lse, delta),
// 12.7 us at 3.35 TB/s; K3 four products (4.3 GFLOP, 4.3 us) on 51 MB,
// 15.2 us.  Both are bound by the bytes.  At B=4, T=8192, causal they
// are bound by the operations: 0.417 ms (K2) and 0.556 ms (K3).
//
// Ring attention (flash_attn_common.cuh): flash_attn_bwd_dq_bf16_ring()
// and flash_attn_bwd_dkv_bf16_ring() run one hop's pairs as one launch of
// the same kernels instantiated for the ring.  Their tensor maps view each
// whole tensor as [B*H*sp, S, D], a plane a shard; their epilogues round
// each pair's gradients to bfloat16 and add them to float32 accumulators.
//
// Entry points: flash_attn_bwd_dq_bf16(), flash_attn_bwd_dkv_bf16() and
// their _ring twins, plain C functions called through ctypes on PyTorch's
// current stream.  Each launches and returns a cudaError_t; none
// synchronises or allocates.  flash_attn_bwd_bf16_occupancy() reports each kernel's
// registers, shared memory and resident blocks an SM.

#include <cuda_bf16.h>

#include "flash_attn_common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kNegInf;
using Args = flash::ArgsT<bf16>;
using sm90::aligned16;
using sm90::aligned_smem;
using sm90::encode;
using sm90::ex2;
using sm90::kPanelRow;
using sm90::scale_bytes;
using sm90::tile_bytes;
using sm90::tma_tile;
using sm90::uniform;

constexpr int kRowsWG = 64;                // rows a consumer warpgroup owns
constexpr int kRows = 2 * kRowsWG;         // rows a block owns
constexpr int kTile = 64;                  // streamed rows a stage
constexpr int kProducer = 128;             // the producer warpgroup
constexpr int kThreads = 256 + kProducer;  // consumers 0..255, producer 256..383
// setmaxnreg moves registers within the block's launch allocation (168 a
// thread): the producer keeps 24, the consumers take 240
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr unsigned kAll = 0xffffffffu;
// a row whose lse is above this has softmax mass on an unmasked key, so a
// masked or causally excluded key gives it p = exp2(-1e30 - lse) = 0
constexpr float kHasMass = -1e29f;

struct Params {
  Args a;
  const bf16* o;      // forward output (K2, where delta is computed)
  float* delta_out;   // K2: [B*H, Tq] delta it computed, or null
  int tma;            // tiles by TMA (else plain loads by the producer)
  int vec;            // 16-byte loads of O and dO for K2's delta
  flash::Ring ring;   // a ring launch's pairs (flash_attn_common.cuh)
};

// K2 per stage: which tile, the consumers that visit it, the keys' mask
// bits and dropout parts
struct InfoDq {
  int tile;
  int live[2];
  int full[2];      // every pair visited, unmasked and causally allowed
  uint32_t bits[2];
  int pad;
  uint32_t kx[kTile];
  uint32_t ks[kTile];
};

// K3 per stage: which tile, the consumers that visit it, the rows' lse,
// delta and dropout parts
struct InfoDkv {
  int tile;
  int live[2];
  int full[2];      // every pair visited, unmasked and causally allowed
  int pad[3];
  float lse[kTile];
  float delta[kTile];
  uint32_t rx[kTile];
  uint32_t rs[kTile];
};

template <int DP>
__device__ __forceinline__ void rs_dp(float (&d)[DP / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void rs_dp<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  sm90::wgmma_rs_n64<1>(d, a, b, 1);
}
template <>
__device__ __forceinline__ void rs_dp<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  sm90::wgmma_rs_n128<1>(d, a, b, 1);
}

// acc (64 x DP) += A (64 x 64, four k16 slices in registers) . B, B a
// 64-row stage tile read MN-major (rows = k)
template <int DP>
__device__ __forceinline__ void product_rs(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                           uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    rs_dp<DP>(acc, a[kk],
              sm90::desc_b128(b_tile + kk * 16 * kPanelRow, kTile * kPanelRow, 1024));
  }
}

// s (64 x 64) = A . B^T over DP columns: A the warpgroup's 64 rows of an
// RA-row panel tile, B a 64-row stage tile, both K-major
template <int DP, int RA>
__device__ __forceinline__ void product_ss(float (&s)[32], uint32_t a_rows, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t ka = (kk >> 2) * RA * kPanelRow + (kk & 3) * 32;
    const uint32_t kb = (kk >> 2) * kTile * kPanelRow + (kk & 3) * 32;
    sm90::wgmma_ss_n64<0>(s, sm90::desc_b128(a_rows + ka, 16, 1024),
                          sm90::desc_b128(b_tile + kb, 16, 1024), 1);
  }
}

// the warpgroup's C fragments (64 x DP), times `scale`, rounded to
// bfloat16 into rows first_row + (0..63) of an [n_rows, D] matrix
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DP / 2], int first_row,
                                           int n_rows, int D, float scale, int wwarp, int g,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = first_row + wwarp * 16 + g + 8 * h;
    if (row >= n_rows) continue;
    bf16* op = dst + static_cast<size_t>(row) * D;
    // two columns a store where the row keeps them 4-byte aligned
    const bool pair = (D % 2 == 0) && (reinterpret_cast<uintptr_t>(dst) & 3u) == 0;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = j * 8 + 2 * t;
      const float x = acc[4 * j + 2 * h] * scale, y = acc[4 * j + 2 * h + 1] * scale;
      if (pair && d + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(op + d) = __floats2bfloat162_rn(x, y);
      } else {
        if (d < D) op[d] = __float2bfloat16_rn(x);
        if (d + 1 < D) op[d + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// ring: the warpgroup's C fragments times `scale`, rounded to bfloat16 (a
// pair's gradient rows, as the plain kernel writes them), added to rows
// first_row + (0..63) of a float32 accumulator [n_rows, D] (written on the
// first hop); on the last the sums go to `dst` in bfloat16 instead
template <int DP>
__device__ __forceinline__ void sum_rows(float* acc, bf16* dst, const float (&g)[DP / 2],
                                         int first_row, int n_rows, int D, float scale,
                                         bool first, bool last, int wwarp, int gi, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = first_row + wwarp * 16 + gi + 8 * h;
    if (row >= n_rows) continue;
    float* ap = acc + static_cast<size_t>(row) * D;
    bf16* op = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = j * 8 + 2 * t + e;
        if (d >= D) continue;
        const float x = __bfloat162float(__float2bfloat16_rn(g[4 * j + 2 * h + e] * scale));
        const float y = first ? x : ap[d] + x;
        if (last) {
          op[d] = __float2bfloat16_rn(y);
        } else {
          ap[d] = y;
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// this thread's two query rows in K2 (fragment rows g and g + 8 of its
// warp): index, end of the visited keys, lse, delta, dropout parts
struct Rows {
  int row[2], kend[2];
  float lse[2], delta[2];
  uint32_t x[2], salt[2];
};

// dS = p * (dP * drop - delta) of K2's tile, rounded to bfloat16 as dQ's
// operand; an unvisited key has p = 0, a masked or causally excluded one
// scores the finite -1e30.  A FULL tile (InfoDq) needs no tests.
template <bool FULL>
__device__ __forceinline__ void dq_ds(uint32_t (&ds)[4][4], const float (&sc)[32],
                                      const float (&dp)[32], const InfoDq* inf, const Rows& r,
                                      const Args& a, int causal, uint32_t threshold, int t) {
  const int k0 = inf->tile * kTile;
  const uint32_t bits0 = inf->bits[0], bits1 = inf->bits[1];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t bw = j < 4 ? bits0 : bits1;
    uint2 kx = make_uint2(0u, 0u), ks = make_uint2(0u, 0u);
    if (a.rate > 0.0f) {
      kx = *reinterpret_cast<const uint2*>(&inf->kx[8 * j + 2 * t]);
      ks = *reinterpret_cast<const uint2*>(&inf->ks[8 * j + 2 * t]);
    }
    float d4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = 8 * j + 2 * t + (e & 1);
      float p;
      if (FULL) {
        p = ex2(sc[4 * j + e] - r.lse[h]);
      } else {
        const int key = k0 + c;
        const bool keep = ((bw >> (c & 31)) & 1u) && (!causal || key <= r.row[h]);
        p = key < r.kend[h] && key < a.Tk ? ex2((keep ? sc[4 * j + e] : kNegInf) - r.lse[h])
                                          : 0.0f;
      }
      float dpv = dp[4 * j + e];
      if (a.rate > 0.0f) {
        dpv *= flash::drop_of(r.x[h], r.salt[h], (e & 1) ? kx.y : kx.x, (e & 1) ? ks.y : ks.x,
                              threshold, a.keep_scale);
      }
      d4[e] = p * (dpv - r.delta[h]);
    }
    ds[j >> 1][(j & 1) * 2] = sm90::pack_bf16x2(d4[0], d4[1]);
    ds[j >> 1][(j & 1) * 2 + 1] = sm90::pack_bf16x2(d4[2], d4[3]);
  }
}

// this thread's two keys in K3 (fragment rows g and g + 8 of its warp):
// index, first visited row, validity, dropout parts
struct Keys {
  int key[2], rbeg[2];
  bool valid[2];
  uint32_t x[2], salt[2];
};

// P^T * drop and dS^T = P^T * (dP^T * drop - delta) of K3's tile, each
// rounded to bfloat16 as dV's and dK's operand (packed a chunk at a time,
// so the float32 tiles die as they go); an unvisited row has p = 0, a
// masked or causally excluded key scores the finite -1e30.  A FULL tile
// (InfoDkv) needs no tests.
template <bool FULL>
__device__ __forceinline__ void dkv_pds(uint32_t (&pa)[4][4], uint32_t (&dsa)[4][4],
                                        const float (&sc)[32], const float (&dp)[32],
                                        const InfoDkv* inf, const Keys& k, const Args& a,
                                        int causal, uint32_t threshold, int t) {
  const int i0 = inf->tile * kTile;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c0 = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(&inf->lse[c0]);
    const float2 d2 = *reinterpret_cast<const float2*>(&inf->delta[c0]);
    uint2 rx = make_uint2(0u, 0u), rs = make_uint2(0u, 0u);
    if (a.rate > 0.0f) {
      rx = *reinterpret_cast<const uint2*>(&inf->rx[c0]);
      rs = *reinterpret_cast<const uint2*>(&inf->rs[c0]);
    }
    float pd[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, row = i0 + c0 + (e & 1);
      const float lse = (e & 1) ? l2.y : l2.x;
      float p;
      if (FULL) {
        p = ex2(sc[4 * j + e] - lse);
      } else {
        const bool keep = k.valid[h] && (!causal || k.key[h] <= row);
        p = row >= k.rbeg[h] && row < a.Tq ? ex2((keep ? sc[4 * j + e] : kNegInf) - lse) : 0.0f;
      }
      float drop = 1.0f;
      if (a.rate > 0.0f) {
        drop = flash::drop_of((e & 1) ? rx.y : rx.x, (e & 1) ? rs.y : rs.x, k.x[h], k.salt[h],
                              threshold, a.keep_scale);
      }
      pd[e] = p * drop;
      ds[e] = p * (dp[4 * j + e] * drop - ((e & 1) ? d2.y : d2.x));
    }
    pa[j >> 1][(j & 1) * 2] = sm90::pack_bf16x2(pd[0], pd[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = sm90::pack_bf16x2(pd[2], pd[3]);
    dsa[j >> 1][(j & 1) * 2] = sm90::pack_bf16x2(ds[0], ds[1]);
    dsa[j >> 1][(j & 1) * 2 + 1] = sm90::pack_bf16x2(ds[2], ds[3]);
  }
}


// ---- shared memory -------------------------------------------------------

template <int DP>
struct DqLayout {
  static constexpr int kStages = DP == 64 ? 6 : 4;  // as many as fit
  static constexpr int kQt = 0;                                     // q~ [128 rows]
  static constexpr int kDo = kQt + tile_bytes<DP>(kRows);           // dO [128 rows]
  static constexpr int kStage = kDo + tile_bytes<DP>(kRows);        // K, V [64 rows]
  static constexpr int kStageBytes = 2 * tile_bytes<DP>(kTile);
  static constexpr int kInfo = kStage + kStages * kStageBytes;
  static constexpr int kBars = kInfo + kStages * static_cast<int>(sizeof(InfoDq));
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;  // + alignment
};

template <int DP>
struct DkvLayout {
  static constexpr int kStages = DP == 64 ? 5 : 3;
  static constexpr int kK = 0;                                      // K [128 rows]
  static constexpr int kV = kK + tile_bytes<DP>(kRows);             // V [128 rows]
  static constexpr int kStage = kV + tile_bytes<DP>(kRows);         // q, q~, dO [64 rows]
  static constexpr int kStageBytes = 3 * tile_bytes<DP>(kTile);
  static constexpr int kInfo = kStage + kStages * kStageBytes;
  static constexpr int kBars = kInfo + kStages * static_cast<int>(sizeof(InfoDkv));
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// ---- K2: dq ----------------------------------------------------------------

template <int DP, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ Params P,
                             const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v) {
  using L = DqLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  constexpr int kStages = L::kStages;
  const sm90::Bars bar = sm90::bars_at(sm + L::kBars, kStages);
  InfoDq* info = reinterpret_cast<InfoDq*>(sm + L::kInfo);
  sm90::init_bars(bar, kStages, kProducer, 256);

  const Args& a = P.a;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  // a ring launch's pair (the plain kernel keeps its own expressions)
  const flash::PairAt pc = flash::pair_at<RING>(a, P.ring, bh, blockIdx.z);
  const int causal = RING ? pc.causal : a.causal;
  const int qplane = RING ? pc.qplane : bh, kplane = RING ? pc.kplane : bh;
  // causal: the last q-blocks visit the most keys, so they are launched
  // first and the short ones fill the tail
  const int row0 = static_cast<int>(causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int Tq = a.Tq, Tk = a.Tk, D = a.D;
  const size_t qrow = RING ? pc.qrow : static_cast<size_t>(bh) * Tq;
  const size_t qoff = RING ? pc.qrow * D : static_cast<size_t>(bh) * Tq * D;

  // the warpgroup (2: the producer), broadcast from lane 0 so the compiler
  // sees it uniform: it keeps the wgmma groups whole and each branch's
  // register count
  const int role = __shfl_sync(kAll, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // ===== producer =====
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int tid = threadIdx.x - 256, lane = tid & 31;
    const float* mrow =
        a.mask ? a.mask + (RING ? pc.mrow : static_cast<size_t>(b) * Tk) : nullptr;
    // the resident rows: q (scaled by the consumers) and dO
    if (P.tma) {
      if (tid == 0) {
        sm90::mbar_expect_tx(bar.res, 2 * tile_bytes<DP>(kRows));
        tma_tile<DP, kRows>(sm + L::kQt, &tm_q, bar.res, row0, qplane);
        tma_tile<DP, kRows>(sm + L::kDo, &tm_do, bar.res, row0, qplane);
      } else {
        sm90::mbar_arrive(bar.res);
      }
    } else {
      sm90::stage_plain<DP, kRows, kProducer>(sm + L::kQt, a.q + qoff, row0, Tq, D, tid);
      sm90::stage_plain<DP, kRows, kProducer>(sm + L::kDo, a.dout + qoff, row0, Tq, D, tid);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.res);
    }
    // each consumer's last row, the end of its visited keys, and whether
    // all its rows have mass (every producer warp computes the same)
    // the mask values of a tile's keys lane and lane + 32, loaded a tile
    // ahead of their use (the first tile's with the lse below)
    auto mask_of = [&](int key) {
      return key < Tk ? (mrow == nullptr ? 1.0f : mrow[key]) : 0.0f;
    };
    float next0 = mask_of(lane), next1 = mask_of(lane + 32);
    int wlast[2], wkend[2], wkend0[2];
    bool wmass[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int rw0 = row0 + w * kRowsWG;
      wlast[w] = min(rw0 + kRowsWG - 1, Tq - 1);
      wkend[w] = rw0 < Tq ? flash::key_end(wlast[w], Tk, causal, a.bq, a.bk) : 0;
      // the first row's, the least: a full tile ends before it
      wkend0[w] = rw0 + kRowsWG <= Tq ? flash::key_end(rw0, Tk, causal, a.bq, a.bk) : 0;
      bool m = true;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rw0 + lane + 32 * i;
        m = m && (row >= Tq || a.lse[qrow + row] > kHasMass);
      }
      wmass[w] = __all_sync(kAll, m);
    }
    const int last_row = min(row0 + kRows, Tq) - 1;
    const int kend_blk = min(flash::key_end(last_row, Tk, causal, a.bq, a.bk), Tk);
    const int ntiles = (kend_blk + kTile - 1) / kTile;
    int s = 0;
    uint32_t ph = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * kTile;
      const float m0 = next0, m1 = next1;
      next0 = mask_of(k0 + kTile + lane);
      next1 = mask_of(k0 + kTile + lane + 32);
      const uint32_t bits[2] = {__ballot_sync(kAll, m0 > 0.0f), __ballot_sync(kAll, m1 > 0.0f)};
      bool live[2], full[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int rw0 = row0 + w * kRowsWG;
        live[w] = k0 < wkend[w] &&
                  (!wmass[w] || ((bits[0] | bits[1]) != 0u && !(causal && k0 > wlast[w])));
        full[w] = (bits[0] & bits[1]) == kAll && k0 + kTile <= wkend0[w] &&
                  (!causal || k0 + kTile - 1 <= rw0);
      }
      if (!live[0] && !live[1]) continue;
      sm90::mbar_wait(bar.empty + s, ph ^ 1);
      unsigned char* st = sm + L::kStage + s * L::kStageBytes;
      if (P.tma) {
        if (tid == 0) {
          sm90::mbar_expect_tx(bar.load + s, L::kStageBytes);
          tma_tile<DP, kTile>(st, &tm_k, bar.load + s, k0, kplane);
          tma_tile<DP, kTile>(st + tile_bytes<DP>(kTile), &tm_v, bar.load + s, k0, kplane);
        }
      } else {
        const size_t koff = RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D;
        sm90::stage_plain<DP, kTile, kProducer>(st, a.k + koff, k0, Tk, D, tid);
        sm90::stage_plain<DP, kTile, kProducer>(st + tile_bytes<DP>(kTile), a.v + koff, k0, Tk,
                                                D, tid);
        if (tid == 0) sm90::mbar_arrive(bar.load + s);
      }
      InfoDq* inf = info + s;
      if (tid == 0) {
        inf->tile = t;
        inf->live[0] = live[0];
        inf->live[1] = live[1];
        inf->full[0] = full[0];
        inf->full[1] = full[1];
        inf->bits[0] = bits[0];
        inf->bits[1] = bits[1];
      }
      for (int j = tid; j < kTile; j += kProducer) {
        inf->kx[j] = flash::drop_key_x(k0 + j, a.bk);
        inf->ks[j] = flash::drop_key_salt(k0 + j, a.bk);
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.full + s);
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    // the end
    sm90::mbar_wait(bar.empty + s, ph ^ 1);
    if (tid == 0) {
      info[s].tile = -1;
      sm90::mbar_arrive(bar.load + s);
    }
    sm90::mbar_arrive(bar.full + s);
  } else {
    // ===== consumers =====
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int w = role, wt = threadIdx.x & 127;
    const int wwarp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    const int rw0 = row0 + w * kRowsWG;
    const uint32_t seed = flash::seed_of<RING>(a, P.ring, blockIdx.z);
    const uint32_t threshold = flash::drop_threshold(a.rate);
    Rows r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw0 + wwarp * 16 + g + 8 * h;
      const bool ok = row < Tq;
      const size_t ridx = qrow + (ok ? row : 0);
      r.row[h] = row;
      r.lse[h] = ok ? a.lse[ridx] : 0.0f;
      r.kend[h] = ok ? flash::key_end(row, Tk, causal, a.bq, a.bk) : 0;
      r.x[h] = flash::drop_row_x(row, a.bq);
      r.salt[h] = flash::drop_row_salt(row, a.bq, seed, bh);
      if (a.delta != nullptr) {
        r.delta[h] = ok ? a.delta[ridx] : 0.0f;
      } else {
        // rowsum(dO * O) in float32, a quarter of the row a thread
        float acc = 0.0f;
        if (ok) {
          const bf16* o = P.o + qoff + static_cast<size_t>(row) * D;
          const bf16* d = a.dout + qoff + static_cast<size_t>(row) * D;
          if (P.vec) {
            for (int c = t * 8; c < D; c += 32) {
              const uint4 x = *reinterpret_cast<const uint4*>(o + c);
              const uint4 y = *reinterpret_cast<const uint4*>(d + c);
              const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
              const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc = fmaf(__bfloat162float(xs[j].x), __bfloat162float(ys[j].x), acc);
                acc = fmaf(__bfloat162float(xs[j].y), __bfloat162float(ys[j].y), acc);
              }
            }
          } else {
            for (int c = t; c < D; c += 4) {
              acc = fmaf(__bfloat162float(o[c]), __bfloat162float(d[c]), acc);
            }
          }
        }
        acc += __shfl_xor_sync(kAll, acc, 1);
        acc += __shfl_xor_sync(kAll, acc, 2);
        r.delta[h] = acc;
        if (ok && t == 0) P.delta_out[ridx] = acc;
      }
    }
    // q~ = bf16(q * scale_log2) in place over this warpgroup's rows
    sm90::mbar_wait(bar.res, 0);
#pragma unroll
    for (int p = 0; p < DP / 64; ++p) {
      unsigned char* slab = sm + L::kQt + p * kRows * kPanelRow + w * kRowsWG * kPanelRow;
      scale_bytes(slab, slab, kRowsWG * kPanelRow, a.scale_log2, wt, 128);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + w, 128);

    const uint32_t qt_rows = sm90::smem_u32(sm + L::kQt) + w * kRowsWG * kPanelRow;
    const uint32_t do_rows = sm90::smem_u32(sm + L::kDo) + w * kRowsWG * kPanelRow;
    const uint32_t stages = sm90::smem_u32(sm + L::kStage);
    float dq[DP / 2];
    zero(dq);
    // per tile: S = q~ . K^T and dP = dO . V^T in one wgmma group, dS in
    // registers, then dQ += bf16(dS) . K in a second; the two warpgroups'
    // groups interleave on the tensor cores
    int s = 0;
    uint32_t ph = 0;
    for (;;) {
      sm90::mbar_wait(bar.load + s, ph);
      sm90::mbar_wait(bar.full + s, ph);
      const InfoDq* inf = info + s;
      if (uniform(inf->tile) < 0) break;
      if (uniform(inf->live[w])) {
        const uint32_t kt = stages + s * L::kStageBytes;
        float sc[32], dp[32];
        zero(sc);
        zero(dp);
        sm90::wgmma_fence();
        product_ss<DP, kRows>(sc, qt_rows, kt);
        product_ss<DP, kRows>(dp, do_rows, kt + tile_bytes<DP>(kTile));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);
        uint32_t ds[4][4];
        if (uniform(inf->full[w])) {
          dq_ds<true>(ds, sc, dp, inf, r, a, causal, threshold, t);
        } else {
          dq_ds<false>(ds, sc, dp, inf, r, a, causal, threshold, t);
        }
        sm90::wgmma_fence();
        product_rs<DP>(dq, ds, kt);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
      }
      sm90::mbar_arrive(bar.empty + s);
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    if constexpr (RING) {
      sum_rows<DP>(P.ring.acc + qoff, a.out + qoff, dq, rw0, Tq, D, a.grad_scale,
                   (pc.flags & flash::kRingFirst) != 0u, (pc.flags & flash::kRingLastQ) != 0u,
                   wwarp, g, t);
    } else {
      store_rows<DP>(a.out + qoff, dq, rw0, Tq, D, a.grad_scale, wwarp, g, t);
    }
  }
}

// ---- K3: dk, dv ------------------------------------------------------------

template <int DP, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ Params P,
                              const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v) {
  using L = DkvLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  constexpr int kStages = L::kStages;
  const sm90::Bars bar = sm90::bars_at(sm + L::kBars, kStages);
  InfoDkv* info = reinterpret_cast<InfoDkv*>(sm + L::kInfo);
  sm90::init_bars(bar, kStages, kProducer, 256);

  const Args& a = P.a;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  // a ring launch's pair (the plain kernel keeps its own expressions)
  const flash::PairAt pc = flash::pair_at<RING>(a, P.ring, bh, blockIdx.z);
  const int causal = RING ? pc.causal : a.causal;
  const int qplane = RING ? pc.qplane : bh, kplane = RING ? pc.kplane : bh;
  const size_t mrow = RING ? pc.mrow : static_cast<size_t>(b) * a.Tk;
  const int key0 = blockIdx.y * kRows;
  const int Tq = a.Tq, Tk = a.Tk, D = a.D;
  const size_t koff = RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D;
  constexpr int kQ = 0, kQt = tile_bytes<DP>(kTile), kDo = 2 * tile_bytes<DP>(kTile);

  // the warpgroup (2: the producer), broadcast from lane 0 so the compiler
  // sees it uniform: it keeps the wgmma groups whole and each branch's
  // register count
  const int role = __shfl_sync(kAll, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // ===== producer =====
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int tid = threadIdx.x - 256, lane = tid & 31;
    const uint32_t seed = flash::seed_of<RING>(a, P.ring, blockIdx.z);
    const size_t qoff = RING ? pc.qrow * D : static_cast<size_t>(bh) * Tq * D;
    const float* lbase = a.lse + (RING ? pc.qrow : static_cast<size_t>(bh) * Tq);
    const float* dbase = a.delta + (RING ? pc.qrow : static_cast<size_t>(bh) * Tq);
    // the resident keys: K and V
    if (P.tma) {
      if (tid == 0) {
        sm90::mbar_expect_tx(bar.res, 2 * tile_bytes<DP>(kRows));
        tma_tile<DP, kRows>(sm + L::kK, &tm_k, bar.res, key0, kplane);
        tma_tile<DP, kRows>(sm + L::kV, &tm_v, bar.res, key0, kplane);
      } else {
        sm90::mbar_arrive(bar.res);
      }
    } else {
      sm90::stage_plain<DP, kRows, kProducer>(sm + L::kK, a.k + koff, key0, Tk, D, tid);
      sm90::stage_plain<DP, kRows, kProducer>(sm + L::kV, a.v + koff, key0, Tk, D, tid);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.res);
    }
    // each consumer's first key, first visited row, and whether any of
    // its keys is unmasked (every producer warp computes the same)
    int wfirst[2], wrbeg[2], wrbeg1[2];
    bool wany[2], wall[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      wfirst[w] = key0 + w * kRowsWG;
      wrbeg[w] = wfirst[w] < Tk ? flash::row_begin(wfirst[w], Tq, causal, a.bq, a.bk) : Tq;
      // the last key's, the greatest: a full tile starts after it
      const int last = wfirst[w] + kRowsWG - 1;
      wrbeg1[w] = last < Tk ? flash::row_begin(last, Tq, causal, a.bq, a.bk) : Tq;
      bool any = false, all = true;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = wfirst[w] + lane + 32 * i;
        const bool ok = key < Tk && (a.mask == nullptr || a.mask[mrow + key] > 0.0f);
        any = any || ok;
        all = all && ok;
      }
      wany[w] = __any_sync(kAll, any);
      wall[w] = __all_sync(kAll, all);
    }
    // the block starts at the reference's clamped first q-block of its
    // first key (_first_qb)
    const int t0 = flash::row_begin(key0, Tq, causal, a.bq, a.bk) / kTile;
    const int ntiles = (Tq + kTile - 1) / kTile;
    // the lse and delta of a tile's rows lane and lane + 32, loaded a tile
    // ahead of their use (+1e30: past Tq, no row)
    auto lse_of = [&](int row) { return row < Tq ? lbase[row] : 1e30f; };
    auto delta_of = [&](int row) { return row < Tq ? dbase[row] : 0.0f; };
    float nl0 = lse_of(t0 * kTile + lane), nl1 = lse_of(t0 * kTile + lane + 32);
    float nd0 = delta_of(t0 * kTile + lane), nd1 = delta_of(t0 * kTile + lane + 32);
    // a stage is handed over once its q~ is written: after the next
    // stage's loads are issued, so one tile's load flies under another's
    // scaling
    auto hand_over = [&](int st, uint32_t parity) {
      if (P.tma) {
        sm90::mbar_wait(bar.load + st, parity);
        unsigned char* p = sm + L::kStage + st * L::kStageBytes;
        scale_bytes(p + kQt, p + kQ, tile_bytes<DP>(kTile), a.scale_log2, tid, kProducer);
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.full + st);
    };
    int s = 0, pending = -1;
    uint32_t ph = 0, pending_ph = 0;
    for (int t = t0; t < ntiles; ++t) {
      const int i0 = t * kTile;
      const float l0 = nl0, l1 = nl1, d0 = nd0, d1 = nd1;
      nl0 = lse_of(i0 + kTile + lane);
      nl1 = lse_of(i0 + kTile + lane + 32);
      nd0 = delta_of(i0 + kTile + lane);
      nd1 = delta_of(i0 + kTile + lane + 32);
      const bool mass = __all_sync(kAll, l0 > kHasMass && l1 > kHasMass);
      bool live[2], full[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        live[w] = wfirst[w] < Tk && i0 + kTile > wrbeg[w] &&
                  (!mass || (wany[w] && !(causal && i0 + kTile - 1 < wfirst[w])));
        full[w] = wall[w] && i0 + kTile <= Tq && i0 >= wrbeg1[w] &&
                  (!causal || i0 >= wfirst[w] + kRowsWG - 1);
      }
      if (!live[0] && !live[1]) continue;
      sm90::mbar_wait(bar.empty + s, ph ^ 1);
      unsigned char* st = sm + L::kStage + s * L::kStageBytes;
      if (P.tma) {
        if (tid == 0) {
          sm90::mbar_expect_tx(bar.load + s, 2 * tile_bytes<DP>(kTile));
          tma_tile<DP, kTile>(st + kQ, &tm_q, bar.load + s, i0, qplane);
          tma_tile<DP, kTile>(st + kDo, &tm_do, bar.load + s, i0, qplane);
        }
      } else {
        sm90::stage_plain<DP, kTile, kProducer>(st + kQ, a.q + qoff, i0, Tq, D, tid, st + kQt, a.scale_log2);
        sm90::stage_plain<DP, kTile, kProducer>(st + kDo, a.dout + qoff, i0, Tq, D, tid);
        if (tid == 0) sm90::mbar_arrive(bar.load + s);
      }
      InfoDkv* inf = info + s;
      if (tid == 0) {
        inf->tile = t;
        inf->live[0] = live[0];
        inf->live[1] = live[1];
        inf->full[0] = full[0];
        inf->full[1] = full[1];
      }
      if (tid < 32) {  // a row past Tq: lse 0, delta 0 (p is 0 there)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = lane + 32 * i, row = i0 + j;
          inf->lse[j] = row < Tq ? (i ? l1 : l0) : 0.0f;
          inf->delta[j] = i ? d1 : d0;
          inf->rx[j] = flash::drop_row_x(row, a.bq);
          inf->rs[j] = flash::drop_row_salt(row, a.bq, seed, bh);
        }
      }
      if (pending >= 0) hand_over(pending, pending_ph);
      pending = s;
      pending_ph = ph;
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    if (pending >= 0) hand_over(pending, pending_ph);
    // the end
    sm90::mbar_wait(bar.empty + s, ph ^ 1);
    if (tid == 0) {
      info[s].tile = -1;
      sm90::mbar_arrive(bar.load + s);
    }
    sm90::mbar_arrive(bar.full + s);
  } else {
    // ===== consumers =====
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int w = role, wt = threadIdx.x & 127;
    const int wwarp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    const int kw0 = key0 + w * kRowsWG;
    const uint32_t threshold = flash::drop_threshold(a.rate);
    Keys k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kw0 + wwarp * 16 + g + 8 * h;
      const bool ok = key < Tk;
      k.key[h] = key;
      k.valid[h] = ok && (a.mask == nullptr || a.mask[mrow + key] > 0.0f);
      k.rbeg[h] = ok ? flash::row_begin(key, Tq, causal, a.bq, a.bk) : Tq;
      k.x[h] = flash::drop_key_x(key, a.bk);
      k.salt[h] = flash::drop_key_salt(key, a.bk);
    }
    const uint32_t k_rows = sm90::smem_u32(sm + L::kK) + w * kRowsWG * kPanelRow;
    const uint32_t v_rows = sm90::smem_u32(sm + L::kV) + w * kRowsWG * kPanelRow;
    const uint32_t stages = sm90::smem_u32(sm + L::kStage);
    float dk[DP / 2], dv[DP / 2];
    zero(dk);
    zero(dv);
    // per tile: S^T = K . q~^T and dP^T = V . dO^T in one wgmma group,
    // P^T drop and dS^T in registers, then dV += bf16(P^T drop) . dO and
    // dK += bf16(dS^T) . q (the unscaled q) in a second; the two
    // warpgroups' groups interleave on the tensor cores
    sm90::mbar_wait(bar.res, 0);
    int s = 0;
    uint32_t ph = 0;
    for (;;) {
      sm90::mbar_wait(bar.load + s, ph);
      sm90::mbar_wait(bar.full + s, ph);
      const InfoDkv* inf = info + s;
      if (uniform(inf->tile) < 0) break;
      if (uniform(inf->live[w])) {
        const uint32_t st = stages + s * L::kStageBytes;
        float sc[32], dp[32];
        zero(sc);
        zero(dp);
        sm90::wgmma_fence();
        product_ss<DP, kRows>(sc, k_rows, st + kQt);
        product_ss<DP, kRows>(dp, v_rows, st + kDo);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);
        uint32_t pa[4][4], dsa[4][4];
        if (uniform(inf->full[w])) {
          dkv_pds<true>(pa, dsa, sc, dp, inf, k, a, causal, threshold, t);
        } else {
          dkv_pds<false>(pa, dsa, sc, dp, inf, k, a, causal, threshold, t);
        }
        sm90::wgmma_fence();
        product_rs<DP>(dv, pa, st + kDo);
        product_rs<DP>(dk, dsa, st + kQ);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dk);
        sm90::fence_regs(dv);
      }
      sm90::mbar_arrive(bar.empty + s);
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    if constexpr (RING) {
      const bool first = (pc.flags & flash::kRingFirst) != 0u;
      const bool last = (pc.flags & flash::kRingLastKv) != 0u;
      sum_rows<DP>(P.ring.acc + koff, a.dk + koff, dk, kw0, Tk, D, a.grad_scale, first, last,
                   wwarp, g, t);
      sum_rows<DP>(P.ring.acc2 + koff, a.dv + koff, dv, kw0, Tk, D, 1.0f, first, last, wwarp, g,
                   t);
    } else {
      store_rows<DP>(a.dk + koff, dk, kw0, Tk, D, a.grad_scale, wwarp, g, t);
      store_rows<DP>(a.dv + koff, dv, kw0, Tk, D, 1.0f, wwarp, g, t);
    }
  }
}

// ---- host ----------------------------------------------------------------

// dq: q/dO boxes of 128 rows, K/V of 64; dkv: the other way round.  A
// ring launch reads each tensor as [B*H*sp, S, D], a plane a shard (TMA's
// zeros end a shard as they end a plain tensor), and its grid holds every
// pair's blocks, the pair in z.
template <bool RING, typename K>
cudaError_t launch(K kernel, Params& P, int n_own, int q_rows, int k_rows, size_t smem,
                   cudaStream_t st) {
  const Args& a = P.a;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  CUtensorMap tq{}, tdo{}, tk{}, tv{};
  const int BH = a.B * a.H;
  const int planes = RING ? BH * P.ring.sp : BH;
  P.tma = a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
          aligned16(a.dout);
  if (P.tma && !(encode(&tq, a.q, planes, a.Tq, a.D, q_rows) &&
                 encode(&tdo, a.dout, planes, a.Tq, a.D, q_rows) &&
                 encode(&tk, a.k, planes, a.Tk, a.D, k_rows) &&
                 encode(&tv, a.v, planes, a.Tk, a.D, k_rows))) {
    return cudaErrorInvalidValue;
  }
  P.vec = P.tma && (P.o == nullptr || aligned16(P.o));
  const dim3 grid(BH, (n_own + kRows - 1) / kRows, RING ? P.ring.n : 1);
  kernel<<<grid, kThreads, smem, st>>>(P, tq, tdo, tk, tv);
  return cudaGetLastError();
}

template <int DP, bool RING>
cudaError_t launch_dq(Params& P, cudaStream_t st) {
  return launch<RING>(flash_bwd_dq_bf16_kernel<DP, RING>, P, P.a.Tq, kRows, kTile,
                      DqLayout<DP>::kBytes, st);
}

template <int DP, bool RING>
cudaError_t launch_dkv(Params& P, cudaStream_t st) {
  return launch<RING>(flash_bwd_dkv_bf16_kernel<DP, RING>, P, P.a.Tk, kTile, kRows,
                      DkvLayout<DP>::kBytes, st);
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
cudaError_t occupancy_dp(int* out) {
  cudaError_t err = occupancy(flash_bwd_dq_bf16_kernel<DP, false>, DqLayout<DP>::kBytes, out);
  if (err != cudaSuccess) return err;
  return occupancy(flash_bwd_dkv_bf16_kernel<DP, false>, DkvLayout<DP>::kBytes, out + 4);
}

bool bad_shape(int B, int H, int Tq, int Tk, int D, int bq, int bk) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 || bq <= 0 || bk <= 0 ||
         (Tq + kRows - 1) / kRows > 65535 || (Tk + kRows - 1) / kRows > 65535;
}

Params make_params(const void* q, const void* k, const void* v, const void* mask,
                   const void* seed, const void* dout, const void* lse, const void* delta, int B,
                   int H, int Tq, int Tk, int D, int causal, float scale_log2, float grad_scale,
                   float rate, float keep_scale, int bq, int bk) {
  Params P{};
  Args& a = P.a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const float*>(mask);
  a.seed = static_cast<const int32_t*>(seed);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.causal = causal;
  a.scale_log2 = scale_log2;
  a.grad_scale = grad_scale;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.bq = bq; a.bk = bk;
  return P;
}

}  // namespace

extern "C" {

// q/dout/o/dq [B, H, Tq, D], k/v [B, H, Tk, D] bfloat16; mask [B, Tk]
// float32 or null; seed [1] int32 or null; lse [B*H, Tq] float32.  delta
// [B*H, Tq] float32, or null: then delta = rowsum(dO * O) is computed
// from `o` and written to delta_out [B*H, Tq] float32 (o and delta_out
// are not read otherwise).  dq_scale is sm_scale.  All contiguous and on
// `device`; the launch goes to `stream`.  Returns a cudaError_t.
int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* mask,
                           const void* seed, const void* dout, const void* lse,
                           const void* delta, const void* o, void* delta_out, void* dq, int B,
                           int H, int Tq, int Tk, int D, int causal, float scale_log2,
                           float dq_scale, float rate, float keep_scale, int bq, int bk,
                           int device, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D, bq, bk) ||
      (delta == nullptr && (o == nullptr || delta_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P = make_params(q, k, v, mask, seed, dout, lse, delta, B, H, Tq, Tk, D, causal,
                         scale_log2, dq_scale, rate, keep_scale, bq, bk);
  P.a.out = static_cast<bf16*>(dq);
  if (delta == nullptr) {
    P.o = static_cast<const bf16*>(o);
    P.delta_out = static_cast<float*>(delta_out);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return static_cast<int>(launch_dq<64, false>(P, st));
  return static_cast<int>(launch_dq<128, false>(P, st));
}

// as flash_attn_bwd_dq_bf16 with delta given, writing dk/dv [B, H, Tk, D]
// bfloat16; dk_scale is sm_scale (dk takes the unscaled q).
int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* mask,
                            const void* seed, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk,
                            int D, int causal, float scale_log2, float dk_scale, float rate,
                            float keep_scale, int bq, int bk, int device, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D, bq, bk) || delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P = make_params(q, k, v, mask, seed, dout, lse, delta, B, H, Tq, Tk, D, causal,
                         scale_log2, dk_scale, rate, keep_scale, bq, bk);
  P.a.dk = static_cast<bf16*>(dk);
  P.a.dv = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return static_cast<int>(launch_dkv<64, false>(P, st));
  return static_cast<int>(launch_dkv<128, false>(P, st));
}

// Ring attention's hop launches, with flash_attn_bwd_dq_ring()'s and
// flash_attn_bwd_dkv_ring()'s arguments (flash_attn_bwd.cu) in bfloat16:
// q, k, v, dout, o and the outputs bfloat16, the accumulators float32.
// Each pair's gradients are rounded to bfloat16 before they are added; a
// shard's last pair writes dq (dk, dv) in bfloat16.  K2 with delta null
// computes the pairs' q-shard rows of delta from o into delta_out (the
// first hop), as flash_attn_bwd_dq_bf16 does.
static int bwd_ring(bool dq, const void* q, const void* k, const void* v, const void* mask,
                    const void* seeds, const void* dout, const void* lse, const void* delta,
                    const void* o, void* delta_out, void* acc1, void* acc2, void* out1,
                    void* out2, int B, int H, int sp, int Sq, int Sk, int D, float scale_log2,
                    float grad_scale, float rate, float keep_scale, int bq, int bk, int n_pairs,
                    const uint32_t* pairs, int device, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, bq, bk) || sp <= 0 || sp >= 4096 || n_pairs <= 0 ||
      n_pairs > flash::kRingMaxPairs || seeds == nullptr ||
      (delta == nullptr && (!dq || o == nullptr || delta_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P = make_params(q, k, v, mask, nullptr, dout, lse, delta, B, H, Sq, Sk, D, 0,
                         scale_log2, grad_scale, rate, keep_scale, bq, bk);
  flash::Ring& r = P.ring;
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
    P.a.out = static_cast<bf16*>(out1);
    if (delta == nullptr) {
      P.o = static_cast<const bf16*>(o);
      P.delta_out = static_cast<float*>(delta_out);
    }
    return static_cast<int>(D <= 64 ? launch_dq<64, true>(P, st) : launch_dq<128, true>(P, st));
  }
  P.a.dk = static_cast<bf16*>(out1);
  P.a.dv = static_cast<bf16*>(out2);
  return static_cast<int>(D <= 64 ? launch_dkv<64, true>(P, st) : launch_dkv<128, true>(P, st));
}

int flash_attn_bwd_dq_bf16_ring(const void* q, const void* k, const void* v, const void* mask,
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

int flash_attn_bwd_dkv_bf16_ring(const void* q, const void* k, const void* v, const void* mask,
                                 const void* seeds, const void* dout, const void* lse,
                                 const void* delta, void* dk_acc, void* dv_acc, void* dk,
                                 void* dv, int B, int H, int sp, int Sq, int Sk, int D,
                                 float scale_log2, float dk_scale, float rate, float keep_scale,
                                 int bq, int bk, int n_pairs, const uint32_t* pairs, int device,
                                 void* stream) {
  return bwd_ring(false, q, k, v, mask, seeds, dout, lse, delta, nullptr, nullptr, dk_acc,
                  dv_acc, dk, dv, B, H, sp, Sq, Sk, D, scale_log2, dk_scale, rate, keep_scale,
                  bq, bk, n_pairs, pairs, device, stream);
}

// out[0..3]: K2's registers a thread, static and dynamic shared memory
// (bytes) a block and resident blocks an SM at head dim D; out[4..7]: the
// same for K3.  Returns a cudaError_t.
int flash_attn_bwd_bf16_occupancy(int D, int device, int* out) {
  if (D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D <= 64) return static_cast<int>(occupancy_dp<64>(out));
  return static_cast<int>(occupancy_dp<128>(out));
}

const char* flash_attn_bwd_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
