// Flash-attention forward for Hopper (sm_90a), bfloat16: K1's bfloat16
// mode.
//
// Replaces the Pallas kernel paddle_tpu/kernels/attention.py:226
// _flash_fwd_kernel (launched by _pallas_fwd through pl.pallas_call at
// :416) on bfloat16 q, k, v [B, H, T, D], the dtype its products run in on
// the TPU ("the dot runs in the INPUT dtype", attention.py:141-143).  It
// computes what flash_attn_fwd.cu computes in float32 (the same masks,
// causal visits of the reference's logical tiles, dropout bits and +1e30
// LSE of an empty row: flash_attn_common.cuh), with the reference's
// bfloat16 arithmetic:
//
//   S = bf16(q * scale_log2) . K^T     (q pre-scaled in float32 and
//                                       rounded back, _scaled_q)
//   p = exp2(S - m), m the running max in exp2 units
//   O += bf16(p * drop) . V            (float32 accumulator)
//   l += p, or += bf16(p) where the reference carries l in V's ones
//        lane (D < 128 and no dropout, _lane_pack_ok)
//
// and writes out = O / max(l, 1e-30) in bfloat16 and the LSE in float32.
// A masked key scores -1e30, a key the row does not visit -inf; an
// all-masked row also counts the mass of the reference's zero-padded keys
// in [Tk, key_end).  Every product is bfloat16 x bfloat16 with a float32
// sum.  The reference rounds p against the running max of its logical
// k-tile (128 to 1,024 keys); this kernel against the max of its own
// tiles, so a p can round to the neighbouring bfloat16 and the output
// differ by an ulp.
//
// Design (sm90.cuh).  A block is three warpgroups: two consumers of 64
// query rows each and a producer.  The producer loads each consumer's q
// tile once by TMA, then streams K and V tiles into a five-stage ring of
// 128-byte-swizzled panels (TMA; mbarriers load, full, empty), and with
// each stage the tile's key mask bits and, under dropout, the keys' two
// parts of the dropout hash; it reads a tile's mask a tile ahead.  It
// decides which consumers visit a tile: a consumer skips the tiles past
// its rows' frontier (the reference's logical tiles) and, once every one
// of its rows has softmax mass on a key already streamed, the tiles that
// give it p = 0 only (every key masked, or causally excluded); a tile is
// full for a consumer where no pair needs a test.  A consumer scales its q
// tile in place (bf16(q * scale_log2)) and runs S = q~ . K^T as a wgmma
// with both operands in shared memory, the online softmax on S's C
// fragments, and P . V with P from registers (S's C fragments packed to
// bfloat16) and V read MN-major.  In one step it issues S of this tile and
// P . V of the last as two wgmma groups; the softmax of this tile then
// runs while the last tile's P . V does (64-key tiles), or after it
// (128-key tiles, whose two P do not fit in registers at once).
//
// Registers bound the tiles: __launch_bounds__(384, 1) gives 168 a
// thread, and setmaxnreg moves them to 80 for the producer (at 24 to 72
// it spills) and 208 for the consumers.  D <= 64 without dropout takes
// 128-key tiles (S 64 + O 32 + P 32 registers); with dropout, whose hash
// needs registers of its own, and at D = 128 (S 32 + O 64 + P 16 + the
// next P 16), 64-key tiles.  128-key tiles at D = 128 spill at any split;
// a third consumer at D <= 64 (192 rows, 144 registers each) was no
// faster.
//
// The consumers take no turns on the tensor cores.  A build in which they
// did (two named barriers handing the products from one consumer to the
// other while both had tiles to visit, so that one's softmax met the
// other's products) was 2-7% slower at every shape on the H100, (b) below
// included (PERF.md, K1 bf16, F4): the two consumers' groups and softmaxes
// interleave as well by themselves.
//
// Causal work: where the grid is one wave (one block an SM, the ring's
// diagonal pair), a block's consumers take the 64-row q-blocks i and n -
// 1 - i, so every block does the same work and the wave ends with its
// blocks; an odd middle q-block runs with consumer 1 idle.  Over more
// waves (and not causal) a block takes neighbouring q-blocks, the longest
// launched first: both consumers then visit every tile they share.  Flags
// read from shared memory are broadcast from lane 0 (uniform()), so each
// wgmma group is issued whole.  No atomics: a rerun is bit for bit.
//
// TMA reads the 3-D view [B*H, T, D] of each tensor, so the rows past T
// and the columns past D (D <= 32 pads to a 64-column panel) are zeros.
// For a tensor TMA cannot describe (D % 8 != 0, or a base off 16 bytes)
// the same kernel's producer stages the rows with plain loads into the
// same swizzled layout (sm90::stage_plain).
//
// Floors on the H100 (989 TFLOP/s dense bf16; the special-function
// units' ex2 at 4.23 T/s, 16 a clock an SM, mma_rate.py; 3.35 TB/s).  (a)
// B=32, H=8, T=256, D=64: 4 * D operations a pair, 4.3 GFLOP, 4.3 us;
// 16.8 M exp2, 4.0 us; about 34 MB of q, k, v, out, mask and LSE, 10.1
// us: the bytes.  (b) B=4, H=8, T=8192, D=64 causal: 275 GFLOP of the
// causal pairs, 0.278 ms; 1.07 G exp2, 0.254 ms: the products and the
// exp2s weigh nearly the same.  (c) B=4, H=4, T=8192, D=128 causal: 0.278
// ms of products, 0.127 ms of exp2.  (d) the bf16 ring's pair, B=1, H=4, 4,096 x 4,096, D=128:
// 34.4 GFLOP at most, 0.0347 ms; 67 M exp2, 0.016 ms.  The K and V tiles
// a block streams come from the L2: 128 query rows a tile make 128
// operations a byte, so the products at 989 TFLOP/s would need ~7.7 TB/s
// of it (blocks that stream the tiles and compute nothing move ~5.3 TB/s
// at (b)).
//
// Ring attention (flash_attn_common.cuh): flash_attn_fwd_bf16_ring() runs
// one hop's pairs as one launch of the same kernel instantiated for the
// ring.  Its tensor maps view each whole tensor as [B*H*sp, S, D], a plane
// a shard, so a pair's tiles end at its shard's end with TMA's zeros, as
// a plain launch's end at its tensor's; its epilogue rounds the pair's
// output to bfloat16 and merges it into float32 accumulators.
//
// Entry points: flash_attn_fwd_bf16() and flash_attn_fwd_bf16_ring(),
// plain C functions called through ctypes on PyTorch's current stream,
// with flash_attn_fwd()'s and flash_attn_fwd_ring()'s arguments; they
// launch and return a cudaError_t, never synchronise and allocate
// nothing.  flash_attn_fwd_bf16_occupancy() reports the kernels'
// registers, shared memory, resident blocks and local (spill) bytes.

#include <cuda_bf16.h>

#include "flash_attn_common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kNegInf;
using Args = flash::ArgsT<bf16>;
using sm90::kPanelRow;
using sm90::tile_bytes;
using sm90::uniform;

constexpr int kRowsWG = 64;                // query rows a consumer warpgroup owns
constexpr int kProducer = 128;             // the producer warpgroup
constexpr int kThreads = 256 + kProducer;  // consumers 0..255, producer 256..383
// setmaxnreg: the producer keeps 80 registers (at 24 to 72 it spills),
// the consumers take 208
constexpr int kProducerRegs = 80;
constexpr int kConsumerRegs = 208;
constexpr unsigned kAll = 0xffffffffu;

// what the softmax mass sums and whether dropout multiplies p: the
// unrounded p (D = 128, no dropout), the rounded p (the ones lane: D < 128,
// no dropout), or the unrounded p with dropout
enum Mode { kPlain = 0, kOnes = 1, kDrop = 2 };

// keys a tile: 128 at D <= 64 without dropout (S 64 + O 32 + P 32
// registers a thread), else 64 (S 32 + O 64 + P 16 at D = 128; the
// dropout hash's registers at D <= 64)
template <int DP, int MODE>
__host__ __device__ constexpr int keys_of() {
  return DP == 64 && MODE != kDrop ? 128 : 64;
}

// whether a tile's softmax runs while the last tile's P . V does: the
// registers of both tiles' P live at once, which 64-key tiles afford
template <int DP, int MODE>
__host__ __device__ constexpr bool overlap_of() {
  return keys_of<DP, MODE>() == 64;
}

struct Params {
  Args a;
  int tma;   // tiles by TMA (else plain loads by the producer)
  int pair;  // causal: pair q-blocks i and n - 1 - i (else neighbours)
  flash::Ring ring;  // a ring launch's pairs (flash_attn_common.cuh)
};

// per stage: which tile, the consumers that visit it (live) and those that
// need no test on any of its pairs (full), the keys' mask bits and their
// parts of the dropout hash
template <int KN>
struct Info {
  int tile;
  int live[2];
  int full[2];
  int pad[3];
  uint32_t bits[KN / 32];
  uint32_t kx[KN];
  uint32_t ks[KN];
};

template <int DP, int MODE>
struct Layout {
  static constexpr int kKeys = keys_of<DP, MODE>();
  static constexpr int kStages = 5;
  static constexpr int kQTile = tile_bytes<DP>(kRowsWG);
  static constexpr int kQ = 0;                                 // q~ [2][64 rows]
  static constexpr int kStage = kQ + 2 * kQTile;               // K, V [kKeys rows]
  static constexpr int kStageBytes = 2 * tile_bytes<DP>(kKeys);
  static constexpr int kInfo = kStage + kStages * kStageBytes;
  static constexpr int kBars = kInfo + kStages * static_cast<int>(sizeof(Info<kKeys>));
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;  // + alignment
};

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// S (64 x KN) = q~ . K^T over DP columns: q~ the consumer's 64-row tile,
// K a KN-row stage tile, both K-major
template <int DP, int KN>
__device__ __forceinline__ void product_qk(float (&s)[KN / 2], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t ka = (kk >> 2) * kRowsWG * kPanelRow + (kk & 3) * 32;
    const uint32_t kb = (kk >> 2) * KN * kPanelRow + (kk & 3) * 32;
    const uint64_t da = sm90::desc_b128(q_tile + ka, 16, 1024);
    const uint64_t db = sm90::desc_b128(k_tile + kb, 16, 1024);
    if constexpr (KN == 128) {
      sm90::wgmma_ss_n128<0>(s, da, db, kk > 0);
    } else {
      sm90::wgmma_ss_n64<0>(s, da, db, kk > 0);
    }
  }
}

// O (64 x DP) += P . V: P (64 x KN) in registers, KN / 16 k16 slices; V a
// KN-row stage tile read MN-major (rows = k)
template <int DP, int KN>
__device__ __forceinline__ void product_pv(float (&o)[DP / 2], const uint32_t (&p)[KN / 16][4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    const uint64_t db = sm90::desc_b128(v_tile + kk * 16 * kPanelRow, KN * kPanelRow, 1024);
    if constexpr (DP == 64) {
      sm90::wgmma_rs_n64<1>(o, p[kk], db, 1);
    } else {
      sm90::wgmma_rs_n128<1>(o, p[kk], db, 1);
    }
  }
}

// this thread's two query rows (fragment rows g and g + 8 of its warp):
// index, end of the visited keys that hold data (key_end's min with Tk),
// dropout parts
struct Rows {
  int row[2], kvis[2];
  uint32_t x[2], salt[2];
};

// The online softmax of one tile on S's C fragments: masks (unless FULL),
// the new running max and its rescale factor alpha (l rescaled; the caller
// rescales O once the last tile's P . V is done), p = exp2(S - m), the
// mass, the dropout multiplier, and p rounded to bfloat16 into P . V's A
// fragments pk (k16 slice kk is chunks 2kk and 2kk + 1).  A masked key
// scores the finite -1e30, a key the row does not visit -inf (no weight,
// and the max is left alone).  S is read into a copy and pk has registers
// of its own: an instruction that writes an accumulator register of the S
// product while the last tile's P . V is in flight makes ptxas serialize
// the products (C7515), and a bit copy of one made it wait for S before
// the group's commit (C7517).
template <int KN, int MODE, bool FULL>
__device__ __forceinline__ void softmax(const float (&s0)[KN / 2], uint32_t (&pk)[KN / 16][4],
                                        float (&m)[2], float (&l)[2], float (&alpha)[2],
                                        const Info<KN>* inf, const Rows& r, const Args& a,
                                        int causal, uint32_t threshold, int t) {
  float s[KN / 2];
#pragma unroll
  for (int i = 0; i < KN / 2; ++i) s[i] = s0[i];
  if (!FULL) {
    const int k0 = inf->tile * KN;
#pragma unroll
    for (int j = 0; j < KN / 8; ++j) {
      const uint32_t bw = inf->bits[j >> 2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = 8 * j + 2 * t + (e & 1), key = k0 + c;
        const bool keep = ((bw >> (c & 31)) & 1u) && (!causal || key <= r.row[h]);
        s[4 * j + e] = key < r.kvis[h] ? (keep ? s[4 * j + e] : kNegInf) : -INFINITY;
      }
    }
  }
  // the row max and the row's mass in two chains each
  constexpr int NJ = KN / 8;
  float mp[2][2] = {{m[0], m[0]}, {m[1], m[1]}};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = mp[e >> 1][e & 1];
      x = fmaxf(x, s[4 * j + e]);
    }
  }
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mp[h][0], mp[h][1]);
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kAll, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kAll, mx[h], 2));
    alpha[h] = sm90::ex2(m[h] - mx[h]);
    m[h] = mx[h];
  }
  float ls[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint2 kx = make_uint2(0u, 0u), ks = make_uint2(0u, 0u);
    if (MODE == kDrop) {
      kx = *reinterpret_cast<const uint2*>(&inf->kx[8 * j + 2 * t]);
      ks = *reinterpret_cast<const uint2*>(&inf->ks[8 * j + 2 * t]);
    }
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      x[e] = sm90::ex2(s[4 * j + e] - mx[h]);
      // the mass sums probabilities before dropout
      if (MODE != kOnes) ls[h][j & 1] += x[e];
      if (MODE == kDrop) {
        x[e] *= flash::drop_of(r.x[h], r.salt[h], (e & 1) ? kx.y : kx.x, (e & 1) ? ks.y : ks.x,
                               threshold, a.keep_scale);
      }
    }
    const uint32_t w0 = sm90::pack_bf16x2(x[0], x[1]);
    const uint32_t w1 = sm90::pack_bf16x2(x[2], x[3]);
    if (MODE == kOnes) {  // the rounded p: the words' two bfloat16 halves
      ls[0][j & 1] += __uint_as_float(w0 << 16) + __uint_as_float(w0 & 0xffff0000u);
      ls[1][j & 1] += __uint_as_float(w1 << 16) + __uint_as_float(w1 & 0xffff0000u);
    }
    pk[j >> 1][(j & 1) * 2] = w0;
    pk[j >> 1][(j & 1) * 2 + 1] = w1;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l[h] * alpha[h] + (ls[h][0] + ls[h][1]);
  }
}

// keeps the compiler from moving writes of P's registers past a wgmma
// fence (as sm90::fence_regs for accumulators)
template <int KN>
__device__ __forceinline__ void fence_p(uint32_t (&p)[KN / 16][4]) {
#pragma unroll
  for (int i = 0; i < KN / 16; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
  }
}

template <int DP, int MODE, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ Params P,
                          const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v) {
  using L = Layout<DP, MODE>;
  constexpr int KN = L::kKeys;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::aligned_smem(smem_raw);
  const sm90::Bars bar = sm90::bars_at(sm + L::kBars, kStages);
  Info<KN>* info = reinterpret_cast<Info<KN>*>(sm + L::kInfo);
  sm90::init_bars(bar, kStages, kProducer, 256);

  const Args& a = P.a;
  const int Tq = a.Tq, Tk = a.Tk, D = a.D;
  const int bh = blockIdx.x;
  // a ring launch's pair (the plain kernel keeps its own expressions)
  const flash::PairAt pc = flash::pair_at<RING>(a, P.ring, bh, blockIdx.z);
  const int causal = RING ? pc.causal : a.causal;
  const int qplane = RING ? pc.qplane : bh, kplane = RING ? pc.kplane : bh;
  // (a plain launch pairs only where it is causal)
  const bool paired = RING ? P.pair && causal : P.pair;
  const int nblk = gridDim.y, y = blockIdx.y;
  // the consumers' first rows: paired, q-blocks i and n - 1 - i of 64
  // rows (the same causal work in every block); else neighbours, the
  // last (longest causal) blocks launched first.  Consumer 1 is idle where
  // its q-block is consumer 0's (the odd middle one) or past Tq, and then
  // loads consumer 0's rows.
  const int nqb = (Tq + kRowsWG - 1) / kRowsWG;
  const int by = causal ? nblk - 1 - y : y;
  const int row0 = paired ? y * kRowsWG : by * 2 * kRowsWG;
  const int r1 = paired ? (nqb - 1 - y) * kRowsWG : row0 + kRowsWG;
  const bool has1 = r1 < Tq && r1 != row0;
  const int row1 = has1 ? r1 : row0;

  // the warpgroup (2: the producer), broadcast from lane 0 so the compiler
  // sees it uniform: it keeps the wgmma groups whole and each branch's
  // register count
  const int role = __shfl_sync(kAll, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 2) {
    // ===== producer =====
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int tid = threadIdx.x - 256, lane = tid & 31;
    const size_t qoff = RING ? pc.qrow * D : static_cast<size_t>(bh) * Tq * D;
    const size_t koff = RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D;
    // the q tiles
    if (P.tma) {
      if (tid == 0) {
        sm90::mbar_expect_tx(bar.res, 2 * L::kQTile);
        sm90::tma_tile<DP, kRowsWG>(sm + L::kQ, &tm_q, bar.res, row0, qplane);
        sm90::tma_tile<DP, kRowsWG>(sm + L::kQ + L::kQTile, &tm_q, bar.res, row1, qplane);
      } else {
        sm90::mbar_arrive(bar.res);
      }
    } else {
      sm90::stage_plain<DP, kRowsWG, kProducer>(sm + L::kQ, a.q + qoff, row0, Tq, D, tid);
      sm90::stage_plain<DP, kRowsWG, kProducer>(sm + L::kQ + L::kQTile, a.q + qoff, row1, Tq, D,
                                                tid);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar.res);
    }
    // each consumer's first and last row, the end of the keys its last row
    // visits (its frontier) and of those its first row visits (the least:
    // a full tile ends before it); every producer warp computes the same
    int first[2], last[2], wkend[2], wkend0[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const bool own = w == 0 || has1;
      first[w] = w == 0 ? row0 : row1;
      last[w] = min(first[w] + kRowsWG - 1, Tq - 1);
      wkend[w] = own ? flash::key_end(last[w], Tk, causal, a.bq, a.bk) : 0;
      wkend0[w] = own ? flash::key_end(first[w], Tk, causal, a.bq, a.bk) : 0;
    }
    const int kend_blk = min(max(wkend[0], wkend[1]), Tk);
    const int ntiles = (kend_blk + KN - 1) / KN;
    const float* mrow =
        a.mask ? a.mask + (RING ? pc.mrow : static_cast<size_t>(bh / a.H) * Tk) : nullptr;
    auto valid = [&](int key) {
      return key < Tk && (mrow == nullptr || mrow[key] > 0.0f);
    };
    // the validity of a tile's keys lane + 32 i, read a tile ahead
    bool next[KN / 32];
#pragma unroll
    for (int i = 0; i < KN / 32; ++i) next[i] = valid(lane + 32 * i);
    int fk = Tk;  // the first valid key of the tiles streamed so far
    int s = 0;
    uint32_t ph = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * KN;
      uint32_t bits[KN / 32];
      bool any = false, all = true;
#pragma unroll
      for (int i = 0; i < KN / 32; ++i) {
        bits[i] = __ballot_sync(kAll, next[i]);
        next[i] = valid(k0 + KN + lane + 32 * i);
        any = any || bits[i] != 0u;
        all = all && bits[i] == kAll;
      }
      if (fk == Tk && any) {
#pragma unroll
        for (int i = KN / 32 - 1; i >= 0; --i) {
          if (bits[i] != 0u) fk = k0 + 32 * i + __ffs(bits[i]) - 1;
        }
      }
      bool live[2], full[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        // every row of the consumer has softmax mass on key fk (visited:
        // fk <= row < its key end), so a tile whose pairs are all masked or
        // causally excluded gives it p = 0 only
        const bool mass = fk < Tk && (!causal || fk <= first[w]);
        // past its frontier, or past its rows' causal end: no live tile on
        const bool over = k0 >= wkend[w] || (mass && causal && k0 > last[w]);
        live[w] = !over && !(mass && !any);
        full[w] = all && k0 + KN <= wkend0[w] && (!causal || k0 + KN - 1 <= first[w]);
      }
      if (!live[0] && !live[1]) continue;
      sm90::mbar_wait(bar.empty + s, ph ^ 1);
      unsigned char* st = sm + L::kStage + s * L::kStageBytes;
      if (P.tma) {
        if (tid == 0) {
          sm90::mbar_expect_tx(bar.load + s, L::kStageBytes);
          sm90::tma_tile<DP, KN>(st, &tm_k, bar.load + s, k0, kplane);
          sm90::tma_tile<DP, KN>(st + tile_bytes<DP>(KN), &tm_v, bar.load + s, k0, kplane);
        }
      } else {
        sm90::stage_plain<DP, KN, kProducer>(st, a.k + koff, k0, Tk, D, tid);
        sm90::stage_plain<DP, KN, kProducer>(st + tile_bytes<DP>(KN), a.v + koff, k0, Tk, D,
                                             tid);
        if (tid == 0) sm90::mbar_arrive(bar.load + s);
      }
      Info<KN>* inf = info + s;
      if (tid == 0) {
        inf->tile = t;
        inf->live[0] = live[0];
        inf->live[1] = live[1];
        inf->full[0] = full[0];
        inf->full[1] = full[1];
#pragma unroll
        for (int i = 0; i < KN / 32; ++i) inf->bits[i] = bits[i];
      }
      if (MODE == kDrop) {
        for (int j = tid; j < KN; j += kProducer) {
          inf->kx[j] = flash::drop_key_x(k0 + j, a.bk);
          inf->ks[j] = flash::drop_key_salt(k0 + j, a.bk);
        }
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
    const bool own = w == 0 || has1;
    const int rw0 = w == 0 ? row0 : row1;
    const uint32_t seed = flash::seed_of<RING>(a, P.ring, blockIdx.z);
    const uint32_t threshold = flash::drop_threshold(a.rate);
    Rows r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw0 + wwarp * 16 + g + 8 * h;
      r.row[h] = row;
      r.kvis[h] = own && row < Tq ? min(flash::key_end(row, Tk, causal, a.bq, a.bk), Tk) : 0;
      r.x[h] = flash::drop_row_x(row, a.bq);
      r.salt[h] = flash::drop_row_salt(row, a.bq, seed, bh);
    }
    // q~ = bf16(q * scale_log2) in place over this consumer's tile
    sm90::mbar_wait(bar.res, 0);
    unsigned char* qt = sm + L::kQ + w * L::kQTile;
    sm90::scale_bytes(qt, qt, L::kQTile, a.scale_log2, wt, 128);
    sm90::fence_proxy_async();
    sm90::named_barrier(1 + w, 128);

    const uint32_t q_tile = sm90::smem_u32(qt);
    const uint32_t stages = sm90::smem_u32(sm + L::kStage);
    float o[DP / 2];
    zero(o);
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's part of each row's mass
    uint32_t p[KN / 16][4];     // the pending tile's P, P . V's A operand
    int pend = -1;              // the pending tile's stage
    int s = 0;
    uint32_t ph = 0;
    for (;;) {
      sm90::mbar_wait(bar.load + s, ph);
      sm90::mbar_wait(bar.full + s, ph);
      const Info<KN>* inf = info + s;
      if (uniform(inf->tile) < 0) break;
      const bool live = uniform(inf->live[w]);
      const uint32_t st = stages + s * L::kStageBytes;
      float sc[KN / 2];
      // S of this tile, then P . V of the last as a second group
      sm90::fence_regs(o);
      fence_p<KN>(p);
      sm90::wgmma_fence();
      if (live) product_qk<DP, KN>(sc, q_tile, st);
      sm90::wgmma_commit();
      if (pend >= 0) {
        product_pv<DP, KN>(o, p, stages + pend * L::kStageBytes + tile_bytes<DP>(KN));
      }
      sm90::wgmma_commit();
      // this tile's softmax runs while the last tile's P . V does, or
      // after it
      if constexpr (overlap_of<DP, MODE>()) {
        sm90::wgmma_wait<1>();
      } else {
        sm90::wgmma_wait<0>();
      }
      float alpha[2];
      uint32_t pk[KN / 16][4];
      // where the last P . V is done, this tile's P goes to P's registers
      uint32_t(&dst)[KN / 16][4] = overlap_of<DP, MODE>() ? pk : p;
      if (live) {
        sm90::fence_regs(sc);
        if (uniform(inf->full[w])) {
          softmax<KN, MODE, true>(sc, dst, m, l, alpha, inf, r, a, causal, threshold, t);
        } else {
          softmax<KN, MODE, false>(sc, dst, m, l, alpha, inf, r, a, causal, threshold, t);
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      if (pend >= 0) {
        sm90::mbar_arrive(bar.empty + pend);
        pend = -1;
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        if constexpr (overlap_of<DP, MODE>()) {
#pragma unroll
          for (int i = 0; i < KN / 16; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) p[i][j] = pk[i][j];
          }
        }
        pend = s;
      } else {
        sm90::mbar_arrive(bar.empty + s);
      }
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    // the last tile's P . V
    sm90::fence_regs(o);
    fence_p<KN>(p);
    sm90::wgmma_fence();
    if (pend >= 0) {
      product_pv<DP, KN>(o, p, stages + pend * L::kStageBytes + tile_bytes<DP>(KN));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);

    bf16* out = a.out + (RING ? pc.qrow * D : static_cast<size_t>(bh) * Tq * D);
    // two columns a store where rows keep them 4-byte aligned
    const bool pair = (D % 2 == 0) && (reinterpret_cast<uintptr_t>(a.out) & 3u) == 0;
    // ring: the carried lse of each row, read by the row's four threads
    // before its first thread writes it
    const bool first = (pc.flags & flash::kRingFirst) != 0u;
    const bool last_hop = (pc.flags & flash::kRingLastQ) != 0u;
    float lse_a[2] = {0.0f, 0.0f};
    if constexpr (RING) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!first && own && r.row[h] < Tq) lse_a[h] = P.ring.acc2[pc.qrow + r.row[h]];
      }
      __syncwarp();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kAll, l[h], 1);
      l[h] += __shfl_xor_sync(kAll, l[h], 2);
      const int row = r.row[h];
      if (!own || row >= Tq) continue;
      // the reference's zero-padded keys in [Tk, kend) score -1e30: they add
      // mass 1 each to a row whose every visited key is masked, else 0
      const int kend = flash::key_end(row, Tk, causal, a.bq, a.bk);
      if (m[h] == kNegInf && kend > Tk) l[h] += static_cast<float>(kend - Tk);
      const float den = fmaxf(l[h], 1e-30f);
      bf16* op = out + static_cast<size_t>(row) * D;
      if constexpr (RING) {
        // the pair's output rounded to bfloat16, merged into the float32
        // accumulators; a q shard's last pair writes out instead
        const flash::RingMerge wm = flash::ring_merge(lse_a[h], flash::lse_of(m[h], l[h]), first);
        float* ap = P.ring.acc + (pc.qrow + row) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = j * 8 + 2 * t + e;
            if (d >= D) continue;
            const float x = __bfloat162float(__float2bfloat16_rn(o[4 * j + 2 * h + e] / den));
            const float y = first ? x : ap[d] * wm.wa + x * wm.wp;
            if (last_hop) {
              op[d] = __float2bfloat16_rn(y);
            } else {
              ap[d] = y;
            }
          }
        }
        if (t == 0) P.ring.acc2[pc.qrow + row] = last_hop ? flash::kernel_lse(wm.lse) : wm.lse;
        continue;
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = j * 8 + 2 * t;
        const float x = o[4 * j + 2 * h] / den, y = o[4 * j + 2 * h + 1] / den;
        if (pair && d + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(op + d) = __floats2bfloat162_rn(x, y);
        } else {
          if (d < D) op[d] = __float2bfloat16_rn(x);
          if (d + 1 < D) op[d + 1] = __float2bfloat16_rn(y);
        }
      }
      if (t == 0) a.out_lse[static_cast<size_t>(bh) * Tq + row] = flash::lse_of(m[h], l[h]);
    }
  }
}

// ---- host ------------------------------------------------------------------

template <int DP, int MODE, bool RING>
cudaError_t launch(Params& P, cudaStream_t st) {
  using L = Layout<DP, MODE>;
  const auto kernel = flash_fwd_bf16_kernel<DP, MODE, RING>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kBytes);
  if (err != cudaSuccess) return err;
  const Args& a = P.a;
  const int BH = a.B * a.H;
  // a ring launch reads each tensor as [B*H*sp, S, D]: a plane a shard,
  // so TMA's zeros past S end a shard as they end a plain tensor
  const int planes = RING ? BH * P.ring.sp : BH;
  CUtensorMap tq{}, tk{}, tv{};
  P.tma = a.D % 8 == 0 && sm90::aligned16(a.q) && sm90::aligned16(a.k) && sm90::aligned16(a.v);
  if (P.tma && !(sm90::encode(&tq, a.q, planes, a.Tq, a.D, kRowsWG) &&
                 sm90::encode(&tk, a.k, planes, a.Tk, a.D, L::kKeys) &&
                 sm90::encode(&tv, a.v, planes, a.Tk, a.D, L::kKeys))) {
    return cudaErrorInvalidValue;
  }
  // 128 query rows a block, causal or not (two 64-row q-blocks).  Causal
  // blocks pair q-blocks i and n - 1 - i where the grid is one wave (one
  // block an SM): every block then does the same work, and the wave ends
  // with its blocks.  Over more waves neighbours do better, the longest
  // first: both consumers visit every tile (a lone consumer leaves the
  // tensor cores idle through its softmax and reads its K/V alone).  A
  // ring launch's grid holds every pair's blocks (the pair in z), and the
  // choice follows that whole grid.
  const dim3 grid(BH, (a.Tq + 2 * kRowsWG - 1) / (2 * kRowsWG), RING ? P.ring.n : 1);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  bool causal = a.causal != 0;
  if constexpr (RING) {
    for (int i = 0; i < P.ring.n; ++i) {
      causal = causal || ((P.ring.pair[i] >> 24) & flash::kRingCausal) != 0u;
    }
  }
  P.pair = causal && static_cast<long long>(grid.x) * grid.y * grid.z <= sms;
  kernel<<<grid, kThreads, L::kBytes, st>>>(P, tq, tk, tv);
  return cudaGetLastError();
}

template <bool RING>
cudaError_t launch_mode(Params& P, cudaStream_t st) {
  const int D = P.a.D;
  if (P.a.rate > 0.0f) {
    return D <= 64 ? launch<64, kDrop, RING>(P, st) : launch<128, kDrop, RING>(P, st);
  }
  if (D <= 64) return launch<64, kOnes, RING>(P, st);
  return D < 128 ? launch<128, kOnes, RING>(P, st) : launch<128, kPlain, RING>(P, st);
}

// registers a thread, static and dynamic shared memory a block, resident
// blocks an SM and local bytes a thread (spills) of one kernel
template <int DP, int MODE>
cudaError_t occupancy(int* out) {
  using L = Layout<DP, MODE>;
  const auto kernel = flash_fwd_bf16_kernel<DP, MODE, false>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kBytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, L::kBytes);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = L::kBytes;
  out[3] = blocks;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q [B, H, Tq, D], k/v [B, H, Tk, D], out [B, H, Tq, D] bfloat16; mask
// [B, Tk] float32 or null; seed [1] int32 or null; lse [B*H, Tq]
// float32.  All contiguous and on `device`; the launch goes to `stream`.
// Returns a cudaError_t.
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* mask,
                        const void* seed, void* out, void* lse, int B, int H, int Tq, int Tk,
                        int D, int causal, float scale_log2, float rate, float keep_scale,
                        int bq, int bk, int device, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 || bq <= 0 || bk <= 0 ||
      (Tq + 2 * kRowsWG - 1) / (2 * kRowsWG) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P{};
  Args& a = P.a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const float*>(mask);
  a.seed = static_cast<const int32_t*>(seed);
  a.out = static_cast<bf16*>(out);
  a.out_lse = static_cast<float*>(lse);
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.causal = causal;
  a.scale_log2 = scale_log2;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.bq = bq; a.bk = bk;
  return static_cast<int>(launch_mode<false>(P, static_cast<cudaStream_t>(stream)));
}

// Ring attention's hop launch, with flash_attn_fwd_ring()'s arguments
// (flash_attn_fwd.cu) in bfloat16: q, k, v and out bfloat16, the
// accumulators float32.  Each pair's output is rounded to bfloat16
// before it is merged; a q shard's last pair writes out in bfloat16.
int flash_attn_fwd_bf16_ring(const void* q, const void* k, const void* v, const void* mask,
                             const void* seeds, void* o_acc, void* lse_acc, void* out, int B,
                             int H, int sp, int Sq, int Sk, int D, float scale_log2, float rate,
                             float keep_scale, int bq, int bk, int n_pairs,
                             const uint32_t* pairs, int device, void* stream) {
  if (B <= 0 || H <= 0 || sp <= 0 || sp >= 4096 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128 ||
      bq <= 0 || bk <= 0 || n_pairs <= 0 || n_pairs > flash::kRingMaxPairs ||
      (Sq + 2 * kRowsWG - 1) / (2 * kRowsWG) > 65535 || seeds == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P{};
  Args& a = P.a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.Tq = Sq; a.Tk = Sk; a.D = D;
  a.scale_log2 = scale_log2;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.bq = bq; a.bk = bk;
  flash::Ring& r = P.ring;
  r.n = n_pairs;
  r.sp = sp;
  r.Sq = Sq;
  r.Sk = Sk;
  r.seeds = static_cast<const int32_t*>(seeds);
  r.acc = static_cast<float*>(o_acc);
  r.acc2 = static_cast<float*>(lse_acc);
  for (int i = 0; i < n_pairs; ++i) r.pair[i] = pairs[i];
  return static_cast<int>(launch_mode<true>(P, static_cast<cudaStream_t>(stream)));
}

// out[0..4]: the registers a thread, static and dynamic shared memory
// (bytes) a block, resident blocks an SM and local bytes a thread of the
// kernel that head dim D takes without dropout; out[5..9]: the same with
// dropout.  Returns a cudaError_t.
int flash_attn_fwd_bf16_occupancy(int D, int device, int* out) {
  if (D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D <= 64) {
    err = occupancy<64, kOnes>(out);
    if (err == cudaSuccess) err = occupancy<64, kDrop>(out + 5);
  } else {
    err = D < 128 ? occupancy<128, kOnes>(out) : occupancy<128, kPlain>(out);
    if (err == cudaSuccess) err = occupancy<128, kDrop>(out + 5);
  }
  return static_cast<int>(err);
}

const char* flash_attn_fwd_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
