// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// flash_attn_fwd.cu (forward) and flash_attn_bwd.cu (dq; dk and dv) in
// float32, flash_attn_fwd_bf16.cu and flash_attn_bwd_bf16.cu in bfloat16.
//
// Conventions the three kernels keep exactly, because the JAX package's
// Pallas kernels (paddle_tpu/kernels/attention.py _flash_fwd_kernel,
// _flash_bwd_dq_kernel, _flash_bwd_dkv_kernel) define them:
//
// - Scores are in exp2 units: q is pre-scaled by scale_log2 =
//   float(sm_scale * log2(e)), softmax uses exp2, and the saved LSE is
//   base 2.  A masked score is the FINITE -1e30, not -inf: a row whose
//   keys are all masked averages V uniformly instead of giving NaN.
// - Which (row, key) pairs a kernel visits follows the reference's
//   LOGICAL tiles (bq_ref x bk_ref from _resolve_blocks), not this
//   kernel's own tiling: with causal masking the forward and dq visit the
//   keys of the k-tiles up to the causal frontier of the row's q-tile,
//   and dk/dv visit the rows of the q-tiles from _first_qb of the key's
//   k-tile on.  Only an all-masked row can tell the difference, but that
//   row is where the reference's output is defined by its tiling.
// - Dropout bits are the reference's tile hash (_tile_dropout) of
//   (seed, batch*head, q-tile, k-tile, row and column inside the tile),
//   in native wrapping uint32 arithmetic; the softmax mass l sums the
//   probabilities BEFORE dropout.
// - Keys past Tk (the reference pads K/V to a multiple of bk_ref with
//   zero rows and masks them) are never read: their contribution is
//   added in closed form where it is not zero (the softmax mass of an
//   all-masked row in the forward).
//
// Ring attention's hop launches (the *_ring entries, one template
// instantiation of each kernel beside its plain one) run several
// (q-shard i, kv-shard j) pairs of one hop over the WHOLE tensors q, k,
// v, dO [B, H, T, D] (T = sp * S), the mask [B, Tk] and lse, delta [B*H,
// Tq]: a shard is a row offset, so nothing is copied.  A pair computes
// exactly what the plain kernel computes on the shards (Tq = Sq, Tk = Sk
// and their logical tiles, the pair's own causal flag and dropout seed),
// and its epilogue folds the result into float32 accumulators of the
// whole length: K1 merges its output, rounded to the output dtype, by
// log2 mass (the reference's _merge_partial); K2 and K3 add their
// gradients, rounded likewise.  No two pairs of a hop share a q shard or
// a kv shard, so no two blocks write the same rows and no atomics are
// needed; the sums follow the hops, the reference's order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;

// A row of D <= 128 values is spread over LPR = ceil(D / 32) adjacent
// lanes, 32 values each.  Lane `sub` of a row holds the values
//   d = ((e / 4) * LPR + sub) * 4 + e % 4,   e = 0 .. 31,
// so the LPR lanes of a row read neighbouring 16-byte words of a
// shared-memory row (no bank conflict) with float4 loads.
template <int LPR>
__device__ __forceinline__ int dim_of(int e, int sub) {
  return ((e >> 2) * LPR + sub) * 4 + (e & 3);
}

template <int LPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dot of the lane's 32 register values with its part of a shared row
template <int LPR>
__device__ __forceinline__ float dot_row(const float (&a)[32],
                                         const float* __restrict__ srow,
                                         int sub) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + (i * LPR + sub) * 4);
    acc = fmaf(a[4 * i + 0], b.x, acc);
    acc = fmaf(a[4 * i + 1], b.y, acc);
    acc = fmaf(a[4 * i + 2], b.z, acc);
    acc = fmaf(a[4 * i + 3], b.w, acc);
  }
  return acc;
}

// a += w * (the lane's part of a shared row)
template <int LPR>
__device__ __forceinline__ void axpy_row(float (&a)[32], float w,
                                         const float* __restrict__ srow,
                                         int sub) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + (i * LPR + sub) * 4);
    a[4 * i + 0] = fmaf(w, b.x, a[4 * i + 0]);
    a[4 * i + 1] = fmaf(w, b.y, a[4 * i + 1]);
    a[4 * i + 2] = fmaf(w, b.z, a[4 * i + 2]);
    a[4 * i + 3] = fmaf(w, b.w, a[4 * i + 3]);
  }
}

// the reference's _finalize_dropout mix, then keep iff the top 24 bits
// as a uniform in [0, 1) are >= rate
__device__ __forceinline__ float drop_mult(uint32_t seed, int bh, int row,
                                           int key, int bq, int bk,
                                           float rate, float keep_scale) {
  const uint32_t qi = static_cast<uint32_t>(row / bq);
  const uint32_t r = static_cast<uint32_t>(row) - qi * bq;
  const uint32_t kb = static_cast<uint32_t>(key / bk);
  const uint32_t c = static_cast<uint32_t>(key) - kb * bk;
  uint32_t x = (r * 0x9E3779B1u) ^ (c * 0x85EBCA77u);
  x ^= seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du + qi * 0x27D4EB2Fu +
       kb * 0x165667B1u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  return u >= rate ? keep_scale : 0.0f;
}

// end (exclusive) of the keys the forward and dq visit for `row`
__device__ __forceinline__ int key_end(int row, int Tk, int causal, int bq,
                                       int bk) {
  const int nkb = (Tk + bk - 1) / bk;
  if (!causal) return nkb * bk;
  const int last = min(((row / bq + 1) * bq - 1) / bk, nkb - 1);
  return (last + 1) * bk;
}

// first row dk/dv visit for `key` (the reference's _first_qb, clamped)
__device__ __forceinline__ int row_begin(int key, int Tq, int causal, int bq,
                                         int bk) {
  if (!causal) return 0;
  const int nqb = (Tq + bq - 1) / bq;
  return min((key / bk) * bk / bq, nqb - 1) * bq;
}

// The dropout hash of (row, key) in two parts computed once a row and
// once a key: the element's bits are drop_of(row_x ^ key_x, row_salt +
// key_salt), flash::drop_mult's.  The keep test float(x >> 8) * 2^-24 >=
// rate (both sides exact) is taken as the integer test x >=
// drop_threshold(rate).
__device__ __forceinline__ uint32_t drop_row_x(int row, int bq) {
  return (static_cast<uint32_t>(row) - static_cast<uint32_t>(row / bq) * bq) * 0x9E3779B1u;
}
__device__ __forceinline__ uint32_t drop_row_salt(int row, int bq, uint32_t seed, int bh) {
  return seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du +
         static_cast<uint32_t>(row / bq) * 0x27D4EB2Fu;
}
__device__ __forceinline__ uint32_t drop_key_x(int key, int bk) {
  return (static_cast<uint32_t>(key) - static_cast<uint32_t>(key / bk) * bk) * 0x85EBCA77u;
}
__device__ __forceinline__ uint32_t drop_key_salt(int key, int bk) {
  return static_cast<uint32_t>(key / bk) * 0x165667B1u;
}
// ceil(rate * 2^24) << 8: rate * 2^24 is exact in float32, and for rate
// < 1 the ceiling is at most 2^24 - 1, so the shift does not wrap
__device__ __forceinline__ uint32_t drop_threshold(float rate) {
  return static_cast<uint32_t>(ceilf(rate * 16777216.0f)) << 8;
}
__device__ __forceinline__ float drop_of(uint32_t row_x, uint32_t row_salt, uint32_t key_x,
                                         uint32_t key_salt, uint32_t threshold, float keep) {
  uint32_t x = row_x ^ key_x;
  x ^= row_salt + key_salt;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold ? keep : 0.0f;
}

// the base-2 LSE of a row from its max m and mass l: +1e30 where the mass
// is 0, so the backward's p = exp2(s - lse) is 0 there, never NaN
__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.0f ? m + log2f(fmaxf(l, 1e-30f)) : 1e30f;
}

// T is the element type of q, k, v, dO and the outputs (float for the
// float32 kernels, __nv_bfloat16 for the bfloat16 ones); the mask, LSE
// and delta are float32 in both.
template <typename T>
struct ArgsT {
  const T* q;            // [B, H, Tq, D]
  const T* k;            // [B, H, Tk, D]
  const T* v;            // [B, H, Tk, D]
  const float* mask;     // [B, Tk] 1/0 validity, or null (all valid)
  const int32_t* seed;   // [1] dropout seed, or null (0)
  const T* dout;         // [B, H, Tq, D] (backward)
  const float* lse;      // [B*H, Tq] base-2 LSE (backward input)
  const float* delta;    // [B*H, Tq] rowsum(dO * O) (backward)
  T* out;                // forward: O [B, H, Tq, D]; dq: dQ
  float* out_lse;        // forward: LSE [B*H, Tq]
  T* dk;                 // [B, H, Tk, D]
  T* dv;                 // [B, H, Tk, D]
  int B, H, Tq, Tk, D;
  int causal;
  float scale_log2;      // float(sm_scale * log2(e))
  float grad_scale;      // dq: sm_scale; dk: sm_scale / scale_log2 (float32,
                         // whose q tile is held pre-scaled) or sm_scale
  float rate;            // dropout rate (0: off)
  float keep_scale;      // float(1 / (1 - rate))
  int bq, bk;            // the reference's logical tile sizes
};
using Args = ArgsT<float>;

// ---- ring attention's hop launches ----------------------------------------

constexpr int kRingMaxPairs = 64;  // pairs a launch's table holds
// a pair's flags: the causal diagonal; the first hop (the accumulators are
// written, not read); the last pair of its q shard (K1's out and lse, K2's
// dq written in their final form) or of its kv shard (K3's dk, dv)
constexpr uint32_t kRingCausal = 1u, kRingFirst = 2u, kRingLastQ = 4u, kRingLastKv = 8u;

// a launch's pair table, passed by value in the kernel's parameters (no
// copy to the device, no sync): entry i | j << 12 | flags << 24
struct Ring {
  int n;                 // pairs in the table
  int sp;                // shards
  int Sq, Sk;            // rows of a q shard and of a kv shard
  const int32_t* seeds;  // [sp, sp] pair dropout seeds
  float* acc;            // K1: o_acc [B, H, Tq, D]; K2: dq_acc; K3: dk_acc [B, H, Tk, D]
  float* acc2;           // K1: lse_acc [B*H, Tq] (log2 masses); K3: dv_acc
  uint32_t pair[kRingMaxPairs];
};

// where a block's pair lies in the whole tensors: rows of the [B*H*Tq]
// and [B*H*Tk] planes and of the [B*Tk] mask where its shards start, the
// TMA planes of the [B*H*sp, S, D] views, and its causal flag.  The plain
// kernels (RING false) take the tensors as they are.
struct PairAt {
  uint32_t flags;
  int causal;
  size_t qrow, krow, mrow;
  int qplane, kplane;
};

// pair_at(a, r, bh, z): block (bh, *, z)'s pair.  A ring launch's grid
// takes the pair in z, its slowest dimension: a pair's blocks run
// together, as a plain launch's, and share their K/V tiles in the L2.
template <bool RING, typename T>
__device__ __forceinline__ PairAt pair_at(const ArgsT<T>& a, const Ring& r, int bh, int z) {
  PairAt p;
  if constexpr (RING) {
    const uint32_t e = r.pair[z];
    const int i = static_cast<int>(e & 0xfffu), j = static_cast<int>((e >> 12) & 0xfffu);
    p.flags = e >> 24;
    p.causal = (p.flags & kRingCausal) != 0u;
    const size_t tq = static_cast<size_t>(r.sp) * r.Sq, tk = static_cast<size_t>(r.sp) * r.Sk;
    p.qrow = static_cast<size_t>(bh) * tq + static_cast<size_t>(i) * r.Sq;
    p.krow = static_cast<size_t>(bh) * tk + static_cast<size_t>(j) * r.Sk;
    p.mrow = static_cast<size_t>(bh / a.H) * tk + static_cast<size_t>(j) * r.Sk;
    p.qplane = bh * r.sp + i;
    p.kplane = bh * r.sp + j;
  } else {
    p.flags = 0u;
    p.causal = a.causal;
    p.qrow = static_cast<size_t>(bh) * a.Tq;
    p.krow = static_cast<size_t>(bh) * a.Tk;
    p.mrow = static_cast<size_t>(bh / a.H) * a.Tk;
    p.qplane = p.kplane = bh;
  }
  return p;
}

// block (*, *, z)'s dropout seed: its pair's from the [sp, sp] grid, or
// the plain kernels' one seed (0 without one)
template <bool RING, typename T>
__device__ __forceinline__ uint32_t seed_of(const ArgsT<T>& a, const Ring& r, int z) {
  if constexpr (RING) {
    const uint32_t e = r.pair[z];
    return static_cast<uint32_t>(r.seeds[(e & 0xfffu) * r.sp + ((e >> 12) & 0xfffu)]);
  } else {
    return a.seed ? static_cast<uint32_t>(a.seed[0]) : 0u;
  }
}

// K1's merge weights for one row: the pair's partial (lse_p in the
// kernels' form, +1e30 for a row with no key, which is the merge's
// identity -1e30) merged into the carried (o_a, lse_a) as the reference's
// _merge_partial: lse_t = logaddexp2(lse_a, lse_p), o = o_a * wa + o_p *
// wp.  An identity partial leaves (o_a, lse_a) as they are, bit for bit.
// The first hop takes the partial alone (wa = 0; o_a is not read).
struct RingMerge {
  float wa, wp, lse;
};
__device__ __forceinline__ RingMerge ring_merge(float lse_a, float lse_p, bool first) {
  const float lp = lse_p > 1e29f ? kNegInf : lse_p;
  if (first) return RingMerge{0.0f, 1.0f, lp};
  const float mx = fmaxf(lse_a, lp), mn = fminf(lse_a, lp);
  const float lt = mx + log2f(1.0f + exp2f(mn - mx));
  return RingMerge{exp2f(lse_a - lt), exp2f(lp - lt), lt};
}

// the merged LSE as the backward kernels read it (the reference's
// _kernel_lse): the identity -1e30 back to the empty-row sentinel +1e30
__device__ __forceinline__ float kernel_lse(float lse) { return lse < -1e29f ? 1e30f : lse; }

}  // namespace flash
