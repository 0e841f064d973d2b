// Flash-attention forward for Hopper (sm_90a), float32: K1.
//
// Replaces the Pallas kernel paddle_tpu/kernels/attention.py:226
// _flash_fwd_kernel (launched by _pallas_fwd through pl.pallas_call):
// online-softmax attention of q [B, H, Tq, D] over k, v [B, H, Tk, D]
// with an optional [B, Tk] key mask, causal masking (q_pos >= k_pos in
// absolute positions), and in-kernel attention-probability dropout.  It
// writes out [B, H, Tq, D] and the base-2 log-sum-exp lse [B*H, Tq]
// (+1e30 where the softmax mass is 0) that the backward kernels read.
// The conventions shared with the backward are in flash_attn_common.cuh.
//
// Design.  The TPU grid walked (batch*head, q-block, k-block) in order,
// carrying m, l and acc in VMEM scratch across k-blocks.  Here one CUDA
// block takes 64 query rows of one (batch, head), one warp per 16 rows,
// and walks the keys 32 at a time.  Both products run on the tensor cores
// in split TF32 (tf32x3.cuh: three mma.sync m16n8k8 products a term,
// float32-equivalent): S = Q . K^T for the warp's 16 x 32 scores, kept in
// registers as mma fragments, and O += P . V, whose A operand is the score
// fragment itself (its keys taken in the order 0, 2, 4, 6, 1, 3, 5, 7 of
// each 8, with V's rows read in the same order, so no shuffle is needed).
// The online softmax runs on the fragments: each thread holds two rows'
// values, a row's max and mass are reduced over the 4 threads that share
// it.  Q sits in shared memory, pre-scaled into exp2 units; K/V tiles are
// double-buffered with cp.async, together with each key's mask bit and
// its part of the dropout hash.  The dropout bit of an element comes from
// its own (row, key), as the reference's tile hash defines it.  A warp
// skips the key tiles past its rows' causal frontier (they add exactly
// nothing), and the block stops at the last row's frontier.
//
// Bound.  For B=32, H=8, T=256, D=64 the work is 4 * B*H*Tq*Tk*D = 4.3
// GFLOP of float32 (two products of Tq x Tk x D), over about 67 MB of
// q, k, v, mask and out: 64 operations per byte.  Split TF32 runs three
// products a term on the tensor cores, a third of their TF32 rate (495
// TFLOP/s on an H100 SXM): 165 TFLOP/s, so about 0.026 ms, bound by the
// operations (the bytes take 0.020 ms).  What is left on the CUDA cores
// is the split of each K/V element per warp, the exp2 and the dropout
// hash of each score, and the rescale of O once a tile.
//
// Ring attention (flash_attn_common.cuh): flash_attn_fwd_ring() runs one
// hop's pairs as one launch of the same kernel instantiated for the ring,
// whose blocks read their pair's shards as rows of the whole tensors and
// merge the pair's output into float32 accumulators (the reference's
// log2-mass merge) where the plain kernel writes it.
//
// Entry points: flash_attn_fwd() and flash_attn_fwd_ring(), plain C
// functions called through ctypes on PyTorch's current stream.  They
// launch and return cudaGetLastError(); they never synchronise and
// allocate nothing.

#include "flash_attn_common.cuh"
#include "tf32x3.cuh"

namespace {

using flash::Args;
using flash::kNegInf;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::mma3;

constexpr int kRows = 64;     // query rows a block
constexpr int kThreads = 128; // 4 warps of 16 rows
constexpr int kKeys = 32;     // keys a tile

template <int DP>
constexpr int smem_floats() {
  // Q [64][DP + 4], K and V [2][32][DP + 4], key info [2][3][32]
  return kRows * (DP + 4) + 4 * kKeys * (DP + 4) + 2 * 3 * kKeys;
}

// the dropout multiplier of one element: flash::drop_mult with the row's
// and the key's parts of the hash computed once
__device__ __forceinline__ float drop_of(uint32_t row_x, uint32_t row_salt, uint32_t key_x,
                                         uint32_t key_salt, float rate, float keep) {
  uint32_t x = row_x ^ key_x;
  x ^= row_salt + key_salt;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  return u >= rate ? keep : 0.0f;
}

template <int DP, bool VEC, bool RING>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Args a, const __grid_constant__ flash::Ring r) {
  constexpr int LD = DP + 4;
  constexpr int NT = kKeys / 8;  // 8-key column tiles of S
  constexpr int DT = DP / 8;     // 8-wide column tiles of O
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                               // [64][LD]
  float* Ks = Qs + kRows * LD;                    // [2][32][LD]
  float* Vs = Ks + 2 * kKeys * LD;                // [2][32][LD]
  uint32_t* info = reinterpret_cast<uint32_t*>(Vs + 2 * kKeys * LD);  // [2][3][32]

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  // a ring launch's pair (the plain kernel keeps its own expressions)
  const flash::PairAt pc = flash::pair_at<RING>(a, r, bh, blockIdx.z);
  const int causal = RING ? pc.causal : a.causal;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const size_t qrow = RING ? pc.qrow : static_cast<size_t>(bh) * Tq;
  const float* kbase = a.k + (RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D);
  const float* vbase = a.v + (RING ? pc.krow * D : static_cast<size_t>(bh) * Tk * D);
  const size_t mrow = RING ? pc.mrow : static_cast<size_t>(b) * Tk;

  for (int i = tid; i < kRows * DP; i += kThreads) {
    const int rr = i / DP, d = i - rr * DP;
    const int row = row0 + rr;
    Qs[rr * LD + d] = (row < Tq && d < D)
                          ? a.q[(qrow + row) * D + d] * a.scale_log2
                          : 0.0f;
  }

  // this thread's two rows (fragment rows g and g + 8 of its warp)
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  int kend[2];
  uint32_t row_x[2], row_salt[2];
  const uint32_t seed = flash::seed_of<RING>(a, r, blockIdx.z);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    kend[h] = row < Tq ? flash::key_end(row, Tk, causal, a.bq, a.bk) : 0;
    const uint32_t qi = static_cast<uint32_t>(row / a.bq);
    row_x[h] = (static_cast<uint32_t>(row) - qi * a.bq) * 0x9E3779B1u;
    row_salt[h] = seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du + qi * 0x27D4EB2Fu;
  }
  // keys past the frontier of the warp's (and the block's) last row weigh nothing
  const int wlast = min(row0 + warp * 16 + 15, Tq - 1);
  const int wkend = row0 + warp * 16 < Tq ? flash::key_end(wlast, Tk, causal, a.bq, a.bk) : 0;
  const int last_row = min(row0 + kRows, Tq) - 1;
  const int kend_blk = min(flash::key_end(last_row, Tk, causal, a.bq, a.bk), Tk);
  const int ntiles = (kend_blk + kKeys - 1) / kKeys;

  auto load = [&](int tile, int st) {
    const int k0 = tile * kKeys;
    float* kd = Ks + st * kKeys * LD;
    float* vd = Vs + st * kKeys * LD;
    if (VEC) {  // D % 4 == 0
      for (int i = tid; i < kKeys * DP / 4; i += kThreads) {
        const int j = i / (DP / 4), c = (i % (DP / 4)) * 4;
        const bool ok = k0 + j < Tk && c < D;
        const size_t off = static_cast<size_t>(k0 + j) * D + c;
        cp_async16(kd + j * LD + c, ok ? kbase + off : kbase, ok ? 16 : 0);
        cp_async16(vd + j * LD + c, ok ? vbase + off : vbase, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kKeys * DP; i += kThreads) {
        const int j = i / DP, c = i - j * DP;
        const bool ok = k0 + j < Tk && c < D;
        const size_t off = static_cast<size_t>(k0 + j) * D + c;
        cp_async4(kd + j * LD + c, ok ? kbase + off : kbase, ok ? 4 : 0);
        cp_async4(vd + j * LD + c, ok ? vbase + off : vbase, ok ? 4 : 0);
      }
    }
    for (int j = tid; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      uint32_t* inf = info + st * 3 * kKeys;
      inf[j] = key < Tk && (a.mask == nullptr || a.mask[mrow + key] > 0.0f);
      const uint32_t kb = static_cast<uint32_t>(key / a.bk);
      inf[kKeys + j] = (static_cast<uint32_t>(key) - kb * a.bk) * 0x85EBCA77u;
      inf[2 * kKeys + j] = kb * 0x165667B1u;
    }
  };

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's part of each row's mass

  if (ntiles > 0) load(0, 0);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = i * kKeys;
    if (k0 < wkend) {
      const float* Kt = Ks + (i & 1) * kKeys * LD;
      const float* Vt = Vs + (i & 1) * kKeys * LD;
      const uint32_t* inf = info + (i & 1) * 3 * kKeys;

      // S = Q . K^T, 16 x 32 a warp
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < DP; kd += 8) {
        if (kd >= D) break;
        const float* qp = Qs + (warp * 16 + g) * LD + kd + q;
        FragA fa;
        fa.set(qp[0], qp[8 * LD], qp[4], qp[8 * LD + 4]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* kp = Kt + (nt * 8 + g) * LD + kd + q;
          FragB fb;
          fb.set(kp[0], kp[4]);
          mma3(s[nt], fa, fb);
        }
      }

      // masks: a masked key scores the finite -1e30, a key the row does
      // not visit -inf (no weight, and the max is left alone)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int jj = nt * 8 + 2 * q + (e & 1);
          const int key = k0 + jj;
          const bool keep = inf[jj] != 0u && (!causal || key <= rows[h]);
          const float sc = keep ? s[nt][e] : kNegInf;
          s[nt][e] = (key < kend[h] && key < Tk) ? sc : -INFINITY;
          mx[h] = fmaxf(mx[h], s[nt][e]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
      l[0] *= alpha[0];
      l[1] *= alpha[1];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2f(s[nt][e] - mx[h]);
          l[h] += p;  // the mass sums probabilities before dropout
          if (a.rate > 0.0f) {
            const int jj = nt * 8 + 2 * q + (e & 1);
            p *= drop_of(row_x[h], row_salt[h], inf[kKeys + jj], inf[2 * kKeys + jj], a.rate,
                         a.keep_scale);
          }
          s[nt][e] = p;
        }
      }
      m[0] = mx[0];
      m[1] = mx[1];

      // O += P . V: the score fragment is the A operand, its 8 keys in the
      // order 2q, 2q + 1 -> k = q, q + 4; V's rows follow the same order
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        FragA pa;
        pa.set(s[nt][0], s[nt][2], s[nt][1], s[nt][3]);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          if (dt * 8 >= D) break;
          const float* vp = Vt + (nt * 8 + 2 * q) * LD + dt * 8 + g;
          FragB fb;
          fb.set(vp[0], vp[LD]);
          mma3(o[dt], pa, fb);
        }
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  // ring: the carried lse of each row, read by the row's four threads
  // before its first thread writes it
  float lse_a[2] = {0.0f, 0.0f};
  const bool first = (pc.flags & flash::kRingFirst) != 0u;
  const bool last = (pc.flags & flash::kRingLastQ) != 0u;
  if constexpr (RING) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!first && rows[h] < Tq) lse_a[h] = r.acc2[qrow + rows[h]];
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = rows[h];
    if (row >= Tq) continue;
    // the reference's zero-padded keys in [Tk, kend) score -1e30: they add
    // mass 1 each to a row whose every visited key is masked, else 0
    if (m[h] == kNegInf && kend[h] > Tk) l[h] += static_cast<float>(kend[h] - Tk);
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
    float* op = a.out + (qrow + row) * D;
    if constexpr (RING) {
      // merge into the accumulators (float32 output: o_acc may be out)
      const flash::RingMerge w = flash::ring_merge(lse_a[h], flash::lse_of(m[h], l[h]), first);
      float* ap = r.acc + (qrow + row) * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = dt * 8 + 2 * q + e;
          if (d >= D) continue;
          const float x = o[dt][2 * h + e] * inv;
          const float y = first ? x : ap[d] * w.wa + x * w.wp;
          (last ? op : ap)[d] = y;
        }
      }
      if (q == 0) r.acc2[qrow + row] = last ? flash::kernel_lse(w.lse) : w.lse;
      continue;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * q;
      if (d < D) op[d] = o[dt][2 * h] * inv;
      if (d + 1 < D) op[d + 1] = o[dt][2 * h + 1] * inv;
    }
    if (q == 0) a.out_lse[static_cast<size_t>(bh) * Tq + row] = flash::lse_of(m[h], l[h]);
  }
}

template <int DP, bool VEC, bool RING>
cudaError_t launch(const Args& a, const flash::Ring& r, cudaStream_t st) {
  constexpr size_t smem = sizeof(float) * smem_floats<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP, VEC, RING>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // a ring launch: every pair's blocks, the pair in z
  const dim3 grid(a.B * a.H, (a.Tq + kRows - 1) / kRows, RING ? r.n : 1);
  flash_fwd_kernel<DP, VEC, RING><<<grid, kThreads, smem, st>>>(a, r);
  return cudaGetLastError();
}

template <int DP, bool RING>
cudaError_t launch_dp(const Args& a, const flash::Ring& r, cudaStream_t st) {
  return a.D % 4 == 0 ? launch<DP, true, RING>(a, r, st) : launch<DP, false, RING>(a, r, st);
}

template <bool RING>
cudaError_t launch_d(const Args& a, const flash::Ring& r, cudaStream_t st) {
  if (a.D <= 32) return launch_dp<32, RING>(a, r, st);
  if (a.D <= 64) return launch_dp<64, RING>(a, r, st);
  return launch_dp<128, RING>(a, r, st);
}

}  // namespace

extern "C" {

// q [B, H, Tq, D], k/v [B, H, Tk, D], out [B, H, Tq, D] float32; mask
// [B, Tk] float32 or null; seed [1] int32 or null; lse [B*H, Tq] float32.
// All contiguous and on `device`; the launch goes to `stream`.  Returns a
// cudaError_t.
int flash_attn_fwd(const void* q, const void* k, const void* v,
                   const void* mask, const void* seed, void* out, void* lse,
                   int B, int H, int Tq, int Tk, int D, int causal,
                   float scale_log2, float rate, float keep_scale, int bq,
                   int bk, int device, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
      bq <= 0 || bk <= 0 || (Tq + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const float*>(mask);
  a.seed = static_cast<const int32_t*>(seed);
  a.out = static_cast<float*>(out);
  a.out_lse = static_cast<float*>(lse);
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D;
  a.causal = causal;
  a.scale_log2 = scale_log2;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.bq = bq; a.bk = bk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_d<false>(a, flash::Ring{}, st));
}

// Ring attention's hop launch (flash_attn_common.cuh): q [B, H, sp * Sq,
// D], k/v [B, H, sp * Sk, D] float32 whole; mask [B, sp * Sk] float32 or
// null; seeds [sp, sp] int32; the n_pairs entries of `pairs` (host
// memory, i | j << 12 | flags << 24); o_acc [B, H, sp * Sq, D] and
// lse_acc [B*H, sp * Sq] float32 accumulators; out [B, H, sp * Sq, D]
// (may be o_acc).  bq, bk are the pairs' logical tiles.  All contiguous
// and on `device`; the launch goes to `stream`.  Returns a cudaError_t.
int flash_attn_fwd_ring(const void* q, const void* k, const void* v, const void* mask,
                        const void* seeds, void* o_acc, void* lse_acc, void* out, int B, int H,
                        int sp, int Sq, int Sk, int D, float scale_log2, float rate,
                        float keep_scale, int bq, int bk, int n_pairs, const uint32_t* pairs,
                        int device, void* stream) {
  if (B <= 0 || H <= 0 || sp <= 0 || sp >= 4096 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128 ||
      bq <= 0 || bk <= 0 || n_pairs <= 0 || n_pairs > flash::kRingMaxPairs ||
      (Sq + kRows - 1) / kRows > 65535 || seeds == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<float*>(out);
  a.B = B; a.H = H; a.Tq = Sq; a.Tk = Sk; a.D = D;
  a.scale_log2 = scale_log2;
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.bq = bq; a.bk = bk;
  flash::Ring r{};
  r.n = n_pairs;
  r.sp = sp;
  r.Sq = Sq;
  r.Sk = Sk;
  r.seeds = static_cast<const int32_t*>(seeds);
  r.acc = static_cast<float*>(o_acc);
  r.acc2 = static_cast<float*>(lse_acc);
  for (int i = 0; i < n_pairs; ++i) r.pair[i] = pairs[i];
  return static_cast<int>(launch_d<true>(a, r, static_cast<cudaStream_t>(stream)));
}

const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
