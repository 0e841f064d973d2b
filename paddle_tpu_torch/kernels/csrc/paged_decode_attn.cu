// Paged decode attention for Hopper (sm_90a): one query token per decode
// slot against that slot's paged K/V blocks.  K4.
//
// Replaces the Pallas kernel paddle_tpu/kernels/attention.py:948
// _decode_attn_kernel (launched by _paged_attn_pallas through
// pl.pallas_call), both of its variants: float32 blocks, and int8 blocks
// dequantized as code * scale[block, head] / 127.
//
// What it computes, per slot s and head h (D = head_dim, bs = tokens per
// cache block, cl = context_lens[s]):
//   out[s, h] = softmax_t(q[s, h] . k[t, h] * sm_scale) @ v[t, h]
// over the positions t < cl, where position t lives in cache block
// block_tables[s, t / bs] at row t % bs.  Positions >= cl are masked, so
// the kernel never visits them, nor positions past the table (MB * bs).
// The division by the softmax mass is acc / max(l, 1e-30), as on the TPU.
// The int8 scales are not clamped by SCALE_EPS, exactly as the TPU
// kernel multiplies them in.  A slot with cl <= 0 (the engine never
// makes one: an idle slot attends at cl = 1) gets zeros.
//
// Design.  The TPU grid walked (slot, table block) in order and carried
// the online-softmax state m, l, acc in VMEM scratch from one grid step
// to the next.  Here:
//
// - A block (CTA) of 8 warps takes (head, slot, context split); its warps
//   take the split's tiles of positions in turn.  The cache is [N, bs, H,
//   D], so a (position, head) row is D contiguous elements.  The decode
//   shape (8 slots x 8 heads) gets 64 CTAs, where a CTA covering every
//   head would get 8; CTAs of 2, 4 or 8 heads, whose warps read the
//   neighbouring heads' rows of the same positions, were no faster at the
//   decode shape nor at a 4,096-token context, but for int8 at the long
//   context by 5% with 2 (the sweep is in PERF.md).
// - Wide loads.  A position's row is cut into 16-byte pieces (4 floats,
//   or 16 int8 codes, turned into floats in registers by a byte permute
//   and one add, then scaled), LP lanes a position and 32 / LP positions
//   a warp-wide load; a tile is kIters such loads (at D = 64 and one
//   split: 16 positions of float32, one cache block of 16, or 32 of
//   int8; half that at split tables, so two CTAs fit an SM's registers).
//   The dot products of a load's positions reduce over their LP lanes at
//   once.
// - The online softmax updates once a tile: the tile's maximum, one
//   rescale of l and acc, one exp a position.
// - Loads ahead.  q, the split's block-table entries (into shared
//   memory) and the context length load together before the loop, and a
//   warp issues the K, V (and int8 scales) loads of its next tile before
//   it computes the current one: two tiles in flight a warp, in
//   registers (volatile loads, so the compiler keeps them where they
//   are).
// - Split contexts (flash-decoding).  When the table is long the host
//   cuts it into `splits` chunks of whole cache blocks (two CTAs an SM,
//   each split at least 64 KB of K a CTA: 256 positions of float32 at
//   D = 64, 1,024 of int8, for one head); each split writes its
//   unnormalized (m, l, acc), and a second launch merges a slot's splits
//   in the fixed order 0, 1, 2, ..., so a rerun or a launch on another
//   stream gives the same bits.  A short table takes one split: no
//   partials and no second launch.
//
// Bound.  The work reads the K and V rows of sum(cl) tokens once
// (sum(cl) * H * D * 4 bytes each in float32, 1 byte in int8, plus one
// scale per block and head) and does 4 * sum(cl) * H * D float32
// operations: about 1 operation per byte, far below the card's ratio of
// operations to bytes, so it is bound by memory bandwidth (3.35 TB/s on
// an H100 SXM).  At the decode shape that bound is about a microsecond,
// below a launch's own cost; the times are in PERF.md.
//
// Entry points: paged_decode_attn() (one split), paged_decode_attn_splits()
// (how many splits a shape takes) and paged_decode_attn_split() (the split
// form, with the caller's partials): plain C functions called through
// ctypes on PyTorch's current stream.  They launch and return a
// cudaError_t; they never synchronise and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 256;            // head_dim the kernel takes
constexpr int kMaxTableChunk = 1024;    // table entries a CTA stages
constexpr int kMinSplitBytes = 65536;   // K bytes a CTA's split covers at least
constexpr int kMaxSplits = 128;         // splits of a table
constexpr float kNegInf = -1e30f;
constexpr float kInvQmax = 1.0f / 127.0f;

struct Params {
  const float* q;             // [S, H, D]
  const void* k_cache;        // [N, bs, H, D]
  const void* v_cache;
  const float* k_scale;       // [N, H] (int8)
  const float* v_scale;
  const int32_t* block_tables;  // [S, MB]
  const int32_t* context_lens;  // [S]
  float* out;                 // [S, H, D]
  float* part;                // [splits, S, H, D] acc, then [splits, S, H] m and l
  int S, H, D, bs, MB;
  int splits, chunk_blocks;   // splits of the table, cache blocks a split
  float sm_scale;
};

// VEC elements of T as one load, and element e of it as a float
template <typename T, int VEC>
struct Piece;

// The 16-byte loads are volatile asm: the compiler issues them where the
// code says, a tile ahead of their use, instead of sinking them next to it
template <>
struct Piece<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
  }
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float get(int e) const {
    return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
  }
};

template <>
struct Piece<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ void zero() { v = 0.f; }
  __device__ __forceinline__ float get(int) const { return v; }
};

// Signed int8 code i (0..3) of a word whose bytes were biased by
// x ^ 0x80808080 (code + 128), as a float: the byte becomes the low
// mantissa of 2^23 (one byte permute) and one add takes 2^23 + 128 off,
// exactly; a quarter-rate integer-to-float conversion a code otherwise
__device__ __forceinline__ float code_of(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | i)) - 8388736.0f;
}

template <>
struct Piece<int8_t, 16> {
  int4 v;
  __device__ __forceinline__ void load(const int8_t* p) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
  }
  __device__ __forceinline__ void zero() { v = make_int4(0, 0, 0, 0); }
  __device__ __forceinline__ float get(int e) const {
    const int w = e < 4 ? v.x : (e < 8 ? v.y : (e < 12 ? v.z : v.w));
    return code_of(static_cast<uint32_t>(w) ^ 0x80808080u, e & 3);
  }
};

template <>
struct Piece<int8_t, 4> {
  int v;
  __device__ __forceinline__ void load(const int8_t* p) { v = __ldg(reinterpret_cast<const int*>(p)); }
  __device__ __forceinline__ void zero() { v = 0; }
  __device__ __forceinline__ float get(int e) const {
    return code_of(static_cast<uint32_t>(v) ^ 0x80808080u, e);
  }
};

template <>
struct Piece<int8_t, 1> {
  int8_t v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = static_cast<int8_t>(__ldg(reinterpret_cast<const signed char*>(p)));
  }
  __device__ __forceinline__ void zero() { v = 0; }
  __device__ __forceinline__ float get(int) const { return static_cast<float>(v); }
};

// an int8 block's scale, issued where the code says (as the pieces)
__device__ __forceinline__ float load_scale(const float* p) {
  float x;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

// A tile's loads for one lane: kIters positions x CPL pieces of K and V,
// and the int8 scales of those positions
template <typename T, int VEC, int CPL, int kIters, bool kQuant>
struct Tile {
  Piece<T, VEC> k[kIters][CPL], v[kIters][CPL];
  float ks[kIters], vs[kIters];
};

// One CTA: head blockIdx.x, slot blockIdx.y, split blockIdx.z.  A lane
// holds CPL pieces of VEC elements of a row (pieces lc, lc + LP, ...),
// LP = 32 / PPW lanes a position, PPW positions a warp-wide load.
template <typename T, int VEC, int CPL, int kIters, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_decode_attn_kernel(const Params p) {
  constexpr int kVals = CPL * VEC;
  const int h = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = p.H, D = p.D, bs = p.bs;
  const int pieces = (D + VEC - 1) / VEC;
  int LP = 1;
  while (LP * CPL < pieces) LP <<= 1;     // a power of two, <= 32
  const int PPW = 32 / LP;
  const int pg = lane / LP, lc = lane % LP;
  const int TP = kIters * PPW;              // positions a tile

  // q, this split's block-table entries and the context length load at
  // once (none waits for another)
  const T* kc = static_cast<const T*>(p.k_cache);
  const T* vc = static_cast<const T*>(p.v_cache);
  float qv[kVals], acc[kVals];
  const float* qp = p.q + (static_cast<size_t>(s) * H + h) * D;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = (lc + c * LP) * VEC + e;
      qv[c * VEC + e] = d < D ? qp[d] * p.sm_scale : 0.0f;
      acc[c * VEC + e] = 0.0f;
    }
  }
  __shared__ int table[kMaxTableChunk];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ __align__(16) float sm_acc[kWarps][kMaxDim];
  const int blk_lo = z * p.chunk_blocks;
  const int32_t* bt = p.block_tables + static_cast<size_t>(s) * p.MB + blk_lo;
  for (int i = threadIdx.x; i < min(p.chunk_blocks, p.MB - blk_lo); i += kThreads) table[i] = bt[i];
  const int cl = p.context_lens[s];
  __syncthreads();
  const int n_tok = max(0, min(cl, p.MB * bs));
  const int pos_lo = blk_lo * bs;
  const int pos_hi = min(n_tok, (blk_lo + p.chunk_blocks) * bs);
  const int n_pos = max(0, pos_hi - pos_lo);
  float m = kNegInf, l = 0.0f;

  const int n_tiles = (n_pos + TP - 1) / TP;
  auto issue = [&](int tile, Tile<T, VEC, CPL, kIters, kQuant>& b) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int t = pos_lo + tile * TP + it * PPW + pg;
      const bool ok = t < pos_hi;
      const int j = ok ? t / bs : blk_lo;
      const int blk = table[j - blk_lo];
      const size_t row = ((static_cast<size_t>(blk) * bs + (t - j * bs)) * H + h) * D;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d0 = (lc + c * LP) * VEC;
        if (ok && d0 < D) {
          b.k[it][c].load(kc + row + d0);
          b.v[it][c].load(vc + row + d0);
        } else {
          b.k[it][c].zero();
          b.v[it][c].zero();
        }
      }
      if (kQuant) {
        b.ks[it] = b.vs[it] = 0.0f;
        if (ok) {
          b.ks[it] = load_scale(p.k_scale + static_cast<size_t>(blk) * H + h);
          b.vs[it] = load_scale(p.v_scale + static_cast<size_t>(blk) * H + h);
        }
      }
    }
  };

  // one tile's scores, then the online-softmax update with its values
  auto consume = [&](int tile, const Tile<T, VEC, CPL, kIters, kQuant>& b) {
    float sc[kIters];
    float tmax = kNegInf;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[c * VEC + e], b.k[it][c].get(e), dot);
      }
      for (int o = LP >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (kQuant) dot *= b.ks[it] * kInvQmax;
      const bool ok = pos_lo + tile * TP + it * PPW + pg < pos_hi;
      sc[it] = ok ? dot : kNegInf;
      tmax = fmaxf(tmax, sc[it]);
    }
    for (int o = 16; o >= LP; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kVals; ++i) acc[i] *= alpha;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const float pr = expf(sc[it] - m_new);  // 0 past the split's end
      l += pr;
      const float pv = kQuant ? pr * (b.vs[it] * kInvQmax) : pr;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[c * VEC + e] = fmaf(pv, b.v[it][c].get(e), acc[c * VEC + e]);
      }
    }
    m = m_new;
  };

  // a warp's tiles are warp, warp + kWarps, ...; the next one's loads are
  // in flight while the current one is computed (two buffers, unrolled so
  // that each stays in registers)
  Tile<T, VEC, CPL, kIters, kQuant> b0, b1;
  if (warp < n_tiles) issue(warp, b0);
  for (int tile = warp; tile < n_tiles; tile += 2 * kWarps) {
    if (tile + kWarps < n_tiles) issue(tile + kWarps, b1);
    consume(tile, b0);
    if (tile + kWarps >= n_tiles) break;
    if (tile + 2 * kWarps < n_tiles) issue(tile + 2 * kWarps, b0);
    consume(tile + kWarps, b1);
  }

  // a warp's position groups hold partial sums of l and acc (m is the
  // warp's): add them, then merge the warps' states
  for (int o = 16; o >= LP; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < kVals; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (pg == 0) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = (lc + c * LP) * VEC + e;
        if (d < D) sm_acc[warp][d] = acc[c * VEC + e];
      }
    }
  }
  __syncthreads();

  // column d: the warps 0, 1, ... in that order
  const size_t SH = static_cast<size_t>(p.S) * H;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float m_all = kNegInf;
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
    float l_all = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = expf(sm_m[w] - m_all);
      l_all += sm_l[w] * wgt;
      a += sm_acc[w][d] * wgt;
    }
    const size_t sh = static_cast<size_t>(s) * H + h;
    if (p.splits == 1) {
      p.out[sh * D + d] = a / fmaxf(l_all, 1e-30f);
    } else {
      p.part[(static_cast<size_t>(z) * SH + sh) * D + d] = a;
      if (d == 0) {
        float* pm = p.part + static_cast<size_t>(p.splits) * SH * D;
        pm[z * SH + sh] = m_all;
        pm[(p.splits + z) * SH + sh] = l_all;
      }
    }
  }
}

// out[s, h] from the splits' partial states, merged in split order: one
// CTA a (slot, head).  The splits' m and l are read at once into shared
// memory, their weights exp(m_z - max m) taken once, then each column sums
// its splits in order.
__global__ void __launch_bounds__(kThreads) paged_decode_combine(const Params p) {
  __shared__ float sm_m[kMaxSplits], sm_l[kMaxSplits], sm_w[kMaxSplits];
  const int h = blockIdx.x, s = blockIdx.y, n = p.splits;
  const size_t SH = static_cast<size_t>(p.S) * p.H;
  const size_t sh = static_cast<size_t>(s) * p.H + h;
  const float* pm = p.part + static_cast<size_t>(n) * SH * p.D;
  const float* pl = pm + static_cast<size_t>(n) * SH;
  for (int z = threadIdx.x; z < n; z += kThreads) {
    sm_m[z] = pm[z * SH + sh];
    sm_l[z] = pl[z * SH + sh];
  }
  __syncthreads();
  float m_all = kNegInf;
  for (int z = 0; z < n; ++z) m_all = fmaxf(m_all, sm_m[z]);
  for (int z = threadIdx.x; z < n; z += kThreads) sm_w[z] = expf(sm_m[z] - m_all);
  __syncthreads();
  float l_all = 0.0f;
  for (int z = 0; z < n; ++z) l_all += sm_l[z] * sm_w[z];
  const float denom = fmaxf(l_all, 1e-30f);
  for (int d = threadIdx.x; d < p.D; d += kThreads) {
    float a = 0.0f;
#pragma unroll 8
    for (int z = 0; z < n; ++z) a += p.part[(z * SH + sh) * p.D + d] * sm_w[z];
    p.out[sh * p.D + d] = a / denom;
  }
}

// kIters: 8 KB of K and V a warp a tile at one split (4 KB for int8's
// 16-code pieces, whose q and acc take 16 registers each), half that at
// split tables, so that two CTAs of two tiles a warp fit an SM's registers
template <typename T, int VEC, int CPL, bool kQuant>
cudaError_t launch_one(const Params& p, cudaStream_t st) {
  constexpr int kIters = CPL >= 8 ? 1 : (VEC == 16 ? 4 : 8 / CPL);
  const dim3 grid(p.H, p.S, p.splits);
  if constexpr (kIters >= 4) {
    if (p.splits > 1) {
      paged_decode_attn_kernel<T, VEC, CPL, kIters / 2, kQuant><<<grid, kThreads, 0, st>>>(p);
      return cudaGetLastError();
    }
  }
  paged_decode_attn_kernel<T, VEC, CPL, kIters, kQuant><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// the piece width (16 bytes where the rows and the caches' addresses
// allow it) and the pieces a lane holds, from D and the element type
cudaError_t launch_attn(const Params& p, bool quantized, cudaStream_t st) {
  const int D = p.D;
  const uintptr_t base = reinterpret_cast<uintptr_t>(p.k_cache) | reinterpret_cast<uintptr_t>(p.v_cache);
  if (!quantized) {
    if (D % 4 == 0 && base % 16 == 0) {
      return D <= 128 ? launch_one<float, 4, 1, false>(p, st) : launch_one<float, 4, 2, false>(p, st);
    }
    return launch_one<float, 1, 8, false>(p, st);
  }
  if (D % 16 == 0 && base % 16 == 0) return launch_one<int8_t, 16, 1, true>(p, st);
  if (D % 4 == 0 && D <= 128 && base % 4 == 0) return launch_one<int8_t, 4, 1, true>(p, st);
  return launch_one<int8_t, 1, 8, true>(p, st);
}

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  return sms;
}

// Bytes of K a position holds for one head
long row_bytes(int D, int quantized) { return static_cast<long>(D) * (quantized ? 1 : 4); }

// One split when a head's K rows take at most kMinSplitBytes; otherwise
// two CTAs an SM (a CTA of 8 warps holds ~190 registers a thread, so one
// is resident an SM: two waves), each split at least kMinSplitBytes of K
int split_count(int S, int H, int D, int bs, int MB, int quantized, int device) {
  const int need = (MB + kMaxTableChunk - 1) / kMaxTableChunk;  // table chunks a CTA can stage
  const long tokens = static_cast<long>(MB) * bs;
  if (tokens * row_bytes(D, quantized) <= kMinSplitBytes) return need;
  const long min_tokens = (kMinSplitBytes + row_bytes(D, quantized) - 1) / row_bytes(D, quantized);
  const long ctas = static_cast<long>(S) * H;
  const long fill = (2L * sm_count(device) + ctas - 1) / ctas;
  const long by_len = tokens / min_tokens;
  long n = fill < by_len ? fill : by_len;
  if (n > kMaxSplits) n = kMaxSplits;
  if (n < need) n = need;
  if (n > MB) n = MB;
  return static_cast<int>(n < 1 ? 1 : n);
}

int run(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
        const void* v_scale, const void* block_tables, const void* context_lens, void* out,
        void* partials, int S, int H, int D, int bs, int MB, int quantized, float sm_scale,
        int splits, int device, void* stream) {
  if (S <= 0 || S > 65535 || H <= 0 || D <= 0 || D > kMaxDim ||
      bs <= 0 || MB <= 0 || splits < 1 || splits > kMaxSplits ||
      (MB + splits - 1) / splits > kMaxTableChunk || (splits > 1 && partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.block_tables = static_cast<const int32_t*>(block_tables);
  p.context_lens = static_cast<const int32_t*>(context_lens);
  p.out = static_cast<float*>(out);
  p.part = static_cast<float*>(partials);
  p.S = S; p.H = H; p.D = D; p.bs = bs; p.MB = MB;
  p.splits = splits;
  p.chunk_blocks = (MB + splits - 1) / splits;
  p.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_attn(p, quantized != 0, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  paged_decode_combine<<<dim3(H, S), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [S, H, D] f32; k_cache/v_cache [N, bs, H, D] f32 (quantized == 0) or
// int8 (quantized != 0, with k_scale/v_scale [N, H] f32); block_tables
// [S, MB] i32; context_lens [S] i32; out [S, H, D] f32.  All contiguous
// and on `device`; the launch goes to `stream`.  One split (MB must be at
// most 1024).  Returns a cudaError_t.
int paged_decode_attn(const void* q, const void* k_cache, const void* v_cache,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* context_lens,
                      void* out, int S, int H, int D, int bs, int MB,
                      int quantized, float sm_scale, int device,
                      void* stream) {
  return run(q, k_cache, v_cache, k_scale, v_scale, block_tables, context_lens, out, nullptr,
             S, H, D, bs, MB, quantized, sm_scale, 1, device, stream);
}

// The splits paged_decode_attn_split() takes for this shape on `device`:
// 1 when a head's K rows take at most 64 KB (256 positions of float32 at
// D = 64, 1,024 of int8); otherwise two CTAs an SM, each split at least
// 64 KB of K.
int paged_decode_attn_splits(int S, int H, int D, int bs, int MB, int quantized, int device) {
  if (S <= 0 || H <= 0 || D <= 0 || bs <= 0 || MB <= 0) return 1;
  return split_count(S, H, D, bs, MB, quantized, device);
}

// As paged_decode_attn(), with the table cut into `splits` chunks of whole
// cache blocks; partials: splits * S * H * (D + 2) floats of device memory
// (unused, and may be null, when splits == 1).  Two launches when splits >
// 1.
int paged_decode_attn_split(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale,
                            const void* block_tables, const void* context_lens,
                            void* out, void* partials, int S, int H, int D, int bs,
                            int MB, int quantized, float sm_scale, int splits, int device,
                            void* stream) {
  return run(q, k_cache, v_cache, k_scale, v_scale, block_tables, context_lens, out, partials,
             S, H, D, bs, MB, quantized, sm_scale, splits, device, stream);
}

const char* paged_decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
