// Flash-attention forward for Hopper (sm_90a), bfloat16: K1's bfloat16
// mode.
//
// Replaces the Pallas kernel paddle_tpu/kernels/attention.py:226
// _flash_fwd_kernel (launched by _pallas_fwd through pl.pallas_call) on
// bfloat16 q, k, v [B, H, T, D], the dtype its products run in on the
// TPU ("the dot runs in the INPUT dtype", attention.py:141-143).  It
// computes what flash_attn_fwd.cu computes in float32 (the same masks,
// causal tiles of the reference's logical tiling, dropout bits and +1e30
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
// and writes out = O / l in bfloat16 and the LSE in float32.  Every
// product is bfloat16 x bfloat16 with a float32 sum, which is exactly
// mma.sync m16n8k16 bf16 -> f32 (bf16_mma.cuh).  The reference rounds p
// against the running max of its own logical k-tile (128 to 1,024
// keys); this kernel against the max of its 64-key tiles, so a p can
// round to the neighbouring bfloat16 and the output differ by an ulp.
//
// Design.  One block takes 64 query rows of one (batch, head), one warp
// per 16 rows, and walks the keys 64 at a time.  Q, pre-scaled and
// rounded, sits in shared memory; K and V tiles are double-buffered with
// cp.async, with each key's mask bit and its part of the dropout hash.
// A warp computes its 16 x 64 scores with mma.sync, fragments read by
// ldmatrix; the online softmax runs on the C fragments (each thread
// holds two rows' values, reduced over the 4 threads of a row); the
// fragments, packed to bfloat16, are the A operand of P . V directly
// (the C -> A identity), V's B fragments read by ldmatrix.trans.  Rows
// of shared memory are padded by 16 bytes, so no ldmatrix conflicts.
// Head dims up to 128 are zero-padded to 32, 64 or 128.  A warp skips
// the key tiles past its rows' causal frontier, and the block stops at
// its last row's.  wgmma and TMA are later work.
//
// Bound.  For B=32, H=8, T=256, D=64 the work is 4 * B*H*Tq*Tk*D = 4.3
// GFLOP (two products), 4.4 us at the H100's 989 TFLOP/s dense bf16;
// the bytes, q, k, v and out in bfloat16 plus the mask and the LSE,
// are about 34 MB, 10.1 us at 3.35 TB/s: bound by the bytes.  At
// B=4, T=8192, causal, the operations (275 GFLOP with the causal half)
// bound it: 0.278 ms.
//
// Entry point: flash_attn_fwd_bf16(), a plain C function called through
// ctypes on PyTorch's current stream, with flash_attn_fwd()'s
// arguments.  It launches and returns cudaGetLastError(); it never
// synchronises and allocates nothing.

#include "bf16_mma.cuh"
#include "flash_attn_common.cuh"

namespace {

using bf16mma::bf16;
using flash::kNegInf;
using Args = flash::ArgsT<bf16>;

constexpr int kRows = 64;      // query rows a block
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kKeys = 64;      // keys a tile

template <int DP>
constexpr size_t smem_bytes() {
  // Q [64][DP + 8], K and V [2][64][DP + 8], key info [2][3][64]
  return sizeof(bf16) * (kRows + 4 * kKeys) * (DP + 8) + sizeof(uint32_t) * 2 * 3 * kKeys;
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int NT = kKeys / 8;  // 8-key column tiles of S
  constexpr int DT = DP / 8;     // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD], pre-scaled
  bf16* Ks = Qs + kRows * LD;                    // [2][64][LD]
  bf16* Vs = Ks + 2 * kKeys * LD;                // [2][64][LD]
  uint32_t* info = reinterpret_cast<uint32_t*>(Vs + 2 * kKeys * LD);  // [2][3][64]

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const bf16* kbase = a.k + static_cast<size_t>(bh) * Tk * D;
  const bf16* vbase = a.v + static_cast<size_t>(bh) * Tk * D;
  // the softmax mass sums the rounded p where the reference's V carries
  // a ones lane
  const bool ones_lane = D < 128 && !(a.rate > 0.0f);

  // Q pre-scaled in float32, rounded back to bfloat16 (_scaled_q)
  for (int i = tid; i < kRows * DP; i += kThreads) {
    const int r = i / DP, d = i - r * DP;
    const int row = row0 + r;
    const float x = (row < Tq && d < D)
                        ? __bfloat162float(a.q[(static_cast<size_t>(bh) * Tq + row) * D + d])
                        : 0.0f;
    Qs[r * LD + d] = __float2bfloat16_rn(x * a.scale_log2);
  }

  // this thread's two rows (fragment rows g and g + 8 of its warp)
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  int kend[2];
  uint32_t row_x[2], row_salt[2];
  const uint32_t seed = a.seed ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t threshold = flash::drop_threshold(a.rate);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    kend[h] = row < Tq ? flash::key_end(row, Tk, a.causal, a.bq, a.bk) : 0;
    row_x[h] = flash::drop_row_x(row, a.bq);
    row_salt[h] = flash::drop_row_salt(row, a.bq, seed, bh);
  }
  // keys past the frontier of the warp's (and the block's) last row weigh nothing
  const int wlast = min(row0 + warp * 16 + 15, Tq - 1);
  const int wkend = row0 + warp * 16 < Tq ? flash::key_end(wlast, Tk, a.causal, a.bq, a.bk) : 0;
  const int last_row = min(row0 + kRows, Tq) - 1;
  const int kend_blk = min(flash::key_end(last_row, Tk, a.causal, a.bq, a.bk), Tk);
  const int ntiles = (kend_blk + kKeys - 1) / kKeys;

  auto load = [&](int tile, int st) {
    const int k0 = tile * kKeys;
    bf16mma::stage_rows<DP, LD, VEC, kKeys, kThreads>(Ks + st * kKeys * LD, kbase, k0, Tk, D,
                                                      tid);
    bf16mma::stage_rows<DP, LD, VEC, kKeys, kThreads>(Vs + st * kKeys * LD, vbase, k0, Tk, D,
                                                      tid);
    for (int j = tid; j < kKeys; j += kThreads) {
      const int key = k0 + j;
      uint32_t* inf = info + st * 3 * kKeys;
      inf[j] = key < Tk && (a.mask == nullptr ||
                            a.mask[static_cast<size_t>(b) * Tk + key] > 0.0f);
      inf[kKeys + j] = flash::drop_key_x(key, a.bk);
      inf[2 * kKeys + j] = flash::drop_key_salt(key, a.bk);
    }
  };

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's part of each row's mass

  if (ntiles > 0) load(0, 0);
  tf32x3::cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load(i + 1, (i + 1) & 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = i * kKeys;
    if (k0 < wkend) {
      const bf16* Kt = Ks + (i & 1) * kKeys * LD;
      const bf16* Vt = Vs + (i & 1) * kKeys * LD;
      const uint32_t* inf = info + (i & 1) * 3 * kKeys;

      // S = Q . K^T, 16 x 64 a warp
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      bf16mma::mma_abt<DP, NT, LD>(s, Qs + warp * 16 * LD, Kt, lane);

      // masks: a masked key scores the finite -1e30, a key the row does
      // not visit -inf (no weight, and the max is left alone)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int jj = nt * 8 + 2 * t + (e & 1);
          const int key = k0 + jj;
          const bool keep = inf[jj] != 0u && (!a.causal || key <= rows[h]);
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
          // the mass sums probabilities before dropout
          l[h] += ones_lane ? bf16mma::round_bf16(p) : p;
          if (a.rate > 0.0f) {
            const int jj = nt * 8 + 2 * t + (e & 1);
            p *= flash::drop_of(row_x[h], row_salt[h], inf[kKeys + jj], inf[2 * kKeys + jj],
                                threshold, a.keep_scale);
          }
          s[nt][e] = p;  // rounded to bfloat16 as P . V's operand
        }
      }
      m[0] = mx[0];
      m[1] = mx[1];

      // O += bf16(P) . V
      bf16mma::mma_pb<DP, NT, LD>(o, s, Vt, lane);
    }
    __syncthreads();  // the stage is free for the tile after next
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
    const float den = fmaxf(l[h], 1e-30f);
    bf16* op = a.out + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (d < D) op[d] = __float2bfloat16_rn(o[dt][2 * h] / den);
      if (d + 1 < D) op[d + 1] = __float2bfloat16_rn(o[dt][2 * h + 1] / den);
    }
    if (t == 0) a.out_lse[static_cast<size_t>(bh) * Tq + row] = flash::lse_of(m[h], l[h]);
  }
}

template <int DP, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tq + kRows - 1) / kRows);
  flash_fwd_bf16_kernel<DP, VEC><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dp(const Args& a, cudaStream_t st) {
  return bf16mma::vec_ok(a.D, a.q, a.k, a.v) ? launch<DP, true>(a, st)
                                             : launch<DP, false>(a, st);
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
      (Tq + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(launch_dp<32>(a, st));
  if (D <= 64) return static_cast<int>(launch_dp<64>(a, st));
  return static_cast<int>(launch_dp<128>(a, st));
}

const char* flash_attn_fwd_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
