// Flash-attention backward for Hopper (sm_90a), float32: two kernels.
//
// Replaces the Pallas kernels paddle_tpu/kernels/attention.py
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (both launched by
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
// The two grids split the work so that neither needs atomics.  lse and
// delta are inputs, so ring attention can pass its global (merged)
// values, as the reference's _pallas_bwd(..., delta=) allows.
//
// Design.  As in the forward (flash_attn_fwd.cu): a row (of q for dq,
// of k for dk/dv) lives in LPR = ceil(D / 32) adjacent lanes with its
// operands and float32 accumulators in registers; the other side
// streams through shared memory, 32 rows at a time.  A k-block entirely
// above the causal frontier starts at the reference's clamped first
// q-block (_first_qb), so its dk and dv come out exactly zero.
//
// Bound.  For B=32, H=8, T=256, D=64 (not causal): dq does 6 * B*H*Tq*
// Tk*D = 6.4 GFLOP, dk/dv 8 * B*H*Tq*Tk*D = 8.6 GFLOP, on about 100 MB
// each: both bound by the float32 rate outside the tensor cores (67
// TFLOP/s), about 0.096 ms and 0.128 ms.  This first version uses scalar
// FMAs on the CUDA cores (no wgmma, TMA or cp.async); its times are in
// PERF.md.
//
// Entry points: flash_attn_bwd_dq() and flash_attn_bwd_dkv(), plain C
// functions called through ctypes on PyTorch's current stream.  Each
// launches and returns cudaGetLastError(); neither synchronises or
// allocates.

#include "flash_attn_common.cuh"

namespace {

using flash::Args;
using flash::kNegInf;

constexpr int kRows = 64;  // rows a block owns (q rows for dq, keys for dk/dv)
constexpr int kTile = 32;  // rows of the other side per shared-memory tile

template <int LPR>
__global__ void __launch_bounds__(kRows * LPR)
flash_bwd_dq_kernel(const Args a) {
  constexpr int DP = LPR * 32;
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  __shared__ float valid[kTile];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int tid = threadIdx.x;
  const int sub = tid % LPR;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + tid / LPR;
  const bool row_ok = row < a.Tq;

  float q[32], dout[32], dq[32];
  const size_t roff = (static_cast<size_t>(bh) * a.Tq + (row_ok ? row : 0)) * a.D;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int d = flash::dim_of<LPR>(e, sub);
    const bool ok = row_ok && d < a.D;
    q[e] = ok ? a.q[roff + d] * a.scale_log2 : 0.0f;
    dout[e] = ok ? a.dout[roff + d] : 0.0f;
    dq[e] = 0.0f;
  }
  const size_t ridx = static_cast<size_t>(bh) * a.Tq + (row_ok ? row : 0);
  const float lse = row_ok ? a.lse[ridx] : 0.0f;
  const float delta = row_ok ? a.delta[ridx] : 0.0f;
  const int kend = row_ok ? flash::key_end(row, a.Tk, a.causal, a.bq, a.bk) : 0;
  const int last_row = min(row0 + kRows, a.Tq) - 1;
  const int kend_blk = min(flash::key_end(last_row, a.Tk, a.causal, a.bq, a.bk), a.Tk);
  const uint32_t seed = a.seed ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const float* kbase = a.k + static_cast<size_t>(bh) * a.Tk * a.D;
  const float* vbase = a.v + static_cast<size_t>(bh) * a.Tk * a.D;

  for (int k0 = 0; k0 < kend_blk; k0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * DP; idx += blockDim.x) {
      const int j = idx / DP;
      const int d = idx - j * DP;
      const int key = k0 + j;
      const bool ok = key < a.Tk && d < a.D;
      const size_t off = static_cast<size_t>(key) * a.D + d;
      ks[j][d] = ok ? kbase[off] : 0.0f;
      vs[j][d] = ok ? vbase[off] : 0.0f;
    }
    for (int j = tid; j < kTile; j += blockDim.x) {
      const int key = k0 + j;
      valid[j] = (key < a.Tk &&
                  (a.mask == nullptr || a.mask[static_cast<size_t>(b) * a.Tk + key] > 0.0f))
                     ? 1.0f : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = flash::row_sum<LPR>(flash::dot_row<LPR>(q, ks[j], sub));
      float dp = flash::row_sum<LPR>(flash::dot_row<LPR>(dout, vs[j], sub));
      const int key = k0 + j;
      if (key >= kend || key >= a.Tk) continue;  // not visited: p = 0
      const bool keep = valid[j] > 0.0f && (!a.causal || key <= row);
      const float p = exp2f((keep ? s : kNegInf) - lse);
      if (a.rate > 0.0f) {
        dp *= flash::drop_mult(seed, bh, row, key, a.bq, a.bk, a.rate,
                               a.keep_scale);
      }
      flash::axpy_row<LPR>(dq, p * (dp - delta), ks[j], sub);
    }
  }
  if (!row_ok) return;
  float* op = a.out + roff;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int d = flash::dim_of<LPR>(e, sub);
    if (d < a.D) op[d] = dq[e] * a.grad_scale;
  }
}

template <int LPR>
__global__ void __launch_bounds__(kRows * LPR)
flash_bwd_dkv_kernel(const Args a) {
  constexpr int DP = LPR * 32;
  __shared__ __align__(16) float qs[kTile][DP];
  __shared__ __align__(16) float dos[kTile][DP];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int tid = threadIdx.x;
  const int sub = tid % LPR;
  const int key0 = blockIdx.y * kRows;
  const int key = key0 + tid / LPR;
  const bool key_ok = key < a.Tk;

  float kr[32], vr[32], dk[32], dv[32];
  const size_t koff = (static_cast<size_t>(bh) * a.Tk + (key_ok ? key : 0)) * a.D;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int d = flash::dim_of<LPR>(e, sub);
    const bool ok = key_ok && d < a.D;
    kr[e] = ok ? a.k[koff + d] : 0.0f;
    vr[e] = ok ? a.v[koff + d] : 0.0f;
    dk[e] = 0.0f;
    dv[e] = 0.0f;
  }
  const bool key_valid =
      key_ok && (a.mask == nullptr || a.mask[static_cast<size_t>(b) * a.Tk + key] > 0.0f);
  const int rbeg = key_ok ? flash::row_begin(key, a.Tq, a.causal, a.bq, a.bk) : a.Tq;
  const int rbeg_blk = flash::row_begin(key0, a.Tq, a.causal, a.bq, a.bk);
  const uint32_t seed = a.seed ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const float* qbase = a.q + static_cast<size_t>(bh) * a.Tq * a.D;
  const float* dobase = a.dout + static_cast<size_t>(bh) * a.Tq * a.D;
  const float* lbase = a.lse + static_cast<size_t>(bh) * a.Tq;
  const float* dbase = a.delta + static_cast<size_t>(bh) * a.Tq;

  for (int i0 = rbeg_blk; i0 < a.Tq; i0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * DP; idx += blockDim.x) {
      const int j = idx / DP;
      const int d = idx - j * DP;
      const int r = i0 + j;
      const bool ok = r < a.Tq && d < a.D;
      const size_t off = static_cast<size_t>(r) * a.D + d;
      qs[j][d] = ok ? qbase[off] * a.scale_log2 : 0.0f;
      dos[j][d] = ok ? dobase[off] : 0.0f;
    }
    for (int j = tid; j < kTile; j += blockDim.x) {
      const int r = i0 + j;
      lse_s[j] = r < a.Tq ? lbase[r] : 0.0f;
      delta_s[j] = r < a.Tq ? dbase[r] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = flash::row_sum<LPR>(flash::dot_row<LPR>(kr, qs[j], sub));
      float dp = flash::row_sum<LPR>(flash::dot_row<LPR>(vr, dos[j], sub));
      const int r = i0 + j;
      if (r < rbeg || r >= a.Tq || !key_ok) continue;  // not visited: p = 0
      const bool keep = key_valid && (!a.causal || key <= r);
      const float p = exp2f((keep ? s : kNegInf) - lse_s[j]);
      float pd = p;
      if (a.rate > 0.0f) {
        const float drop = flash::drop_mult(seed, bh, r, key, a.bq, a.bk,
                                            a.rate, a.keep_scale);
        pd *= drop;
        dp *= drop;
      }
      flash::axpy_row<LPR>(dv, pd, dos[j], sub);
      flash::axpy_row<LPR>(dk, p * (dp - delta_s[j]), qs[j], sub);
    }
  }
  if (!key_ok) return;
  float* kp = a.dk + koff;
  float* vp = a.dv + koff;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int d = flash::dim_of<LPR>(e, sub);
    if (d < a.D) {
      kp[d] = dk[e] * a.grad_scale;
      vp[d] = dv[e];
    }
  }
}

template <int LPR>
cudaError_t launch_dq(const Args& a, cudaStream_t st) {
  const dim3 grid(a.B * a.H, (a.Tq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<LPR><<<grid, kRows * LPR, 0, st>>>(a);
  return cudaGetLastError();
}

template <int LPR>
cudaError_t launch_dkv(const Args& a, cudaStream_t st) {
  const dim3 grid(a.B * a.H, (a.Tk + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<LPR><<<grid, kRows * LPR, 0, st>>>(a);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(launch_dq<1>(a, st));
  if (D <= 64) return static_cast<int>(launch_dq<2>(a, st));
  return static_cast<int>(launch_dq<4>(a, st));
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(launch_dkv<1>(a, st));
  if (D <= 64) return static_cast<int>(launch_dkv<2>(a, st));
  return static_cast<int>(launch_dkv<4>(a, st));
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
