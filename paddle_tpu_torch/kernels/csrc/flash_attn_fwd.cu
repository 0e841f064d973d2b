// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas kernel paddle_tpu/kernels/attention.py
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
// block takes 64 query rows of one (batch, head); each row lives in
// LPR = ceil(D / 32) adjacent lanes (32 of its D values each), which
// keep q (pre-scaled into exp2 units), the running max m, the mass l
// and the accumulator acc in registers, in float32 throughout.  K and V
// stream through shared memory 32 keys at a time; a row scores the 32
// keys (a dot product over its lanes, summed with two shuffles at most),
// rescales acc once per tile, then adds the tile's p * V.  Causal
// blocks stop at the reference's causal frontier.
//
// Bound.  For B=32, H=8, T=256, D=64 the work is 4 * B*H*Tq*Tk*D = 4.3
// GFLOP of float32 (two products of Tq x Tk x D), over about 67 MB of
// q, k, v, mask and out: 64 operations per byte, so bound by the
// float32 rate outside the tensor cores (67 TFLOP/s on an H100 SXM),
// about 0.064 ms.  This first version runs on the CUDA cores with
// scalar FMAs (no wgmma, TMA or cp.async; a later PR's work) and
// reloads K/V per 64-row q tile; its time beside that bound is in
// PERF.md.
//
// Entry point: flash_attn_fwd(), a plain C function called through
// ctypes on PyTorch's current stream.  It launches and returns
// cudaGetLastError(); it never synchronises and allocates nothing.

#include "flash_attn_common.cuh"

namespace {

using flash::Args;
using flash::kNegInf;

constexpr int kRows = 64;  // query rows per block
constexpr int kKeys = 32;  // keys per shared-memory tile

template <int LPR>
__global__ void __launch_bounds__(kRows * LPR)
flash_fwd_kernel(const Args a) {
  constexpr int DP = LPR * 32;
  __shared__ __align__(16) float ks[kKeys][DP];
  __shared__ __align__(16) float vs[kKeys][DP];
  __shared__ float valid[kKeys];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int tid = threadIdx.x;
  const int sub = tid % LPR;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + tid / LPR;
  const bool row_ok = row < a.Tq;

  float q[32], acc[32];
  const float* qp = a.q + (static_cast<size_t>(bh) * a.Tq + (row_ok ? row : 0)) * a.D;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int d = flash::dim_of<LPR>(e, sub);
    q[e] = (row_ok && d < a.D) ? qp[d] * a.scale_log2 : 0.0f;
    acc[e] = 0.0f;
  }
  float m = kNegInf;
  float l = 0.0f;
  const int kend = row_ok ? flash::key_end(row, a.Tk, a.causal, a.bq, a.bk) : 0;
  const int last_row = min(row0 + kRows, a.Tq) - 1;
  const int kend_blk = min(flash::key_end(last_row, a.Tk, a.causal, a.bq, a.bk), a.Tk);
  const uint32_t seed = a.seed ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const float* kbase = a.k + static_cast<size_t>(bh) * a.Tk * a.D;
  const float* vbase = a.v + static_cast<size_t>(bh) * a.Tk * a.D;

  for (int k0 = 0; k0 < kend_blk; k0 += kKeys) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kKeys * DP; idx += blockDim.x) {
      const int j = idx / DP;
      const int d = idx - j * DP;
      const int key = k0 + j;
      const bool ok = key < a.Tk && d < a.D;
      const size_t off = static_cast<size_t>(key) * a.D + d;
      ks[j][d] = ok ? kbase[off] : 0.0f;
      vs[j][d] = ok ? vbase[off] : 0.0f;
    }
    for (int j = tid; j < kKeys; j += blockDim.x) {
      const int key = k0 + j;
      valid[j] = (key < a.Tk &&
                  (a.mask == nullptr || a.mask[static_cast<size_t>(b) * a.Tk + key] > 0.0f))
                     ? 1.0f : 0.0f;
    }
    __syncthreads();

    float s[kKeys];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float dot = flash::row_sum<LPR>(flash::dot_row<LPR>(q, ks[j], sub));
      const int key = k0 + j;
      const bool keep = valid[j] > 0.0f && (!a.causal || key <= row);
      const float sc = keep ? dot : kNegInf;
      // keys this row does not visit weigh nothing and leave m alone
      s[j] = (key < kend && key < a.Tk) ? sc : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float p = exp2f(s[j] - mx);
      l += p;  // the mass sums probabilities before dropout
      if (a.rate > 0.0f && p != 0.0f) {
        p *= flash::drop_mult(seed, bh, row, k0 + j, a.bq, a.bk, a.rate,
                              a.keep_scale);
      }
      flash::axpy_row<LPR>(acc, p, vs[j], sub);
    }
    m = mx;
  }
  if (!row_ok) return;
  // the reference's zero-padded keys in [Tk, kend) score -1e30: they add
  // mass 1 each to a row whose every visited key is masked, else 0
  if (m == kNegInf && kend > a.Tk) l += static_cast<float>(kend - a.Tk);

  const float inv = 1.0f / fmaxf(l, 1e-30f);
  float* op = a.out + (static_cast<size_t>(bh) * a.Tq + row) * a.D;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int d = flash::dim_of<LPR>(e, sub);
    if (d < a.D) op[d] = acc[e] * inv;
  }
  if (sub == 0) {
    a.out_lse[static_cast<size_t>(bh) * a.Tq + row] =
        l > 0.0f ? m + log2f(fmaxf(l, 1e-30f)) : 1e30f;
  }
}

template <int LPR>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const dim3 grid(a.B * a.H, (a.Tq + kRows - 1) / kRows);
  flash_fwd_kernel<LPR><<<grid, kRows * LPR, 0, st>>>(a);
  return cudaGetLastError();
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
  if (D <= 32) return static_cast<int>(launch<1>(a, st));
  if (D <= 64) return static_cast<int>(launch<2>(a, st));
  return static_cast<int>(launch<4>(a, st));
}

const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
