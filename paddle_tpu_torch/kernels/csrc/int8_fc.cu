// Fused-dequant int8 FC for Hopper (sm_90a): K5.
//
// Replaces the Pallas kernel paddle_tpu/kernels/quant.py _fc_kernel
// (launched by int8_fc through pl.pallas_call):
//
//   out[m, n] = act(float(sum_k xq[m, k] * wq[k, n]) * dq[n] + b[n])
//   dq[n]     = (s_x * w_scale[n]) / 127^2
//
// with xq int8 [M, K] (the activations quantized by the wrapper), wq int8
// [K, N] (the weight as the quantize_int8 pass stores it), w_scale float32
// [N], s_x a float32 scalar read from device memory (the calibrated scale,
// or the batch abs-max the wrapper reduced on the card: never a host
// value), b float32 [N] or absent (zeros), and act one of "", relu,
// sigmoid, tanh, gelu (tanh approximation, jax.nn.gelu's default).  The
// accumulator is exact int32, as the TPU kernel's
// preferred_element_type=int32; the epilogue keeps the reference's order
// without contraction (__fmul_rn then __fadd_rn), so for "" and relu the
// output equals kernels/quant.py int8_fc_plain bit for bit.
//
// No shape gate.  The TPU kernel took the whole operands into VMEM and
// refused anything over an 8 MB budget (quant.py:97,206-209), sending the
// FFN and vocabulary projections to an XLA path.  This kernel is tiled,
// so it takes every M, N >= 0 and K >= 0.
//
// Design (a simple kernel that is right; tensor cores come later).  A
// block of 256 threads computes a 64 x 64 output tile.  K is walked in
// chunks of 64: the block stages the chunk's 64 x 64 bytes of xq
// row-major and of wq transposed (so both are K-contiguous) in shared
// memory, zero-padding past M, N and K.  Thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4): per 16-deep step it reads
// four 16-byte row segments of each operand and issues 64 __dp4a
// (four int8 products summed into an int32).  Rows are padded to 80
// bytes, so the 16-byte column reads of a quarter warp hit distinct
// banks.  When K % 16 == 0 and N % 4 == 0 (every shape of the serving
// path) the stage uses 16-byte loads of xq and 4-byte loads of wq;
// otherwise byte loads with bounds.  The epilogue (dequant, bias, act)
// is applied in registers and each warp stores 16 consecutive floats a
// row.
//
// Bound.  At the int8 Transformer's bucket-8 shapes (M = 2048) the
// function reads M*K + K*N bytes of codes and 8N of scales and bias and
// writes 4*M*N bytes of float32, against 2*M*N*K int8 operations at the
// 1,979 TOP/s of the H100's int8 tensor cores: every shape is bound by
// bytes (e.g. [2048, 512] x [512, 32000]: 262 MB written, 83.5 us).
// This kernel computes on the CUDA cores (__dp4a), whose int8 rate is a
// small fraction of the tensor cores'; its times beside the bound are in
// PERF.md.
//
// Entry point: int8_fc(), a plain C function called through ctypes on
// PyTorch's current stream.  It returns 0 or a cudaError_t; it never
// synchronises and allocates nothing.  M = 0 or N = 0 launches nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kChunk = 64;             // K bytes staged a step
constexpr int kStride = kChunk + 16;   // padded shared row (bytes)
constexpr int kThreads = 256;
constexpr float kQ2 = 16129.0f;        // 127^2

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kGelu = 4 };

struct FcArgs {
  const int8_t* xq;      // [M, K]
  const int8_t* wq;      // [K, N]
  const float* w_scale;  // [N]
  const float* sx;       // scalar
  const float* bias;     // [N] or null
  float* out;            // [M, N]
  int M, N, K, act;
};

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.0f);
    case kSigmoid:
      return 1.0f / (1.0f + expf(-v));
    case kTanh:
      return tanhf(v);
    case kGelu: {
      // 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))
      const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(inner));
    }
    default:
      return v;
  }
}

// Stage chunk k0 of xq (rows m0..m0+63) into As[row][k] and of wq
// (columns n0..n0+63) into Bs[col][k], zero past the edges.
template <bool kVec>
__device__ __forceinline__ void stage(const FcArgs& a, int m0, int n0, int k0, int8_t* As,
                                      int8_t* Bs) {
  const int t = threadIdx.x;
  // xq: thread t copies 16 bytes of row t / 4, segment t % 4
  {
    const int r = t >> 2, seg = (t & 3) * 16;
    const int m = m0 + r, k = k0 + seg;
    int8_t* dst = As + r * kStride + seg;
    if (kVec) {
      int4 v = make_int4(0, 0, 0, 0);
      if (m < a.M && k < a.K)
        v = __ldg(reinterpret_cast<const int4*>(a.xq + static_cast<size_t>(m) * a.K + k));
      *reinterpret_cast<int4*>(dst) = v;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[i] = (m < a.M && k + i < a.K) ? a.xq[static_cast<size_t>(m) * a.K + k + i]
                                          : static_cast<int8_t>(0);
    }
  }
  // wq: thread t reads the 4 x 4 block k0 + 4 (t / 16) .. +3, n0 + 4 (t % 16)
  // .. +3 and stores it transposed as four K-contiguous words
  {
    const int kq = t >> 4, nq = t & 15;
    const int kb = k0 + 4 * kq, nb = n0 + 4 * nq;
    uint32_t rows[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kb + r;
      if (kVec) {
        rows[r] = (k < a.K && nb < a.N)
                      ? __ldg(reinterpret_cast<const uint32_t*>(a.wq + static_cast<size_t>(k) * a.N +
                                                                nb))
                      : 0u;
      } else {
        uint32_t w = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte =
              (k < a.K && nb + c < a.N)
                  ? static_cast<uint8_t>(a.wq[static_cast<size_t>(k) * a.N + nb + c])
                  : 0u;
          w |= byte << (8 * c);
        }
        rows[r] = w;
      }
    }
    // column c of the block: byte c of each row word, rows in K order
    const uint32_t lo01 = __byte_perm(rows[0], rows[1], 0x5140);  // c0k0 c0k1 c1k0 c1k1
    const uint32_t lo23 = __byte_perm(rows[2], rows[3], 0x5140);
    const uint32_t hi01 = __byte_perm(rows[0], rows[1], 0x7362);  // c2k0 c2k1 c3k0 c3k1
    const uint32_t hi23 = __byte_perm(rows[2], rows[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(Bs + (4 * nq + c) * kStride + 4 * kq) = col[c];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) int8_fc_kernel(const FcArgs a) {
  __shared__ __align__(16) int8_t As[kTileM * kStride];
  __shared__ __align__(16) int8_t Bs[kTileN * kStride];
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < a.K; k0 += kChunk) {
    stage<kVec>(a, m0, n0, k0, As, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      int4 xa[4], wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xa[i] = *reinterpret_cast<const int4*>(As + (ty + 16 * i) * kStride + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wb[j] = *reinterpret_cast<const int4*>(Bs + (tx + 16 * j) * kStride + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int s = acc[i][j];
          s = __dp4a(xa[i].x, wb[j].x, s);
          s = __dp4a(xa[i].y, wb[j].y, s);
          s = __dp4a(xa[i].z, wb[j].z, s);
          s = __dp4a(xa[i].w, wb[j].w, s);
          acc[i][j] = s;
        }
    }
    __syncthreads();
  }

  const float sx = __ldg(a.sx);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= a.N) continue;
    // (s_x * w_scale) / 127^2, then acc * dq + b: the reference's order
    const float dq = __fdiv_rn(__fmul_rn(sx, __ldg(a.w_scale + n)), kQ2);
    const float b = a.bias ? __ldg(a.bias + n) : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= a.M) continue;
      const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), dq), b);
      a.out[static_cast<size_t>(m) * a.N + n] = apply_act(v, a.act);
    }
  }
}

}  // namespace

extern "C" {

// xq int8 [M, K], wq int8 [K, N], w_scale float32 [N], sx float32 [1],
// bias float32 [N] or null, out float32 [M, N]: contiguous, on `device`.
// act: 0 none, 1 relu, 2 sigmoid, 3 tanh, 4 gelu (tanh approximation).
// Returns 0 or a cudaError_t.
int int8_fc(const void* xq, const void* wq, const void* w_scale, const void* sx, const void* bias,
            void* out, int M, int N, int K, int act, int device, void* stream) {
  if (M < 0 || N < 0 || K < 0 || act < kNone || act > kGelu)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  FcArgs a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.wq = static_cast<const int8_t*>(wq);
  a.w_scale = static_cast<const float*>(w_scale);
  a.sx = static_cast<const float*>(sx);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.M = M; a.N = N; a.K = K; a.act = act;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte rows of xq and 4-byte rows of wq stay aligned (the
  // wrapper's tensors are contiguous from an aligned allocation)
  const bool vec = K % 16 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  if (vec)
    int8_fc_kernel<true><<<grid, kThreads, 0, st>>>(a);
  else
    int8_fc_kernel<false><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_fc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
