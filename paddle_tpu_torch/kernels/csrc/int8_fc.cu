// Fused-dequant int8 FC for Hopper (sm_90a): K5.
//
// Replaces the Pallas kernel paddle_tpu/kernels/quant.py:167 _fc_kernel
// (launched by int8_fc through pl.pallas_call):
//
//   out[m, n] = act(float(sum_k xq[m, k] * wq[k, n]) * dq[n] + b[n])
//   dq[n]     = (s_x * w_scale[n]) / 127^2
//
// with xq int8 [M, K] (the activations quantized by the wrapper), the
// weight's codes wq int8 [K, N] as the quantize_int8 pass stores them,
// taken here K-major as wt = wq^T [N, K] (made once per weight by the
// wrapper's caller, kernels/quant.py Int8Plan), w_scale float32 [N], s_x a
// float32 scalar read from device memory (the calibrated scale, or the
// batch abs-max the wrapper reduced on the card: never a host value), b
// float32 [N] or absent (zeros), and act one of "", relu, sigmoid, tanh,
// gelu (tanh approximation, jax.nn.gelu's default).  The sums are exact
// int32, as the TPU kernel's preferred_element_type=int32, so any order of
// summation gives the same bits; the epilogue keeps the reference's order
// without contraction (__fmul_rn then __fadd_rn), so for "" and relu the
// output equals kernels/quant.py int8_fc_plain bit for bit.
//
// No shape gate.  The TPU kernel took the whole operands into VMEM and
// refused anything over an 8 MB budget (quant.py:97,206-209), sending the
// FFN and vocabulary projections to an XLA path.  This kernel is tiled,
// so it takes every M, N >= 0 and K >= 0.
//
// Design.
// - The int8 tensor cores through mma.sync.m16n8k32.s8.s8.s32: 8 warps a
//   block in 2 x 4, each a (16 MT) x (8 NT) tile of the block's 128 x 128
//   (MT = NT = 4) or 64 x 128 (MT = 2) outputs.  Both operands are
//   K-major (xq rows, wt rows), so ldmatrix.x4 of 8 x 16-byte rows gives
//   the fragments of A and of B directly.
// - K walks through a 4-stage ring of cp.async copies (16 bytes a thread
//   and copy): 64-byte chunks for 128 x 128 tiles (two blocks an SM), and
//   128-byte chunks for 64 x 128 tiles, so that K = 512 is in flight
//   whole.  A staged row is padded by 16 bytes, so the eight 16-byte rows
//   an ldmatrix reads fall in distinct banks.
// - The tile: 128 x 128 where that gives every SM a block, else 64 x 128.
//   K is never split: at [2048 -> 512], the one shape that leaves the
//   card with fewer than two blocks an SM at a deep K, two splits ran no
//   faster than one (PERF.md).
// - The epilogue's dequant factors and bias are read while K streams in.
//   The epilogue (dequant, bias, act) runs on the fragments; each warp
//   then stages 16 rows of its outputs at a time in shared memory and
//   writes them back as full 128-byte lines of 16-byte stores.
// - K % 16 != 0 or unaligned operands (none on the serving path) take byte
//   loads instead of cp.async; N % 4 != 0 takes scalar stores.
//
// Bound.  At the int8 Transformer's bucket-8 shapes (M = 2048) the
// function reads M*K + K*N bytes of codes and 8N of scales and bias and
// writes 4*M*N bytes of float32, against 2*M*N*K int8 operations at the
// 1,979 TOP/s of the H100's dense int8 tensor cores: every shape is bound
// by bytes (e.g. [2048, 512] x [512, 32000]: 262 MB written, 83.5 us).
// mma.sync's int8 rate is below wgmma's; what holds the tiles back on an
// H100 is the bytes each SM pulls from L2 (every tile of a row or column
// re-reads its operand), which multicast loads would cut.  The times are
// in PERF.md.
//
// Entry points: int8_fc(), a plain C function called through ctypes on
// PyTorch's current stream (returns 0 or a cudaError_t; it never
// synchronises and allocates nothing; M = 0 or N = 0 launches nothing),
// and int8_fc_config() (the tile and occupancy a shape takes).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kEpiLd = 32 + 4;          // a staged epilogue row (floats): a warp's 32 columns
constexpr float kQ2 = 16129.0f;         // 127^2

// The two tiles: 128 x 128 outputs with K in 64-byte chunks (two blocks
// an SM), and 64 x 128 with K in 128-byte chunks, so that the four stages
// hold all of a 512-deep K at once.  A staged row is padded by 16 bytes,
// so the eight 16-byte rows an ldmatrix reads fall in distinct banks.
__host__ __device__ constexpr int chunk_bytes(int mt) { return mt == 4 ? 64 : 128; }
__host__ __device__ constexpr int row_bytes(int mt) { return chunk_bytes(mt) + 16; }

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kGelu = 4 };

struct FcArgs {
  const int8_t* xq;      // [M, K]
  const int8_t* wt;      // [N, K]: the weight's codes, K-major
  const float* w_scale;  // [N]
  const float* sx;       // scalar
  const float* bias;     // [N] or null
  float* out;            // [M, N]
  int M, N, K, act;
  int vec_out;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a * b: m16n8k32, int8 x int8 -> int32 (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + ROWS) x bytes [k0, k0 + BK) of a row-major [rows][K]
// int8 operand into shared rows of BK + 16 bytes, zero past `rows` and K.
// VEC: cp.async of 16 bytes (K % 16 == 0, aligned rows); else byte loads.
template <int ROWS, int BK, bool VEC>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int r0, int rows,
                                          int k0, int K) {
  constexpr int kLd = BK + 16, kPieces = BK / 16;
  if (VEC) {
#pragma unroll
    for (int i = threadIdx.x; i < ROWS * kPieces; i += kThreads) {
      const int r = i / kPieces, c = (i % kPieces) * 16;
      const bool ok = r0 + r < rows && k0 + c < K;
      cp_async16(dst + r * kLd + c, ok ? src + static_cast<size_t>(r0 + r) * K + k0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const bool ok = r0 + r < rows && k0 + c < K;
      dst[r * kLd + c] = ok ? src[static_cast<size_t>(r0 + r) * K + k0 + c] : int8_t(0);
    }
  }
}

// One block: output tile blockIdx.x of the (BM = 32 MT) x 128 tiles
// (m fastest, so the blocks that run together share a column of wt).
template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) int8_fc_kernel(const FcArgs a) {
  constexpr int NT = 4;
  constexpr int BM = 32 * MT, BN = 32 * NT;
  constexpr int kBK = chunk_bytes(MT), kLd = row_bytes(MT);
  constexpr int kStageBytes = (BM + BN) * kLd;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float dq_s[BN], b_s[BN];
  const int tiles_m = (a.M + BM - 1) / BM;
  const int tile = blockIdx.x;
  const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int n = (a.K + kBK - 1) / kBK;  // K chunks

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto stage = [&](int i, int s) {
    int8_t* st = smem + s * kStageBytes;
    const int k0 = i * kBK;
    load_tile<BM, kBK, VEC>(st, a.xq, m0, a.M, k0, a.K);
    load_tile<BN, kBK, VEC>(st + BM * kLd, a.wt, n0, a.N, k0, a.K);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) stage(s, s);
    cp_async_commit();
  }
  // the epilogue's dequant factors and bias, loaded while K streams in
  if (tid < BN) {
    const int col = n0 + tid;
    const bool ok = col < a.N;
    // (s_x * w_scale) / 127^2, then acc * dq + b: the reference's order
    dq_s[tid] = ok ? __fdiv_rn(__fmul_rn(__ldg(a.sx), __ldg(a.w_scale + col)), kQ2) : 0.0f;
    b_s[tid] = ok && a.bias ? __ldg(a.bias + col) : 0.0f;
  }
  // this lane's ldmatrix rows: A rows (lane & 15), bytes 16 (lane >> 4);
  // B rows (lane & 7) + 8 (lane >> 4), bytes 16 ((lane >> 3) & 1)
  const int a_off = (wm * 16 * MT + (lane & 15)) * kLd + (lane >> 4) * 16;
  const int b_off = (BM + wn * 8 * NT + (lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 16;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i has landed, and chunk i - 1's stage is free
    if (i + kStages - 1 < n) stage(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const int8_t* st = smem + (i % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t fa[MT][4], fb[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(fa[mt], st + a_off + mt * 16 * kLd + kk);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) ldmatrix_x4(fb[np], st + b_off + np * 16 * kLd + kk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(acc[mt][nt], fa[mt], fb[nt / 2][2 * (nt & 1)], fb[nt / 2][2 * (nt & 1) + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue stages through it; dq_s, b_s are set

  float dq[NT][2], bs[NT][2];  // this thread's 2 NT columns
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dq[nt][h] = dq_s[wn * 8 * NT + nt * 8 + 2 * q + h];
      bs[nt][h] = b_s[wn * 8 * NT + nt * 8 + 2 * q + h];
    }
  float* epi = reinterpret_cast<float*>(smem) + warp * 16 * kEpiLd;
  const int wcol0 = n0 + wn * 8 * NT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][e]), dq[nt][e & 1]),
                                  bs[nt][e & 1]);
        epi[(g + 8 * (e >> 1)) * kEpiLd + nt * 8 + 2 * q + (e & 1)] = apply_act(v, a.act);
      }
    __syncwarp();
    // 16 rows x 8 NT floats: rows of 32 floats as eight 16-byte pieces
    const int row0 = m0 + wm * 16 * MT + mt * 16;
#pragma unroll
    for (int i = lane; i < 16 * 2 * NT; i += 32) {
      const int r = i / (2 * NT), c = (i % (2 * NT)) * 4;
      const int m = row0 + r, col = wcol0 + c;
      if (m >= a.M) continue;
      const float* v = epi + r * kEpiLd + c;
      float* o = a.out + static_cast<size_t>(m) * a.N + col;
      if (a.vec_out && col + 3 < a.N) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < a.N) o[j] = v[j];
        }
      }
    }
    __syncwarp();
  }
}

// The tile and grid a shape takes on `device`.
struct Config {
  int mt;        // 4: 128 x 128 tiles; 2: 64 x 128
  int tiles;
  size_t smem;
};

size_t stage_smem(int mt) { return static_cast<size_t>(kStages) * (32 * mt + 128) * row_bytes(mt); }

int tiles_of(int M, int N, int mt) { return ((M + 32 * mt - 1) / (32 * mt)) * ((N + 127) / 128); }

int config(int M, int N, int device, Config* c) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 128 x 128 where that gives every SM a block, else 64 x 128
  c->mt = tiles_of(M, N, 4) >= sms ? 4 : 2;
  c->tiles = tiles_of(M, N, c->mt);
  c->smem = stage_smem(c->mt);
  return 0;
}

using Kernel = void (*)(const FcArgs);

Kernel kernel_for(int mt, bool vec) {
  if (mt == 4) return vec ? int8_fc_kernel<4, true> : int8_fc_kernel<4, false>;
  return vec ? int8_fc_kernel<2, true> : int8_fc_kernel<2, false>;
}

}  // namespace

extern "C" {

// out[0..5] = tile rows, tile columns, blocks, resident blocks an SM,
// registers a thread, shared memory a block (bytes).  Returns 0 or a
// cudaError_t.
int int8_fc_config(int M, int N, int K, int device, int* out) {
  Config c;
  int err = config(std::max(M, 1), std::max(N, 1), device, &c);
  if (err) return err;
  const Kernel k = kernel_for(c.mt, K % 16 == 0);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(c.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, c.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 32 * c.mt;
  out[1] = 128;
  out[2] = c.tiles;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(c.smem);
  return 0;
}

// xq int8 [M, K], wt int8 [N, K] (the weight's codes, K-major), w_scale
// float32 [N], sx float32 [1], bias float32 [N] or null, out float32
// [M, N]: contiguous, on `device`.  act: 0 none, 1 relu, 2 sigmoid, 3
// tanh, 4 gelu (tanh approximation).  Returns 0 or a cudaError_t.
int int8_fc(const void* xq, const void* wt, const void* w_scale, const void* sx, const void* bias,
            void* out, int M, int N, int K, int act, int device, void* stream) {
  if (M < 0 || N < 0 || K < 0 || act < kNone || act > kGelu)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Config c;
  const int rc = config(M, N, device, &c);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FcArgs a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.wt = static_cast<const int8_t*>(wt);
  a.w_scale = static_cast<const float*>(w_scale);
  a.sx = static_cast<const float*>(sx);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.M = M; a.N = N; a.K = K; a.act = act;
  // 16-byte rows of xq and wt (the wrapper's tensors are contiguous from
  // an aligned allocation), 16-byte rows of out
  const bool vec_in =
      K % 16 == 0 && (reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wt)) % 16 == 0;
  a.vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const Kernel k = kernel_for(c.mt, vec_in);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(c.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<c.tiles, kThreads, c.smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_fc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
