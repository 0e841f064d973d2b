// bfloat16 products on the tensor cores, and the copies that feed them:
// the pieces of the bfloat16 flash forward (flash_attn_fwd_bf16.cu, K1).
// (The bfloat16 backward, K2/K3, is built on wgmma: sm90.cuh.)
//
// A product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// bfloat16 operands, each product exact in float32, summed in a float32
// accumulator, the arithmetic of the reference's jnp.dot(bf16, bf16,
// preferred_element_type=float32).  No split is needed, unlike the
// float32 kernels' split TF32 (tf32x3.cuh).
//
// Fragments of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4),
// each register two bfloat16 values, the lower column in the low half:
//   A (16 x 16, row):  a0 = A[g][2t..2t+1],     a1 = A[g + 8][2t..2t+1],
//                      a2 = A[g][2t+8..2t+9],   a3 = A[g + 8][2t+8..2t+9]
//   B (16 x 8, col):   b0 = B[2t..2t+1][g],     b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32):   c0, c1 = C[g][2t..2t+1], c2, c3 = C[g + 8][2t..2t+1]
// so the C fragments of two neighbouring n8 tiles, packed to bfloat16,
// are the A fragment of the product of that 16 x 16 block with a 16 x n
// matrix (FlashAttention-2's P . V without a trip through shared
// memory): mma_pb below.
//
// Tiles sit in shared memory row-major with rows of LD = DP + 8 values:
// the 16 extra bytes a row put the eight rows an ldmatrix reads in eight
// different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // cp.async

namespace bf16mma {

using bf16 = __nv_bfloat16;

// d += a * b; a plain (not volatile) asm statement, so the compiler may
// interleave independent products
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bfloat16 blocks, lane l giving the address of row l % 8 of
// block l / 8; thread 4g + t receives row g, columns 2t and 2t + 1 of
// every block (ldsm4), or of every block transposed (ldsm4_t)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// two floats rounded to nearest even into one register of bfloat16s
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// lane offsets into a row-major [.][LD] tile: of the A fragment of the
// 16 x 16 block at (0, 0), which is also the transposed B fragment of
// two n8 column tiles (rows = k); and of the B fragment of X . Y^T for
// two n8 tiles of Y's rows (Y row-major, rows = n)
template <int LD>
__device__ __forceinline__ int off_a(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int off_bt(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
}

// s (16 x 8 NT, C fragments) += A . B^T: A the 16 rows at `A`, B the
// 8 NT rows at `B`, both [.][LD] tiles of DP columns (zero past D)
template <int DP, int NT, int LD>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4], const bf16* A, const bf16* B,
                                        int lane) {
  const int oa = off_a<LD>(lane), ob = off_bt<LD>(lane);
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    uint32_t a[4];
    ldsm4(a, A + oa + kc * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, B + np * 16 * LD + ob + kc * 16);
      mma(s[2 * np], a, b[0], b[1]);
      mma(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DP, C fragments) += bf16(P) . B: P 16 x 8 NT in C fragments
// (float32, rounded to nearest even here), B the 8 NT rows of DP columns
// at `B`, a [.][LD] tile
template <int DP, int NT, int LD>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 8][4], const float (&p)[NT][4],
                                       const bf16* B, int lane) {
  const int ob = off_a<LD>(lane);
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const uint32_t a[4] = {pack(p[2 * kc][0], p[2 * kc][1]), pack(p[2 * kc][2], p[2 * kc][3]),
                           pack(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t b[4];
      ldsm4_t(b, B + kc * 16 * LD + ob + dp * 16);
      mma(acc[2 * dp], a, b[0], b[1]);
      mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// NR rows from r0 of an [n_rows, D] bfloat16 matrix into an [NR][LD]
// tile, zero past n_rows and D: with cp.async in 16-byte pieces where
// D % 8 == 0 and the matrix is 16-byte aligned (VEC), else by plain
// loads and stores (visible after the next barrier)
template <int DP, int LD, bool VEC, int NR, int NTHREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int n_rows, int D,
                                           int tid) {
  if (VEC) {
    for (int i = tid; i < NR * DP / 8; i += NTHREADS) {
      const int j = i / (DP / 8), c = (i % (DP / 8)) * 8;
      const bool ok = r0 + j < n_rows && c < D;
      tf32x3::cp_async16(dst + j * LD + c, ok ? src + static_cast<size_t>(r0 + j) * D + c : src,
                         ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < NR * DP; i += NTHREADS) {
      const int j = i / DP, c = i - j * DP;
      const bool ok = r0 + j < n_rows && c < D;
      dst[j * LD + c] = ok ? src[static_cast<size_t>(r0 + j) * D + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// the tile copies may use cp.async: D % 8 == 0 and every matrix 16-byte
// aligned
__host__ inline bool vec_ok(int D, const void* a, const void* b, const void* c,
                            const void* d = nullptr) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                      reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  return D % 8 == 0 && (m & 15u) == 0;
}

}  // namespace bf16mma
