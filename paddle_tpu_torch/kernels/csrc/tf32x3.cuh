// Float32 products on the tensor cores by split TF32 ("3xTF32"), and the
// cp.async copies that feed them: the pieces the redesigned flash kernels
// (flash_attn_fwd.cu, K1; flash_attn_bwd.cu, K2/K3) and recurrent kernels
// (lstm_fwd.cu, K6; lstm_bwd.cu, K7; gru_fwd.cu, K8a; gru_bwd.cu, K8b)
// share.  No other kernel includes this header.
//
// A float32 x is split into x_hi = tf32(x) (round to nearest, ties away,
// to 10 explicit mantissa bits, as cvt.rna.tf32.f32) and x_lo = x - x_hi
// truncated to TF32; x - x_hi is exact, so x_hi + x_lo keeps about 21 of
// x's 24 bits.  Both are integer adds and masks: the conversion
// instruction runs at a fraction of the integer rate, and every operand
// element is split once per warp that reads it.  A product a * b is
// taken as a_lo * b_hi + a_hi * b_lo + a_hi * b_hi (the small terms
// first), three mma.sync m16n8k8 TF32 products accumulated in float32:
// each tf32 x tf32 product is exact in float32, and the dropped a_lo * b_lo
// is below 2^-21 of |a * b|.  That keeps the result at float32 accuracy
// (PyTorch's float32 matmul default, "highest"); one TF32 product alone
// keeps three decimal digits and is not used.  kernels/_tf32.py is the
// same arithmetic in PyTorch, for the CPU tests.
//
// Fragments of mma.sync.m16n8k8 (lane = 4 * g + q, g = lane / 4, q = lane % 4):
//   A (16 x 8, row):  a0 = A[g][q], a1 = A[g + 8][q], a2 = A[g][q + 4], a3 = A[g + 8][q + 4]
//   B (8 x 8, col):   b0 = B[q][g], b1 = B[q + 4][g]
//   C (16 x 8):       c0 = C[g][2q], c1 = C[g][2q + 1], c2 = C[g + 8][2q], c3 = C[g + 8][2q + 1]
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent, 10 mantissa bits

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & kTf32Mask;  // half an ulp up, then truncate
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b (mma_tf32) and d = a * b (mma_tf32_first, a fresh
// accumulator), one mma.sync m16n8k8 TF32 product each, as plain asm
// statements: mma above is volatile, so the compiler keeps every product
// in program order and a warp waits out the whole latency of each before
// the next, which depends on it; these let it interleave independent
// products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// An A fragment or a B fragment in split form.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// d += a * b in split TF32
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// cp.async of `bytes` (0..16) of the 16 at src into 16 bytes of shared
// memory at dst, the rest zero-filled; L2 only (.cg), so it reads what
// other blocks wrote before a barrier.  src must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// the same for one float (bytes 0 or 4), for rows that are not 16-byte
// aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3
