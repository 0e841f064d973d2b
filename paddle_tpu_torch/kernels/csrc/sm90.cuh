// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers,
// TMA tile loads (and the host's tensor maps for them), the 128-byte
// swizzled panel layout and plain-load staging into it, warpgroup matrix
// products (wgmma) and register rebalancing between warpgroups
// (setmaxnreg).  Used by flash_attn_fwd_bf16.cu (K1 in bfloat16) and
// flash_attn_bwd_bf16.cu (K2, K3 in bfloat16).
//
// Shared-memory tiles are bfloat16 in "panels" of 64 columns: row r of a
// panel is 128 bytes at r * 128, with its eight 16-byte chunks permuted
// by the 128-byte swizzle (chunk c lands at c ^ (r % 8)), the layout a
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes and a wgmma descriptor
// of layout type B128 reads.  Every panel starts on a 1024-byte boundary.
// A D-wide row takes DP / 64 panels (DP = 64 or 128), columns past D are
// zero.
//
// wgmma.m64nNk16 with float32 sums (bfloat16 operands): the warpgroup's
// 128 threads hold the 64 x N product as mma.sync m16n8 C fragments,
// warp w rows 16w..16w+15 and, for each n8 chunk j, d[4j + 0..1] = row
// g, columns 8j + 2t, +1 and d[4j + 2..3] = row g + 8 (lane = 4g + t).
// An A operand from registers is the m16n8k16 A fragment of the warp's
// 16 rows, so the C fragments of two neighbouring chunks packed to
// bfloat16 (pack_bf16x2) are the A operand of the next product: P . V in
// K1, dS . K, P^T . dO and dS^T . q in K2/K3.
#pragma once

#include <cuda.h>  // CUtensorMap (the driver is reached through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy writes to shared memory become visible to the async
// proxy (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `count` threads (a multiple of 32) under id `id` (1..15)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA -----------------------------------------------------------------

// the box at (c0, c1, c2) of a 3-D tensor map into shared memory at
// `dst`, completing `bytes` (the whole box) on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- register rebalancing ------------------------------------------------

// a warpgroup's registers a thread raised to N (taken from those the
// block's other warpgroups released) or lowered to N, for the code that
// follows
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ---------------------------------------------------------------

// shared-memory matrix descriptor, layout B128: start address, leading
// and stride byte offsets (K-major: SBO = 1024, the 8-row group; LBO
// unused.  MN-major: SBO = 1024 between 8-deep K groups, LBO between
// 64-wide panels of the MN dimension)
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of accumulator registers
// across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N) += A . B, bfloat16 operands, float32 sums.  ss: A (64 x 16,
// K-major) and B from shared memory; rs: A from registers.  TB = 1 reads
// B MN-major (B[k][n] with n contiguous), 0 K-major.  acc = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc), "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(acc), "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t const (&a)[4], uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc), "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t const (&a)[4], uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc), "n"(TB)
      : "memory");
}

// ---- panel tiles -----------------------------------------------------------

constexpr int kPanelRow = 128;  // bytes of a panel row (64 bfloat16)

// bytes of an R-row tile of DP columns (DP / 64 panels)
template <int DP>
__host__ __device__ constexpr int tile_bytes(int R) {
  return (DP / 64) * R * kPanelRow;
}

// byte offset of element (r, c) in an R-row panel tile
__device__ __forceinline__ int swz(int r, int c, int R) {
  return (c >> 6) * R * kPanelRow + r * kPanelRow + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}

// rows r0..r0+R-1 of an [n_rows, D] bfloat16 matrix into an R-row panel
// tile, zero past n_rows and D, by plain loads of NT threads (a
// producer's path where TMA cannot describe the tensor); `scaled`, if
// given, receives bf16(x * scale) at the same place
template <int DP, int R, int NT>
__device__ void stage_plain(unsigned char* dst, const __nv_bfloat16* src, int r0, int n_rows,
                            int D, int tid, unsigned char* scaled = nullptr,
                            float scale = 0.0f) {
  for (int i = tid; i < R * DP; i += NT) {
    const int r = i / DP, c = i - r * DP;
    const bool ok = r0 + r < n_rows && c < D;
    const __nv_bfloat16 x =
        ok ? src[static_cast<size_t>(r0 + r) * D + c] : __float2bfloat16_rn(0.0f);
    const int off = swz(r, c, R);
    *reinterpret_cast<__nv_bfloat16*>(dst + off) = x;
    if (scaled != nullptr) {
      *reinterpret_cast<__nv_bfloat16*>(scaled + off) =
          __float2bfloat16_rn(__bfloat162float(x) * scale);
    }
  }
}

// an R-row tile by TMA: one box of 64 columns a panel, rows row.. of
// (batch, head) bh
template <int DP, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
#pragma unroll
  for (int p = 0; p < DP / 64; ++p) {
    tma_load_3d(dst + p * R * kPanelRow, map, bar, p * 64, row, bh);
  }
}

// dst = bf16(float(src) * scale) over `bytes` of bfloat16 (the
// reference's _scaled_q), 16 bytes a thread at a time
__device__ __forceinline__ void scale_bytes(unsigned char* dst, const unsigned char* src,
                                            int bytes, float scale, int tid, int nthreads) {
  for (int i = tid * 16; i < bytes; i += nthreads * 16) {
    uint4 v = *reinterpret_cast<const uint4*>(src + i);
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
      const __nv_bfloat162 y =
          __floats2bfloat162_rn(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
      w[j] = *reinterpret_cast<const uint32_t*>(&y);
    }
    *reinterpret_cast<uint4*>(dst + i) = v;
  }
}

// the dynamic shared memory's first 1024-byte boundary (launches ask for
// 1024 bytes more than their layout)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// ---- a producer's ring of stages -------------------------------------------

// barriers: [0] the resident rows; load (the TMA bytes), full (the
// producer's own writes), empty (the consumers are done) a stage
struct Bars {
  uint64_t* res;
  uint64_t* load;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Bars bars_at(unsigned char* p, int stages) {
  uint64_t* b = reinterpret_cast<uint64_t*>(p);
  return Bars{b, b + 1, b + 1 + stages, b + 1 + 2 * stages};
}

// `producers` threads arrive on res and full, `consumers` on empty
__device__ __forceinline__ void init_bars(const Bars& b, int stages, int producers,
                                          int consumers) {
  if (threadIdx.x == 0) {
    mbar_init(b.res, producers);
    for (int s = 0; s < stages; ++s) {
      mbar_init(b.load + s, 1);
      mbar_init(b.full + s, producers);
      mbar_init(b.empty + s, consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// ---- values in registers ---------------------------------------------------

// a value read from shared memory, the same in every lane, broadcast from
// lane 0 so that the compiler sees it uniform: a branch on it is not
// divergent, and wgmma groups inside stay whole
__device__ __forceinline__ int uniform(int x) { return __shfl_sync(0xffffffffu, x, 0); }

// 2^x (ex2.approx: 2 ulp; -1e30 and -inf give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bfloat16 in one 32-bit word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- host: TMA tensor maps -------------------------------------------------

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime's cudaGetDriverEntryPoint, so a library needs no -lcuda
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// the 3-D view [BH, T, D] of a bfloat16 tensor, boxes of 64 columns x
// `rows` rows of one (batch, head), 128-byte swizzle, zeros out of bounds
// (rows past T, columns past D).  TMA needs D % 8 == 0 (a row stride of
// 16 bytes) and a 16-byte aligned base: see aligned16.
inline bool encode(CUtensorMap* m, const void* base, int BH, int T, int D, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace sm90
