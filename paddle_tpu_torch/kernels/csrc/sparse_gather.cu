// Fused multi-table embedding gather for Hopper (sm_90a), float32: K9.
//
// Replaces the Pallas kernel paddle_tpu/kernels/sparse.py _gather_kernel
// (launched by fused_gather through pl.pallas_call): ONE launch gathers
// the same id batch from k <= 4 tables, out_t[i, :] = table_t[ids[i], :].
// Ids in [-H_t, 0) wrap to id + H_t; an id outside [-H_t, H_t) writes a
// NaN row, here in the kernel (the TPU version NaN-filled in a second
// XLA pass), so a data bug in the feed fails the step loudly.  It is a
// copy: the output equals fused_gather_ref (and jnp.take) bit for bit,
// on every run and every stream.
//
// Bound.  At the DeepFM bench batch (n = 2048 x 26 = 53,248 int64 ids,
// tables [1e6, 10] and [1e6, 1] float32) the function moves 0.43 MB of
// ids, 2.34 MB of rows read and 2.34 MB written: 5.0 MB, 1.5 us at 3.35
// TB/s; the rows sit at random addresses, so counted as the 32-byte
// sectors they span it is 7.3 MB, 2.2 us.  That is about the 2-3 MB the
// card must keep in flight for 0.6-0.8 us to hold its bandwidth busy:
// the gather is bound by latency and by the loads in flight, and each
// item needs two dependent loads, its id and then its row.
//
// Design.  The TPU walked a grid of one id per step, each step's row
// block chosen by a scalar-prefetched index map.  Here:
// - Each table is read in pieces of the widest vector (16, 8 or 4 bytes)
//   that its width, its base and its output's base allow: a table that
//   starts at any row (base[1:]) still takes 8-byte pieces at D = 10.
//   Table t's work is its n * D_t / vec pieces, item x being piece
//   x % per_row of id x / per_row, and its output is those pieces in
//   the same order, so the stores of a warp are one contiguous run.
// - The grid is at most one wave (kBlocksPerSm blocks on every SM), its
//   blocks split between the tables in proportion to their pieces.  A
//   thread holds up to kItems items a round, strided by its table's
//   thread count: it loads all their ids, then all their row pieces,
//   then stores them, so a round pays the two latencies once.  (row,
//   piece) of the next item follows by adding the stride's quotient and
//   remainder: one division a thread, none an item.
// - Ids are read as they come, int32 or int64; the index math is 32-bit
//   while n * sum(D_t) < 2^31 and 64-bit beyond.
//
// Entry point: sparse_gather(), a plain C function called through
// ctypes on PyTorch's current stream with one packed argument block.  It
// returns 0 or a cudaError_t; it never synchronises and allocates
// nothing.  n = 0 launches nothing.  It switches the calling thread's
// device only when the current one is not the tensors', and switches it
// back after the launch.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxTables = 4;
constexpr int kThreads = 256;
// A wave is kBlocksPerSm blocks an SM: 2,048 threads, so at most 32
// registers a thread, which holds kItems items in flight.
constexpr int kBlocksPerSm = 8;
constexpr int kItems = 2;
constexpr int kMaxDevices = 64;

// The block sparse.py packs (struct format "<Qq8Q4q8i", 144 bytes).
struct GatherParams {
  uint64_t ids;
  int64_t n;
  uint64_t table[kMaxTables];
  uint64_t out[kMaxTables];
  int64_t height[kMaxTables];
  int32_t width[kMaxTables];
  int32_t k;
  int32_t id_bytes;  // 4 or 8
  int32_t device;
  int32_t reserved;
};
// sparse.py packs the fields at these offsets (its tests read them here)
static_assert(offsetof(GatherParams, ids) == 0, "GatherParams.ids");
static_assert(offsetof(GatherParams, n) == 8, "GatherParams.n");
static_assert(offsetof(GatherParams, table) == 16, "GatherParams.table");
static_assert(offsetof(GatherParams, out) == 48, "GatherParams.out");
static_assert(offsetof(GatherParams, height) == 80, "GatherParams.height");
static_assert(offsetof(GatherParams, width) == 112, "GatherParams.width");
static_assert(offsetof(GatherParams, k) == 128, "GatherParams.k");
static_assert(offsetof(GatherParams, id_bytes) == 132, "GatherParams.id_bytes");
static_assert(offsetof(GatherParams, device) == 136, "GatherParams.device");
static_assert(offsetof(GatherParams, reserved) == 140, "GatherParams.reserved");
static_assert(sizeof(GatherParams) == 144, "GatherParams must match sparse.py");

struct Table {
  const float* src;
  float* dst;
  int64_t height;
  int64_t items;      // n * per_row
  int32_t per_row;    // vector pieces a row
  int32_t vec;        // floats a piece: 1, 2 or 4
  int32_t first_block;
  int32_t blocks;
};

struct KernelArgs {
  const void* ids;
  Table t[kMaxTables];
  int32_t k;
};

template <typename Vec>
__device__ __forceinline__ Vec nan_piece();
template <>
__device__ __forceinline__ float nan_piece<float>() {
  return __int_as_float(0x7fc00000);  // quiet NaN, as torch.full(nan)
}
template <>
__device__ __forceinline__ float2 nan_piece<float2>() {
  const float q = __int_as_float(0x7fc00000);
  return make_float2(q, q);
}
template <>
__device__ __forceinline__ float4 nan_piece<float4>() {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

// Items x, x + threads, ... of one table, kItems a round.
template <typename Vec, typename Id, typename Index>
__device__ __forceinline__ void gather_table(const Id* __restrict__ ids, const Table& tb,
                                             Index x, const Index threads) {
  const Index total = static_cast<Index>(tb.items);
  const Index per_row = static_cast<Index>(tb.per_row);
  const Vec* __restrict__ src = reinterpret_cast<const Vec*>(tb.src);
  Vec* __restrict__ dst = reinterpret_cast<Vec*>(tb.dst);
  const int64_t h = tb.height;
  Index i = x / per_row;  // the id of item x, and its piece
  Index c = x - i * per_row;
  const Index di = threads / per_row;  // one stride in ids and pieces
  const Index dc = threads - di * per_row;
  while (x < total) {
    Index xs[kItems], cs[kItems];
    Id id[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      xs[u] = x;
      cs[u] = c;
      id[u] = x < total ? __ldg(ids + i) : Id(0);
      x += threads;
      i += di;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++i;
      }
    }
    Vec v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int64_t r = static_cast<int64_t>(id[u]);
      if (xs[u] < total && r >= -h && r < h) {
        const int64_t row = r < 0 ? r + h : r;
        v[u] = __ldg(src + row * tb.per_row + static_cast<int64_t>(cs[u]));
      } else {
        v[u] = nan_piece<Vec>();
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      if (xs[u] < total) dst[xs[u]] = v[u];
  }
}

template <typename Id, typename Index>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    sparse_gather_kernel(const KernelArgs a) {
  // this block's table: the blocks are split between them in order
  Table tb = a.t[0];
#pragma unroll
  for (int s = 1; s < kMaxTables; ++s)
    if (s < a.k && static_cast<int>(blockIdx.x) >= a.t[s].first_block) tb = a.t[s];
  const Index x = static_cast<Index>(blockIdx.x - tb.first_block) * kThreads + threadIdx.x;
  const Index threads = static_cast<Index>(tb.blocks) * kThreads;
  const Id* ids = static_cast<const Id*>(a.ids);
  if (tb.vec == 4)
    gather_table<float4>(ids, tb, x, threads);
  else if (tb.vec == 2)
    gather_table<float2>(ids, tb, x, threads);
  else
    gather_table<float>(ids, tb, x, threads);
}

std::atomic<int> g_sms[kMaxDevices];  // SMs of each device, 0 until asked

cudaError_t sm_count(int device, int* sms) {
  if (device >= 0 && device < kMaxDevices) {
    *sms = g_sms[device].load(std::memory_order_relaxed);
    if (*sms > 0) return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    g_sms[device].store(*sms, std::memory_order_relaxed);
  return err;
}

// floats a piece: the widest vector the width and both bases allow
int piece(int width, uint64_t src, uint64_t dst) {
  const uint64_t bases = src | dst;
  if (width % 4 == 0 && bases % 16 == 0) return 4;
  if (width % 2 == 0 && bases % 8 == 0) return 2;
  return 1;
}

template <typename Id, typename Index>
cudaError_t launch(const KernelArgs& a, int blocks, cudaStream_t stream) {
  sparse_gather_kernel<Id, Index><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The kernel's arguments and its blocks for these params.
cudaError_t plan(const GatherParams& p, KernelArgs* args, int* blocks_out) {
  int sms = 0;
  cudaError_t err = sm_count(p.device, &sms);
  if (err != cudaSuccess) return err;
  const int wave = sms * kBlocksPerSm;
  KernelArgs& a = *args;
  a = KernelArgs{};
  a.ids = reinterpret_cast<const void*>(p.ids);
  a.k = p.k;
  int64_t all = 0;
  for (int t = 0; t < p.k; ++t) {
    Table& tb = a.t[t];
    tb.src = reinterpret_cast<const float*>(p.table[t]);
    tb.dst = reinterpret_cast<float*>(p.out[t]);
    tb.height = p.height[t];
    tb.vec = piece(p.width[t], p.table[t], p.out[t]);
    tb.per_row = p.width[t] / tb.vec;
    tb.items = p.n * tb.per_row;
    all += tb.items;
  }
  // items a thread: enough to fill one wave, at most kItems a round
  const int64_t wave_threads = static_cast<int64_t>(wave) * kThreads;
  int64_t per_thread = (all + wave_threads - 1) / wave_threads;
  per_thread = per_thread < 1 ? 1 : (per_thread > kItems ? kItems : per_thread);
  int64_t blocks = 0;
  for (int t = 0; t < p.k; ++t) {
    const int64_t per_block = kThreads * per_thread;
    const int64_t need = (a.t[t].items + per_block - 1) / per_block;
    a.t[t].blocks = static_cast<int32_t>(need < wave ? need : wave);
    blocks += a.t[t].blocks;
  }
  if (blocks > wave) {  // more than a wave: split it by the tables' items
    blocks = 0;
    for (int t = 0; t < p.k; ++t) {
      const int64_t share = static_cast<int64_t>(wave) * a.t[t].items / all;
      a.t[t].blocks = static_cast<int32_t>(share < 1 ? 1 : share);
      blocks += a.t[t].blocks;
    }
  }
  for (int t = 0, first = 0; t < p.k; ++t) {
    a.t[t].first_block = first;
    first += a.t[t].blocks;
  }
  *blocks_out = static_cast<int>(blocks);
  return cudaSuccess;
}

// The packed params, checked; n = 0 needs no pointers.
cudaError_t unpack(const void* params, GatherParams* p) {
  if (params == nullptr) return cudaErrorInvalidValue;
  std::memcpy(p, params, sizeof(*p));
  if (p->k < 1 || p->k > kMaxTables || p->n < 0 || (p->id_bytes != 4 && p->id_bytes != 8))
    return cudaErrorInvalidValue;
  if (p->n == 0) return cudaSuccess;
  if (p->ids == 0) return cudaErrorInvalidValue;
  for (int t = 0; t < p->k; ++t)
    if (p->table[t] == 0 || p->out[t] == 0 || p->height[t] < 1 || p->width[t] < 1)
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// params: the packed GatherParams (ids [n] int32 or int64; table_t
// [height_t, width_t] float32 and out_t [n, width_t] float32 for t < k,
// all contiguous on its device).  Returns 0 or a cudaError_t.
int sparse_gather(const void* params, void* stream) {
  GatherParams p;
  cudaError_t err = unpack(params, &p);
  if (err != cudaSuccess || p.n == 0) return static_cast<int>(err);
  int current = -1;
  if ((err = cudaGetDevice(&current)) != cudaSuccess) return static_cast<int>(err);
  const bool other = current != p.device;
  if (other && (err = cudaSetDevice(p.device)) != cudaSuccess) return static_cast<int>(err);
  KernelArgs a;
  int blocks = 0;
  err = plan(p, &a, &blocks);
  if (err == cudaSuccess) {
    int64_t sum_width = 0;
    for (int t = 0; t < p.k; ++t) sum_width += p.width[t];
    const bool narrow = p.n * sum_width < (int64_t{1} << 31);
    const auto s = static_cast<cudaStream_t>(stream);
    if (p.id_bytes == 4)
      err = narrow ? launch<int32_t, uint32_t>(a, blocks, s)
                   : launch<int32_t, uint64_t>(a, blocks, s);
    else
      err = narrow ? launch<int64_t, uint32_t>(a, blocks, s)
                   : launch<int64_t, uint64_t>(a, blocks, s);
  }
  if (other) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

const char* sparse_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
