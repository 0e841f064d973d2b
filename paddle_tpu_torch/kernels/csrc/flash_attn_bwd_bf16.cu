// Flash-attention backward for Hopper (sm_90a), bfloat16: K2 (dq) and K3
// (dk, dv) in their bfloat16 mode.
//
// Replace the Pallas kernels paddle_tpu/kernels/attention.py:459
// _flash_bwd_dq_kernel and :507 _flash_bwd_dkv_kernel (launched by
// _pallas_bwd through pl.pallas_call) on bfloat16 q, k, v and dO, the
// dtype their products run in on the TPU.  They compute what
// flash_attn_bwd.cu computes in float32 (the same masks, logical-tile
// visits, dropout bits; lse and delta = rowsum(dO * O) float32 inputs, so
// ring attention can pass its global ones), with the reference's
// bfloat16 arithmetic, every product bfloat16 x bfloat16 with a float32
// sum (mma.sync m16n8k16, bf16_mma.cuh):
//
//   s  = bf16(q * scale_log2) . K^T,  p = exp2(s - lse)
//   dp = (dO . V^T) * drop,           ds = bf16(p * (dp - delta))
//   flash_attn_bwd_dq_bf16:  dq = sm_scale * sum_k ds . K
//   flash_attn_bwd_dkv_bf16: dv = sum_q bf16(p * drop)^T . dO,
//                            dk = sm_scale * sum_q ds^T . q
//
// dk takes the UNscaled q, as the reference does (attention.py:544): the
// float32 K3 reuses its pre-scaled tile and divides by scale_log2, but
// here the pre-scaled tile has been rounded to bfloat16.  dq, dk, dv are
// written in bfloat16.  p is computed from the saved LSE, so the two
// kernels round exactly where the reference does; only the order of the
// float32 sums differs.
//
// Design.  The float32 kernels' shape, without the split.  A block owns
// 64 rows of one (batch, head), one warp per 16 (K2: query rows, with Q
// pre-scaled and rounded, and dO resident; K3: keys, with K and V
// resident), and streams the other side 32 rows a tile (K2: K and V;
// K3: q and dO, and the block writes the tile's pre-scaled copy) through
// a two-stage cp.async ring, with each streamed key's mask value and its
// part of the dropout hash (K2) or each streamed row's lse, delta and
// its part of the hash (K3).  A warp's two score-shaped products (K2: S
// and dP; K3: S^T and dP^T, 16 x 32) take ldmatrix fragments, and their
// C fragments, packed to bfloat16, are the A operands of the products
// that follow (K2: dq += dS . K; K3: dv += (P^T drop) . dO and dk +=
// dS^T . q), whose B fragments are read by ldmatrix.trans.  A warp skips
// a streamed tile whose pairs it does not visit, or, where every row in
// play has softmax mass on an unmasked key, one whose pairs are all
// masked or causally excluded (their p is exactly 0).  Causal K2
// launches its longest q-blocks first.  wgmma and TMA are later work.
//
// Bound.  For B=32, H=8, T=256, D=64: K2 does three products (6 * D
// operations a pair, 3.2 GFLOP, 3.3 us at 989 TFLOP/s dense bf16) on
// 42 MB in bfloat16 (q, k, v, dO read, dq written; mask, lse, delta),
// 12.7 us at 3.35 TB/s; K3 four products (4.3 GFLOP, 4.3 us) on 51 MB,
// 15.2 us.  Both are bound by the bytes.  At B=4, T=8192, causal they
// are bound by the operations: 0.417 ms (K2) and 0.556 ms (K3).
//
// Entry points: flash_attn_bwd_dq_bf16() and flash_attn_bwd_dkv_bf16(),
// plain C functions with flash_attn_bwd_dq()'s and flash_attn_bwd_dkv()'s
// arguments (dkv's scale is sm_scale here), called through ctypes on
// PyTorch's current stream.  Each launches and returns
// cudaGetLastError(); neither synchronises or allocates.
// flash_attn_bwd_bf16_occupancy() reports each kernel's registers, shared
// memory and resident blocks an SM.

#include "bf16_mma.cuh"
#include "flash_attn_common.cuh"

namespace {

using bf16mma::bf16;
using flash::kNegInf;
using Args = flash::ArgsT<bf16>;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kRows = 64;      // rows a block owns (q rows for dq, keys for dk/dv)
constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kTile = 32;      // streamed rows a tile (one a lane)
constexpr int kInfo = 4;       // words of per-row (per-key) info a streamed row
constexpr unsigned kAll = 0xffffffffu;
// a row whose lse is above this has softmax mass on an unmasked key, so a
// masked or causally excluded key gives it p = exp2(-1e30 - lse) = 0
constexpr float kHasMass = -1e29f;

template <int DP>
constexpr size_t dq_smem() {
  // Q, dO [64][DP + 8]; K, V [2][32][DP + 8]; info [2][kInfo][32]
  return sizeof(bf16) * (2 * kRows + 4 * kTile) * (DP + 8) +
         sizeof(uint32_t) * 2 * kInfo * kTile;
}

template <int DP>
constexpr size_t dkv_smem() {
  // K, V [64][DP + 8]; q, dO [2][32][DP + 8]; pre-scaled q [32][DP + 8];
  // info [2][kInfo][32]
  return sizeof(bf16) * (2 * kRows + 5 * kTile) * (DP + 8) +
         sizeof(uint32_t) * 2 * kInfo * kTile;
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]: raw, then pre-scaled
  bf16* Os = Qs + kRows * LD;                    // dO [64][LD]
  bf16* Ks = Os + kRows * LD;                    // [2][32][LD]
  bf16* Vs = Ks + 2 * kTile * LD;                // [2][32][LD]
  uint32_t* info = reinterpret_cast<uint32_t*>(Vs + 2 * kTile * LD);  // [2][kInfo][32]

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  // causal: the last q-blocks visit the most keys, so they are launched
  // first and the short ones fill the tail
  const int row0 = static_cast<int>(a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D;
  const bf16* kbase = a.k + static_cast<size_t>(bh) * Tk * D;
  const bf16* vbase = a.v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = a.mask ? a.mask + static_cast<size_t>(b) * Tk : nullptr;

  // the resident rows land with the first tile (Q is scaled after)
  bf16mma::stage_rows<DP, LD, VEC, kRows, kThreads>(Qs, a.q + qoff, row0, Tq, D, tid);
  bf16mma::stage_rows<DP, LD, VEC, kRows, kThreads>(Os, a.dout + qoff, row0, Tq, D, tid);

  // this thread's two rows (fragment rows g and g + 8 of its warp)
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const uint32_t seed = a.seed ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t threshold = flash::drop_threshold(a.rate);
  float lse[2], delta[2];
  int kend[2];
  uint32_t row_x[2], row_salt[2];
  bool mass = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    const bool ok = row < Tq;
    const size_t ridx = static_cast<size_t>(bh) * Tq + (ok ? row : 0);
    lse[h] = ok ? a.lse[ridx] : 0.0f;
    delta[h] = ok ? a.delta[ridx] : 0.0f;
    kend[h] = ok ? flash::key_end(row, Tk, a.causal, a.bq, a.bk) : 0;
    row_x[h] = flash::drop_row_x(row, a.bq);
    row_salt[h] = flash::drop_row_salt(row, a.bq, seed, bh);
    mass = mass && (!ok || lse[h] > kHasMass);
  }
  const bool wmass = __all_sync(kAll, mass);
  const int wfirst = row0 + warp * 16;
  const int wlast = min(wfirst + 15, Tq - 1);
  const int wkend = wfirst < Tq ? flash::key_end(wlast, Tk, a.causal, a.bq, a.bk) : 0;
  const int last_row = min(row0 + kRows, Tq) - 1;
  const int kend_blk = min(flash::key_end(last_row, Tk, a.causal, a.bq, a.bk), Tk);
  const int ntiles = (kend_blk + kTile - 1) / kTile;

  auto load = [&](int tile, int st) {
    const int k0 = tile * kTile;
    bf16mma::stage_rows<DP, LD, VEC, kTile, kThreads>(Ks + st * kTile * LD, kbase, k0, Tk, D,
                                                      tid);
    bf16mma::stage_rows<DP, LD, VEC, kTile, kThreads>(Vs + st * kTile * LD, vbase, k0, Tk, D,
                                                      tid);
    uint32_t* inf = info + st * kInfo * kTile;
    for (int j = tid; j < kTile; j += kThreads) {
      const int key = k0 + j;
      // the key's mask value (a key is valid where it is > 0), or 1
      if (mrow != nullptr) {
        cp_async4(inf + j, key < Tk ? mrow + key : mrow, key < Tk ? 4 : 0);
      } else {
        inf[j] = __float_as_uint(key < Tk ? 1.0f : 0.0f);
      }
      inf[kTile + j] = flash::drop_key_x(key, a.bk);
      inf[2 * kTile + j] = flash::drop_key_salt(key, a.bk);
    }
  };

  float dq[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.0f;

  load(0, 0);
  cp_async_commit();
  for (int i = 0, st = 0; i < ntiles; ++i, st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with the last one
    if (i + 1 < ntiles) load(i + 1, st ^ 1);
    cp_async_commit();
    if (i == 0) {
      bf16mma::scale_rows<DP, LD, kRows, kThreads>(Qs, Qs, a.scale_log2, tid);
      __syncthreads();
    }
    const int k0 = i * kTile;
    const uint32_t* inf = info + st * kInfo * kTile;
    // a tile is live unless its pairs are unvisited, or every row of the
    // warp has mass and the tile's keys are all masked or causally past
    // the warp's last row
    bool live = k0 < wkend;
    if (live && wmass) {
      live = __any_sync(kAll, __uint_as_float(inf[lane]) > 0.0f) && !(a.causal && k0 > wlast);
    }
    if (live) {
      const bf16* Kt = Ks + st * kTile * LD;
      const bf16* Vt = Vs + st * kTile * LD;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
      }
      bf16mma::mma_abt<DP, 4, LD>(s, Qs + warp * 16 * LD, Kt, lane);
      bf16mma::mma_abt<DP, 4, LD>(dp, Os + warp * 16 * LD, Vt, lane);
      // dS = p * (dP * drop - delta), rounded to bfloat16 as the next
      // product's operand; an unvisited key has p = 0, a masked or
      // causally excluded one scores the finite -1e30
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int jj = nt * 8 + 2 * t + (e & 1);
          const int key = k0 + jj;
          const bool keep = __uint_as_float(inf[jj]) > 0.0f && (!a.causal || key <= rows[h]);
          const float p = (key < kend[h] && key < Tk)
                              ? exp2f((keep ? s[nt][e] : kNegInf) - lse[h])
                              : 0.0f;
          float dpv = dp[nt][e];
          if (a.rate > 0.0f) {
            dpv *= flash::drop_of(row_x[h], row_salt[h], inf[kTile + jj], inf[2 * kTile + jj],
                                  threshold, a.keep_scale);
          }
          s[nt][e] = p * (dpv - delta[h]);
        }
      }
      bf16mma::mma_pb<DP, 4, LD>(dq, s, Kt, lane);
    }
  }
  cp_async_wait<0>();
  bf16mma::store_rows<DP>(a.out + qoff, dq, row0 + warp * 16, Tq, D, a.grad_scale, g, t);
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + kRows * LD;                    // [64][LD]
  bf16* Qr = Vs + kRows * LD;                    // q [2][32][LD]
  bf16* Od = Qr + 2 * kTile * LD;                // dO [2][32][LD]
  bf16* Qp = Od + 2 * kTile * LD;                // the tile's pre-scaled q [32][LD]
  uint32_t* info = reinterpret_cast<uint32_t*>(Qp + kTile * LD);  // [2][kInfo][32]

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int key0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = a.D, Tq = a.Tq, Tk = a.Tk;
  const size_t koff = static_cast<size_t>(bh) * Tk * D;
  const bf16* qbase = a.q + static_cast<size_t>(bh) * Tq * D;
  const bf16* dobase = a.dout + static_cast<size_t>(bh) * Tq * D;
  const float* lbase = a.lse + static_cast<size_t>(bh) * Tq;
  const float* dbase = a.delta + static_cast<size_t>(bh) * Tq;

  // the resident rows land with the first tile
  bf16mma::stage_rows<DP, LD, VEC, kRows, kThreads>(Ks, a.k + koff, key0, Tk, D, tid);
  bf16mma::stage_rows<DP, LD, VEC, kRows, kThreads>(Vs, a.v + koff, key0, Tk, D, tid);

  // this thread's two keys (fragment rows g and g + 8 of its warp)
  const int keys[2] = {key0 + warp * 16 + g, key0 + warp * 16 + g + 8};
  const uint32_t seed = a.seed ? static_cast<uint32_t>(a.seed[0]) : 0u;
  const uint32_t threshold = flash::drop_threshold(a.rate);
  bool valid[2];
  int rbeg[2];
  uint32_t key_x[2], key_salt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = keys[h];
    const bool ok = key < Tk;
    valid[h] = ok && (a.mask == nullptr || a.mask[static_cast<size_t>(b) * Tk + key] > 0.0f);
    rbeg[h] = ok ? flash::row_begin(key, Tq, a.causal, a.bq, a.bk) : Tq;
    key_x[h] = flash::drop_key_x(key, a.bk);
    key_salt[h] = flash::drop_key_salt(key, a.bk);
  }
  const bool wany = __any_sync(kAll, valid[0] || valid[1]);
  const int wfirst = key0 + warp * 16;
  const int wrbeg = wfirst < Tk ? flash::row_begin(wfirst, Tq, a.causal, a.bq, a.bk) : 1 << 30;
  const int ntiles = (Tq + kTile - 1) / kTile;

  auto load = [&](int tile, int st) {
    const int i0 = tile * kTile;
    bf16mma::stage_rows<DP, LD, VEC, kTile, kThreads>(Qr + st * kTile * LD, qbase, i0, Tq, D,
                                                      tid);
    bf16mma::stage_rows<DP, LD, VEC, kTile, kThreads>(Od + st * kTile * LD, dobase, i0, Tq, D,
                                                      tid);
    uint32_t* inf = info + st * kInfo * kTile;
    for (int j = tid; j < kTile; j += kThreads) {
      const int row = i0 + j;
      const bool ok = row < Tq;
      cp_async4(inf + j, ok ? lbase + row : lbase, ok ? 4 : 0);
      cp_async4(inf + kTile + j, ok ? dbase + row : dbase, ok ? 4 : 0);
      inf[2 * kTile + j] = flash::drop_row_x(row, a.bq);
      inf[3 * kTile + j] = flash::drop_row_salt(row, a.bq, seed, bh);
    }
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.0f;
  }

  // the block starts at the reference's clamped first q-block of its
  // first key (_first_qb), a multiple of bq and so of the tile
  const int t0 = flash::row_begin(key0, Tq, a.causal, a.bq, a.bk) / kTile;
  load(t0, 0);
  cp_async_commit();
  for (int i = t0, st = 0; i < ntiles; ++i, st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with the last one
    if (i + 1 < ntiles) load(i + 1, st ^ 1);
    cp_async_commit();
    const bf16* Qt = Qr + st * kTile * LD;
    const bf16* Ot = Od + st * kTile * LD;
    bf16mma::scale_rows<DP, LD, kTile, kThreads>(Qp, Qt, a.scale_log2, tid);
    __syncthreads();
    const int i0 = i * kTile;
    const uint32_t* inf = info + st * kInfo * kTile;
    // a row tile is live unless its pairs are unvisited, or every row of
    // it has mass and the warp's keys are all masked or causally past the
    // tile's last row
    bool live = i0 + kTile > wrbeg;
    if (live && __all_sync(kAll, i0 + lane >= Tq || __uint_as_float(inf[lane]) > kHasMass)) {
      live = wany && !(a.causal && i0 + kTile - 1 < wfirst);
    }
    if (live) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
      }
      // S^T = K . Qp^T and dP^T = V . dO^T, 16 keys x 32 rows
      bf16mma::mma_abt<DP, 4, LD>(s, Ks + warp * 16 * LD, Qp, lane);
      bf16mma::mma_abt<DP, 4, LD>(dp, Vs + warp * 16 * LD, Ot, lane);
      // P^T * drop into s, dS^T = P^T * (dP^T * drop - delta) into dp,
      // both rounded to bfloat16 as the next products' operands; an
      // unvisited row has p = 0, a masked or causally excluded key scores
      // the finite -1e30
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int jj = nt * 8 + 2 * t + (e & 1);
          const int row = i0 + jj;
          const bool keep = valid[h] && (!a.causal || keys[h] <= row);
          const float p = (row >= rbeg[h] && row < Tq)
                              ? exp2f((keep ? s[nt][e] : kNegInf) - __uint_as_float(inf[jj]))
                              : 0.0f;
          float drop = 1.0f;
          if (a.rate > 0.0f) {
            drop = flash::drop_of(inf[2 * kTile + jj], inf[3 * kTile + jj], key_x[h],
                                  key_salt[h], threshold, a.keep_scale);
          }
          s[nt][e] = p * drop;
          dp[nt][e] = p * (dp[nt][e] * drop - __uint_as_float(inf[kTile + jj]));
        }
      }
      bf16mma::mma_pb<DP, 4, LD>(dv, s, Ot, lane);
      bf16mma::mma_pb<DP, 4, LD>(dk, dp, Qt, lane);  // the unscaled q
    }
  }
  cp_async_wait<0>();
  bf16mma::store_rows<DP>(a.dk + koff, dk, key0 + warp * 16, Tk, D, a.grad_scale, g, t);
  bf16mma::store_rows<DP>(a.dv + koff, dv, key0 + warp * 16, Tk, D, 1.0f, g, t);
}

template <typename K>
cudaError_t launch_kernel(K kernel, const Args& a, int n_own, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (n_own + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t st) {
  return bf16mma::vec_ok(a.D, a.q, a.k, a.v, a.dout)
             ? launch_kernel(flash_bwd_dq_bf16_kernel<DP, true>, a, a.Tq, dq_smem<DP>(), st)
             : launch_kernel(flash_bwd_dq_bf16_kernel<DP, false>, a, a.Tq, dq_smem<DP>(), st);
}

template <int DP>
cudaError_t launch_dkv(const Args& a, cudaStream_t st) {
  return bf16mma::vec_ok(a.D, a.q, a.k, a.v, a.dout)
             ? launch_kernel(flash_bwd_dkv_bf16_kernel<DP, true>, a, a.Tk, dkv_smem<DP>(), st)
             : launch_kernel(flash_bwd_dkv_bf16_kernel<DP, false>, a, a.Tk, dkv_smem<DP>(), st);
}

// registers a thread, static and dynamic shared memory a block, resident
// blocks an SM
template <typename K>
cudaError_t occupancy(K kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return cudaSuccess;
}

template <int DP>
cudaError_t occupancy_dp(int* out) {
  cudaError_t err = occupancy(flash_bwd_dq_bf16_kernel<DP, true>, dq_smem<DP>(), out);
  if (err != cudaSuccess) return err;
  return occupancy(flash_bwd_dkv_bf16_kernel<DP, true>, dkv_smem<DP>(), out + 4);
}

bool bad_shape(int B, int H, int Tq, int Tk, int D, int bq, int bk) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 || bq <= 0 || bk <= 0 ||
         (Tq + kRows - 1) / kRows > 65535 || (Tk + kRows - 1) / kRows > 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* mask, const void* seed,
               const void* dout, const void* lse, const void* delta, int B, int H, int Tq,
               int Tk, int D, int causal, float scale_log2, float grad_scale, float rate,
               float keep_scale, int bq, int bk) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const float*>(mask);
  a.seed = static_cast<const int32_t*>(seed);
  a.dout = static_cast<const bf16*>(dout);
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

// q/dout/dq [B, H, Tq, D], k/v [B, H, Tk, D] bfloat16; mask [B, Tk]
// float32 or null; seed [1] int32 or null; lse/delta [B*H, Tq] float32.
// dq_scale is sm_scale.  All contiguous and on `device`; the launch goes
// to `stream`.  Returns a cudaError_t.
int flash_attn_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* mask,
                           const void* seed, const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Tq, int Tk, int D,
                           int causal, float scale_log2, float dq_scale, float rate,
                           float keep_scale, int bq, int bk, int device, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D, bq, bk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = make_args(q, k, v, mask, seed, dout, lse, delta, B, H, Tq, Tk, D, causal, scale_log2,
                     dq_scale, rate, keep_scale, bq, bk);
  a.out = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(launch_dq<32>(a, st));
  if (D <= 64) return static_cast<int>(launch_dq<64>(a, st));
  return static_cast<int>(launch_dq<128>(a, st));
}

// as flash_attn_bwd_dq_bf16, writing dk/dv [B, H, Tk, D] bfloat16;
// dk_scale is sm_scale (dk takes the unscaled q).
int flash_attn_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* mask,
                            const void* seed, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B, int H, int Tq, int Tk,
                            int D, int causal, float scale_log2, float dk_scale, float rate,
                            float keep_scale, int bq, int bk, int device, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D, bq, bk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = make_args(q, k, v, mask, seed, dout, lse, delta, B, H, Tq, Tk, D, causal, scale_log2,
                     dk_scale, rate, keep_scale, bq, bk);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return static_cast<int>(launch_dkv<32>(a, st));
  if (D <= 64) return static_cast<int>(launch_dkv<64>(a, st));
  return static_cast<int>(launch_dkv<128>(a, st));
}

// out[0..3]: K2's registers a thread, static and dynamic shared memory
// (bytes) a block and resident blocks an SM at head dim D (D % 8 == 0);
// out[4..7]: the same for K3.  Returns a cudaError_t.
int flash_attn_bwd_bf16_occupancy(int D, int device, int* out) {
  if (D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D <= 32) return static_cast<int>(occupancy_dp<32>(out));
  if (D <= 64) return static_cast<int>(occupancy_dp<64>(out));
  return static_cast<int>(occupancy_dp<128>(out));
}

const char* flash_attn_bwd_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
