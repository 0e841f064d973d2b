// Pieces of the fused GRU forward (gru_fwd.cu, K8a).
//
// The launch, the grid barrier and the per-block products come from
// lstm_common.cuh: one cooperative persistent grid for the whole
// sequence; block x owns kUnits consecutive hidden units
// j0 = x * kUnits .. j0 + kUnits - 1.  The weight w [H, 3H] holds the
// gates [update | reset | candidate]; column c of a block's slice of
// ng gates starting at gate g0 is gate g0 + c / kUnits of unit
// c % kUnits.
//
// Float32 throughout (FFMA on the CUDA cores, no tensor cores), as the
// reference keeps h and every product in float32.  K8b (gru_bwd.cu) has
// its own layouts, in split TF32.

#pragma once

#include "lstm_common.cuh"

namespace gru {

using lstm::kRows;
using lstm::kThreads;
using lstm::kTile;
using lstm::kTileFloats;
using lstm::kUnits;
using lstm::round_up;

constexpr int kUZ = 2 * kUnits;  // update and reset columns of a block's units

// Ws[k][c] = w[k][(g0 + c / kUnits) * H + j0 + c % kUnits] for k < H and a
// unit < H, else 0; Ws has round_up(H, kTile) rows of ng * kUnits columns.
__device__ __forceinline__ void load_gate_cols(const float* w, int H, int j0, int g0, int ng,
                                               float* Ws) {
  const int Hp = round_up(H, kTile);
  const int nc = ng * kUnits;
  for (int idx = threadIdx.x; idx < Hp * nc; idx += kThreads) {
    const int k = idx / nc;
    const int c = idx - k * nc;
    const int j = j0 + c % kUnits;
    Ws[idx] = (k < H && j < H)
                  ? w[static_cast<size_t>(k) * 3 * H + (g0 + c / kUnits) * H + j]
                  : 0.0f;
  }
}

// Wr[n][u] = w[j0 + u][n0 + n] for n < N and a unit < H, else 0: the rows
// of this block's units over the columns n0 .. n0 + N - 1, transposed;
// Wr has round_up(N, kTile) rows of kUnits columns.
__device__ __forceinline__ void load_unit_rows(const float* w, int H, int j0, int n0, int N,
                                               float* Wr) {
  const int Np = round_up(N, kTile);
  for (int idx = threadIdx.x; idx < Np * kUnits; idx += kThreads) {
    const int n = idx / kUnits;
    const int j = j0 + idx % kUnits;
    Wr[idx] = (n < N && j < H) ? w[static_cast<size_t>(j) * 3 * H + n0 + n] : 0.0f;
  }
}

}  // namespace gru
