// Runs of equal indices over K raw indices stable-sorted by the wrapper
// (torch.sort, with the sort's permutation `order`), for the row-sparse
// prototypes of proto_adagrad.cu.
//
// A sorted position b heads a run when its row is real ([0, n_rows): the
// int32-max sentinel of masked lanes and padding rows are dropped) and
// differs from position b - 1. The run's gradient rows are summed in sorted
// order (the dedup: deterministic, no atomics).

#pragma once

#include <stdint.h>

__device__ __forceinline__ bool is_run_head(const int32_t* sidx, int b,
                                            int n_rows) {
  const int r = sidx[b];
  return (unsigned)r < (unsigned)n_rows && (b == 0 || sidx[b - 1] != r);
}

// One past the last sorted position of the run that starts at b.
__device__ __forceinline__ int run_end(const int32_t* sidx, int b, int K) {
  const int r = sidx[b];
  int e = b + 1;
  while (e < K && sidx[e] == r) ++e;
  return e;
}

// s plus column c of the gradient rows at sorted positions [b, e) of the
// (K, d) gradient g, added in sorted order.
__device__ __forceinline__ float run_sum(const float* g, const int64_t* order,
                                         int b, int e, int d, int c,
                                         float s = 0.f) {
  for (int k = b; k < e; ++k) s += g[order[k] * (int64_t)d + c];
  return s;
}
