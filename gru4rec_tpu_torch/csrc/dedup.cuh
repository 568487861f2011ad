// The sort-free dedup of a row-sparse update's raw indices, shared by
// csrc/sparse_update.cu (K1-K4) and csrc/proto_adagrad.cu (P1, P2).
//
// A raw position p heads its run when its row is real and no q < p holds
// the same row; the head sums the gradient rows of its run in ascending raw
// position, the order of a stable sort. A block holds the rows of some of
// its positions (one per warp, or a tile of them). It reads the K indices
// once, coalesced (from L2 after the first blocks), UNROLL per thread at a
// time (first_round, then scan), and compares each with its rows. A match
// is rare (another position of one of its rows, note_match): below the
// position it marks the position as no head, above it appends it to the
// position's list in shared memory (kRunCap kept, in no order) and
// prefetches its gradient row into L2. The head ranks its list into
// ascending order (rank_list); a run longer than kRunCap walks the indices
// again (for_each_later). The pass costs K^2 / T index loads and K^2
// compares per call for T positions per block.
//
// An index is narrowed to int32 as idx.to(torch.int32) does; a row outside
// [0, n_rows) (the int32-max sentinel of masked lanes, a padding row) is
// dropped.

#pragma once

#include <stdint.h>

#include <climits>

namespace dedup {

constexpr int kRunCap = 32;  // further positions of a run listed
constexpr unsigned kFull = 0xFFFFFFFFu;

// A raw index narrowed to int32 if it names a row in [0, n_rows), else -1.
template <typename IT>
__device__ __forceinline__ int real_row(IT raw, int n_rows) {
  const int r = static_cast<int>(static_cast<uint32_t>(raw));
  return (unsigned)r < (unsigned)n_rows ? r : -1;
}

// Raw index q of the int32 or (idx64) int64 indices, as real_row gives it.
__device__ __forceinline__ int row_at(const void* idx, int idx64, int q, int n_rows) {
  return idx64 ? real_row(static_cast<const int64_t*>(idx)[q], n_rows)
               : real_row(static_cast<const int32_t*>(idx)[q], n_rows);
}

// The rows of this thread's first round of the pass: positions
// threadIdx.x + u * THREADS, -1 past K.
template <int THREADS, int UNROLL>
__device__ __forceinline__ void first_round(int (&v)[UNROLL], const void* idx, int idx64,
                                            int K, int n_rows) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int q = threadIdx.x + u * THREADS;
    v[u] = q < K ? row_at(idx, idx64, q, n_rows) : -1;
  }
}

// The pass: match(x, q) for every raw position q with its row x (-1 if not
// real), the block's THREADS threads UNROLL at a time; v holds the first
// round (first_round), loaded early so that it is in flight with the
// caller's own loads.
template <int THREADS, int UNROLL, typename Match>
__device__ __forceinline__ void scan(int (&v)[UNROLL], const void* idx, int idx64, int K,
                                     int n_rows, Match match) {
  for (int q0 = threadIdx.x;;) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) match(v[u], q0 + u * THREADS);
    q0 += UNROLL * THREADS;
    if (q0 >= K) break;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = q0 + u * THREADS;
      v[u] = q < K ? row_at(idx, idx64, q, n_rows) : -1;
    }
  }
}

// The runs of the block's positions, in shared memory, by the position's
// number k in the block.
struct Runs {
  int* earlier;           // an earlier position holds its row
  int* nlater;            // later positions that hold it
  int (*later)[kRunCap];  // the first kRunCap of them
};

// Position q holds the row of the block's k-th position pk: q < pk marks
// pk as no head; q > pk is listed, and the first `cols` columns of its
// gradient row (of width d in g) go to L2.
__device__ __forceinline__ void note_match(const Runs& s, int k, int pk, int q, const float* g,
                                           int d, int cols) {
  if (q == pk) return;
  if (q < pk) {
    s.earlier[k] = 1;
    return;
  }
  const int m = atomicAdd(&s.nlater[k], 1);
  if (m < kRunCap) {
    s.later[k][m] = q;
    for (int c = 0; c < cols; c += 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(g + (int64_t)q * d + c));
  }
}

// The match of row x at position q with N rows held in registers, those of
// the block's positions p0 .. p0 + N - 1 (-2 where none).
template <int N>
__device__ __forceinline__ void match_rows(const int (&rows)[N], int x, int q, int p0,
                                           const Runs& s, const float* g, int d, int cols) {
  bool hit = false;
#pragma unroll
  for (int k = 0; k < N; ++k) hit |= x == rows[k];
  if (!hit) return;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (x == rows[k]) note_match(s, k, p0 + k, q, g, d, cols);
}

// Ranks a warp's list of n <= kRunCap positions into ascending order in
// place; every lane of the warp calls it.
__device__ __forceinline__ void rank_list(int* list, int n, int lane) {
  const int q = lane < n ? list[lane] : INT_MAX;
  int rank = 0;
  for (int k = 0; k < n; ++k) rank += __shfl_sync(kFull, q, k) < q;
  __syncwarp();
  if (lane < n) list[rank] = q;
  __syncwarp();
}

// fn(q) for every position q > p that holds row r, in ascending q: the
// walk of a run longer than its list. Every lane of the warp calls it.
template <typename Fn>
__device__ __forceinline__ void for_each_later(const void* idx, int idx64, int K, int n_rows,
                                               int p, int r, int lane, Fn fn) {
  for (int q0 = p + 1; q0 < K; q0 += 32) {
    const int q = q0 + lane;
    const int rq = q < K ? row_at(idx, idx64, q, n_rows) : -1;
    for (uint32_t m = __ballot_sync(kFull, rq == r); m; m &= m - 1) fn(q0 + __ffs(m) - 1);
  }
}

}  // namespace dedup
