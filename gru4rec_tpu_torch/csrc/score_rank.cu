// Full-catalog ranking of the evaluation step for Hopper (sm_90a): the bias
// add, the masked softmax, the -inf mask, the target's gather and the
// comparison counts after the scores GEMM, in four launches; under an
// elementwise final activation in two (the second part of this file).
//
// Replaces no TPU kernel. The JAX package leaves these passes to XLA, which
// fuses them into the evaluation chunk's program
// (gru4rec_tpu/eval/evaluation.py make_eval_chunk_fn); the port ran them as
// eager PyTorch operations (eval/evaluation.py make_eval_step), each reading
// and most writing the (B, N) float32 score matrix: at rees46's 512 x
// 200,064 about 4.5 ms a step for work that needs one or two reads.
//
// What it computes, per lane r of B, over the real columns c < n_items of
// the raw logits x (B, N) and the bias column b (N,) (Wy[:, h], any stride,
// float32 or bfloat16):
//   v_c = x[r, c] + b[c];  m = max(max_c v_c, -1e30 if N > n_items)
//   e_c = expf(v_c - m);   s = sum_c e_c;  q_c = e_c / s;  t = q_tgt
//   gt = #{c : q_c > t},  ge = #{c : q_c >= t},  eq = #{c : q_c == t}
// exactly as ops/kernels/score_rank.py::score_rank_plain does it (one
// rounding per operation, expf and IEEE division: -fmad=false and no
// --use_fast_math), but for the order of the sum in s.
//
// Bound. Each pass reads the score matrix: at rees46's shape 409,731,072
// bytes, 0.1223 ms at 3.35 TB/s per read. The kernel reads it twice.
//
// Design.
//   * Pass 0 (score_rank_bias_kernel) packs the strided bias column into
//     the workspace (one gather of N values; a block of the streaming
//     passes that gathered its tile's bias itself read a 32-byte sector per
//     value, as many sector reads as a third of its scores), and zeroes
//     what pass 2 accumulates into.
//   * Two streaming passes over a grid of (row group of kRows lanes) x
//     (column tile of kTile columns), 256 threads a block, each thread eight
//     columns as two 16-byte loads (when N % 4 == 0 and x is 16-byte
//     aligned; else scalar loads), kUnroll rows of loads in flight. A block
//     reads its tile's packed bias once and keeps it in registers for all
//     its rows.
//   * Pass 1 (score_rank_max_kernel): each block's per-row max of v over
//     its tile, to pmax[r][tile]. Max is exact, so its order does not matter;
//     a NaN propagates, as torch.amax's does.
//   * Pass 2 (score_rank_count_kernel): each block reduces m and the
//     target's e_t from pmax and x (every block the same way, so every block
//     gets the same bits), then per element e_c, its tile's partial sum of e
//     (fixed order: per thread, a butterfly over the warp, the warps in
//     order) to psum[r][tile], and the count of e_c more than kBand ulps
//     above e_t (compared with the float kBand ulps above e_t). Division by
//     s > 0 is monotone, so such an element has q_c > t once s is known; an
//     element more than kBand ulps below e_t has q_c < t. The elements within kBand ulps either side are
//     counted by their ulp distance in band[r][d + kBand]. The grid walks in
//     the reverse order of pass 1, so that it starts on the tiles pass 1
//     read last, still in L2.
//   * Pass 3 (score_rank_finish_kernel, a block per lane): s in a fixed
//     order, t = e_t / s, and each band bucket resolved by dividing its e
//     value (e_t's bits + d) by s. The band is enough when the quotients of
//     its two outer neighbours are already on either side of t, which holds
//     wherever t is a normal float (a quotient's ulp is within a factor two
//     of e's ulp over s); elsewhere (a subnormal or zero t, a NaN or
//     infinite max) the block recounts the lane exactly, q_c against t
//     element by element: a third read of that lane alone.
//   * Determinism: no float atomics; the integer counts are merged with
//     atomics, whose order does not change a sum of integers. A replay is
//     bit-reproducible.
//   * The kernels allocate nothing and do not synchronise; the workspace
//     (gru4rec_score_rank_workspace_bytes) comes from the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                  // columns per 16-byte load
constexpr int kHalf = kThreads * kVec;   // columns of one load across the block
constexpr int kPer = 2 * kVec;           // columns a thread owns in a tile
constexpr int kTile = 2 * kHalf;         // 2,048 columns per block
constexpr int kRows = 16;                // lanes per block in passes 1 and 2
constexpr int kUnroll = 4;               // rows of loads in flight
constexpr int kBand = 8;                 // ulps of e either side of e_t
constexpr int kBandW = 2 * kBand + 1;
constexpr float kMaskedLogit = -1e30f;   // ops/activations.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;

struct Work {
  float* pmax;   // [B][C] per-tile max of v
  float* psum;   // [B][C] per-tile sum of e
  float* bias;   // [N] the bias column, packed
  int* gt_far;   // [B] elements more than kBand ulps above e_t
  int* band;     // [B][kBandW] elements d ulps from e_t, d in [-kBand, kBand]
};

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

Work carve(void* base, int B, int N, int C) {
  char* p = static_cast<char*>(base);
  Work w;
  w.pmax = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * static_cast<size_t>(B) * C);
  w.psum = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * static_cast<size_t>(B) * C);
  w.bias = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * static_cast<size_t>(N));
  w.gt_far = reinterpret_cast<int*>(p);
  p += align16(sizeof(int) * static_cast<size_t>(B));
  w.band = reinterpret_cast<int*>(p);
  return w;
}

size_t workspace_bytes(int B, int N, int C) {
  return 2 * align16(sizeof(float) * static_cast<size_t>(B) * C) +
         align16(sizeof(float) * static_cast<size_t>(N)) +
         align16(sizeof(int) * static_cast<size_t>(B)) +
         align16(sizeof(int) * static_cast<size_t>(B) * kBandW);
}

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// a butterfly: every lane ends with the same sum, in the same order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the column of a thread's j-th element in the tile starting at c0
__device__ __forceinline__ int column(int c0, int j) {
  return c0 + (j / kVec) * kHalf + kVec * static_cast<int>(threadIdx.x) + (j % kVec);
}

// a thread's eight elements of row `row` in the tile at c0; 0 past N
template <bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int c0, int N,
                                         float (&v)[kPer]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = column(c0, h * kVec);
    if (VEC) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < N) q = __ldg(reinterpret_cast<const float4*>(row + c));
      v[h * kVec + 0] = q.x;
      v[h * kVec + 1] = q.y;
      v[h * kVec + 2] = q.z;
      v[h * kVec + 3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[h * kVec + k] = c + k < N ? __ldg(row + c + k) : 0.f;
    }
  }
}

__device__ __forceinline__ float to_float(float b) { return b; }
__device__ __forceinline__ float to_float(__nv_bfloat16 b) { return __bfloat162float(b); }

// the row's max m from its tiles' maxima, on every lane of the warp
__device__ __forceinline__ float row_max(const float* __restrict__ pmax, int C, bool padded,
                                         int lane) {
  float m = padded ? kMaskedLogit : -INFINITY;
  for (int c = lane; c < C; c += 32) m = nan_max(m, pmax[c]);
  return warp_max(m);
}

// the row's sum s from its tiles' sums, in a fixed order, on every lane
__device__ __forceinline__ float row_sum(const float* __restrict__ psum, int C, int lane) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += psum[c];
  return warp_sum(s);
}

__device__ __forceinline__ float target_exp(const float* __restrict__ x,
                                            const float* __restrict__ bias,
                                            const int* __restrict__ tgt, int r, int N, float m) {
  const int c = tgt[r];
  const float v = x[static_cast<size_t>(r) * N + c] + bias[c];
  return expf(v - m);
}

template <typename BiasT>
__global__ void __launch_bounds__(kThreads) score_rank_bias_kernel(
    const BiasT* __restrict__ bias, long long bias_stride, int B, int N, Work w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < N) w.bias[i] = to_float(bias[static_cast<size_t>(i) * bias_stride]);
  for (int k = i; k < B * kBandW; k += gridDim.x * kThreads) w.band[k] = 0;
  for (int k = i; k < B; k += gridDim.x * kThreads) w.gt_far[k] = 0;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) score_rank_max_kernel(
    const float* __restrict__ x, int B, int N, int n_items, int C, Work w) {
  const int g = blockIdx.x / C, tile = blockIdx.x % C;
  const int r0 = g * kRows, c0 = tile * kTile;
  const bool whole = c0 + kTile <= n_items;  // every column of the tile is real
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ float s_max[kRows][kWarps];

  float b[kPer];
  load_row<VEC>(w.bias, c0, N, b);

  for (int i0 = 0; i0 < kRows; i0 += kUnroll) {
    float v[kUnroll][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + i0 + u;
      if (r < B) load_row<VEC>(x + static_cast<size_t>(r) * N, c0, N, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + i0 + u >= B) break;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (whole || column(c0, j) < n_items) m = nan_max(m, v[u][j] + b[j]);
      m = warp_max(m);
      if (lane == 0) s_max[i0 + u][warp] = m;
    }
  }
  __syncthreads();
  if (t < kRows && r0 + t < B) {
    float m = s_max[t][0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) m = nan_max(m, s_max[t][k]);
    w.pmax[static_cast<size_t>(r0 + t) * C + tile] = m;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) score_rank_count_kernel(
    const float* __restrict__ x, const int* __restrict__ tgt, int B, int N, int n_items, int C,
    Work w) {
  const int L = gridDim.x - 1 - blockIdx.x;  // pass 1's order reversed
  const int g = L / C, tile = L % C;
  const int r0 = g * kRows, c0 = tile * kTile;
  const bool whole = c0 + kTile <= n_items;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ float s_m[kRows];
  __shared__ int s_eb[kRows];
  __shared__ float s_lo[kRows], s_hi[kRows];  // e_t's bits -/+ kBand as floats
  __shared__ float s_sum[kRows][kWarps];
  __shared__ int s_gt[kRows];
  __shared__ int s_band[kRows][kBandW];

  for (int i = warp; i < kRows; i += kWarps) {
    const int r = r0 + i;
    if (r >= B) continue;
    const float m = row_max(w.pmax + static_cast<size_t>(r) * C, C, N > n_items, lane);
    const float et = target_exp(x, w.bias, tgt, r, N, m);
    if (lane == 0) {
      const int eb = __float_as_int(et);
      s_m[i] = m;
      s_eb[i] = eb;
      s_lo[i] = __int_as_float(eb > kBand ? eb - kBand : 0);
      s_hi[i] = __int_as_float(eb + kBand);
    }
  }
  for (int k = t; k < kRows * kBandW; k += kThreads) s_band[k / kBandW][k % kBandW] = 0;
  if (t < kRows) s_gt[t] = 0;
  float b[kPer];
  load_row<VEC>(w.bias, c0, N, b);
  __syncthreads();

  for (int i0 = 0; i0 < kRows; i0 += kUnroll) {
    float v[kUnroll][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + i0 + u;
      if (r < B) load_row<VEC>(x + static_cast<size_t>(r) * N, c0, N, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      if (r0 + i >= B) break;
      const float m = s_m[i], lo = s_lo[i], hi = s_hi[i];
      const int eb = s_eb[i];
      float s = 0.f;
      int gt = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!whole && column(c0, j) >= n_items) continue;
        const float vc = v[u][j] + b[j];
        const float e = expf(vc - m);
        s += e;
        gt += e > hi;
        if (e >= lo && e <= hi) atomicAdd(&s_band[i][__float_as_int(e) - eb + kBand], 1);
      }
      s = warp_sum(s);
      gt = __reduce_add_sync(kFull, gt);
      if (lane == 0) {
        s_sum[i][warp] = s;
        if (gt) atomicAdd(&s_gt[i], gt);
      }
    }
  }
  __syncthreads();
  if (t < kRows && r0 + t < B) {
    const int r = r0 + t;
    float s = s_sum[t][0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += s_sum[t][k];
    w.psum[static_cast<size_t>(r) * C + tile] = s;
    if (s_gt[t]) atomicAdd(&w.gt_far[r], s_gt[t]);
  }
  for (int k = t; k < kRows * kBandW; k += kThreads) {
    const int i = k / kBandW, d = k % kBandW;
    if (r0 + i < B && s_band[i][d]) atomicAdd(&w.band[static_cast<size_t>(r0 + i) * kBandW + d],
                                              s_band[i][d]);
  }
}

// block-wide integer sum, on thread 0
__device__ __forceinline__ int block_sum(int v, int (&scratch)[kWarps]) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = 0;
  if (threadIdx.x == 0)
    for (int k = 0; k < kWarps; ++k) out += scratch[k];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads) score_rank_finish_kernel(
    const float* __restrict__ x, const int* __restrict__ tgt, int B, int N, int n_items, int C,
    Work w, int* __restrict__ counts) {
  const int r = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  __shared__ float s_row[3];  // m, s, t
  __shared__ int s_exact;
  __shared__ int s_red[kWarps];

  if (t < 32) {
    const float m = row_max(w.pmax + static_cast<size_t>(r) * C, C, N > n_items, lane);
    const float s = row_sum(w.psum + static_cast<size_t>(r) * C, C, lane);
    const float et = target_exp(x, w.bias, tgt, r, N, m);
    if (lane == 0) {
      const float q = et / s;
      const int eb = __float_as_int(et);
      bool ok = isfinite(m) && s > 0.f && isfinite(s);
      if (ok) ok = __int_as_float(eb + kBand + 1) / s > q;
      if (ok && eb - kBand - 1 >= 0) ok = __int_as_float(eb - kBand - 1) / s < q;
      int gt = w.gt_far[r], eq = 0;
      if (ok) {
        for (int d = -kBand; d <= kBand; ++d) {
          const int n = w.band[static_cast<size_t>(r) * kBandW + d + kBand];
          if (n == 0) continue;
          const float qd = __int_as_float(eb + d) / s;
          if (qd > q)
            gt += n;
          else if (qd == q)
            eq += n;
        }
        counts[r] = gt;
        counts[B + r] = gt + eq;
        counts[2 * B + r] = eq;
      }
      s_row[0] = m;
      s_row[1] = s;
      s_row[2] = q;
      s_exact = !ok;
    }
  }
  __syncthreads();
  if (!s_exact) return;

  // the band cannot decide this lane: every quotient against t
  const float m = s_row[0], s = s_row[1], q = s_row[2];
  const float* row = x + static_cast<size_t>(r) * N;
  int gt = 0, ge = 0, eq = 0;
  for (int c = t; c < n_items; c += kThreads) {
    const float v = row[c] + w.bias[c];
    const float e = expf(v - m);
    const float qc = e / s;
    gt += qc > q;
    ge += qc >= q;
    eq += qc == q;
  }
  gt = block_sum(gt, s_red);
  ge = block_sum(ge, s_red);
  eq = block_sum(eq, s_red);
  if (t == 0) {
    counts[r] = gt;
    counts[B + r] = ge;
    counts[2 * B + r] = eq;
  }
}

template <bool VEC>
int launch(const float* x, const void* bias, long long bias_stride, int bias_bf16,
           const int* tgt, int B, int N, int n_items, int C, Work w, int* counts,
           cudaStream_t stream) {
  const int groups = (B + kRows - 1) / kRows;
  const int blocks = groups * C;
  const int packs = (N + kThreads - 1) / kThreads;
  if (bias_bf16)
    score_rank_bias_kernel<__nv_bfloat16><<<packs, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(bias), bias_stride, B, N, w);
  else
    score_rank_bias_kernel<float><<<packs, kThreads, 0, stream>>>(
        static_cast<const float*>(bias), bias_stride, B, N, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_rank_max_kernel<VEC><<<blocks, kThreads, 0, stream>>>(x, B, N, n_items, C, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_rank_count_kernel<VEC><<<blocks, kThreads, 0, stream>>>(x, tgt, B, N, n_items, C, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_rank_finish_kernel<<<B, kThreads, 0, stream>>>(x, tgt, B, N, n_items, C, w, counts);
  return static_cast<int>(cudaGetLastError());
}

int tiles(int N) { return (N + kTile - 1) / kTile; }

// ---------------------------------------------------------------------------
// Elementwise final activations (linear, relu, leaky-<x>, elu-<a>,
// selu-<l>-<a>, tanh, sigmoid): the same counts in two launches.
//
// Replaces the eager passes of the evaluation step's full-catalog route for
// these activations (eval/evaluation.py make_eval_step): the broadcast bias
// add, the activation as torch's op sequence (elu: clamp, exp, sub, mul,
// compare, where), the item_valid -inf mask, the target's gather and
// ops/ranking.py rank_counts' compares, int64 copies and sums, each reading
// and most writing the (B, N) float32 scores. Replaces no TPU kernel: XLA
// fuses these passes in gru4rec_tpu/eval/evaluation.py make_eval_chunk_fn.
//
// What it computes, per lane r, with act the activation as torch computes
// it (ops/activations.py; one rounding per operation, expf, IEEE division):
//   a_t = act(x[r, tgt] + b[tgt]);  a_c = act(x[r, c] + b[c]) for c < n_items
//   gt = #{c : a_c > a_t},  ge = #{c : a_c >= a_t},  eq = #{c : a_c == a_t}
// plus, where a_t is -inf, the N - n_items padding columns in ge and eq (the
// eager route's -inf there equals such a target). No sum of floats is
// involved, so the counts equal ops/kernels/score_rank.py::score_rank_plain's
// exactly, saturated ties (elu's -alpha, tanh's -1) included.
//
// Bound. One read of the scores: at diginetica's 512 x 43,008, 88,080,384
// bytes, 26.3 us at 3.35 TB/s. At that size the card's own one-read
// reductions come to about 0.75 of it (torch.amax(x, dim=1) 33.5 us,
// torch.sum(x) 36.3 us): the ramp and the tail of a 26 us grid are a
// large part of it.
//
// Design.
//   * The prep launch (score_rank_ew_prep_kernel) packs the strided bias
//     column as pass 0 does, computes each lane's a_t into the workspace and
//     writes the counts' starting values.
//   * The count launch (score_rank_ew_count_kernel) reads the scores once,
//     over a grid of (kRowsE lanes) x (a tile of kHalf = 1,024 columns):
//     one 16-byte load a thread a row (scalar where N % 4 != 0 or x is
//     misaligned), all kRowsE rows in flight, the tile's bias in registers.
//     Many small blocks (5,376 at diginetica's shape) keep the tail short;
//     the other grids measured at this shape (2,048-column tiles, 8-32
//     lanes a block, blocks or warps that each walk an even share of the
//     matrix) were as fast or slower (PERF.md). Each element's a_c is
//     compared with its lane's a_t; the warp's counts are reduced with
//     __reduce_add_sync, the block's in shared memory, and one integer
//     atomic a lane and count merges them into the output. The counts are
//     final: no finish pass, and a replay is bit-reproducible.
//   * The activation is a template argument (one kernel per activation, no
//     branch in the inner loop); its parameters come from the caller.
// ---------------------------------------------------------------------------

constexpr int kRowsE = 4;  // lanes of a block of the count launch, all their loads in flight

enum Act { kLinear = 0, kRelu = 1, kLeaky = 2, kElu = 3, kSelu = 4, kTanh = 5, kSigmoid = 6 };

struct EwWork {
  float* bias;    // [N] the bias column, packed
  float* target;  // [B] a_t
};

EwWork carve_ew(void* base, int N) {
  char* p = static_cast<char*>(base);
  EwWork w;
  w.bias = reinterpret_cast<float*>(p);
  w.target = reinterpret_cast<float*>(p + align16(sizeof(float) * static_cast<size_t>(N)));
  return w;
}

size_t ew_workspace_bytes(int B, int N) {
  return align16(sizeof(float) * static_cast<size_t>(N)) +
         align16(sizeof(float) * static_cast<size_t>(B));
}

// act(v) as ops/activations.py computes it with torch's ops, rounding after
// each one. Where torch computes where(v >= 0, v, f(clamp(v, max=0))), f's
// argument is v itself: the branch is taken only for v < 0 or NaN.
template <int ACT>
__device__ __forceinline__ float activate(float v, float p0, float p1) {
  if (ACT == kLinear) return v;
  if (ACT == kRelu) return v != v ? v : (v > 0.f ? v : 0.f);  // torch.maximum: NaN stays
  if (ACT == kLeaky) return v >= 0.f ? v : p0 * v;
  if (ACT == kElu) return v >= 0.f ? v : p0 * (expf(v) - 1.f);
  if (ACT == kSelu) return p0 * (v >= 0.f ? v : p1 * (expf(v) - 1.f));
  if (ACT == kTanh) return tanhf(v);
  return 1.f / (1.f + expf(-v));  // kSigmoid: 1.0 / (1.0 + exp(-x))
}

template <int ACT, typename BiasT>
__global__ void __launch_bounds__(kThreads) score_rank_ew_prep_kernel(
    const float* __restrict__ x, const BiasT* __restrict__ bias, long long bias_stride,
    const int* __restrict__ tgt, int B, int N, int n_items, float p0, float p1, EwWork w,
    int* __restrict__ counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < N) w.bias[i] = to_float(bias[static_cast<size_t>(i) * bias_stride]);
  if (i < B) {
    const int c = tgt[i];
    const float v = x[static_cast<size_t>(i) * N + c] +
                    to_float(bias[static_cast<size_t>(c) * bias_stride]);
    const float at = activate<ACT>(v, p0, p1);
    w.target[i] = at;
    const int pad = at == -INFINITY ? N - n_items : 0;
    counts[i] = 0;
    counts[B + i] = pad;
    counts[2 * B + i] = pad;
  }
}

// four elements of `row` from column c; 0 past N
template <bool VEC>
__device__ __forceinline__ void load_quad(const float* __restrict__ row, int c, int N,
                                          float (&v)[kVec]) {
  if (VEC) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < N) q = __ldg(reinterpret_cast<const float4*>(row + c));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = c + k < N ? __ldg(row + c + k) : 0.f;
  }
}

template <int ACT, bool VEC>
__global__ void __launch_bounds__(kThreads) score_rank_ew_count_kernel(
    const float* __restrict__ x, int B, int N, int n_items, int C, float p0, float p1,
    EwWork w, int* __restrict__ counts) {
  const int g = blockIdx.x / C, tile = blockIdx.x % C;
  const int r0 = g * kRowsE, c = tile * kHalf + kVec * static_cast<int>(threadIdx.x);
  const bool whole = (tile + 1) * kHalf <= n_items;  // every column of the tile is real
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __shared__ int s_gt[kRowsE][kWarps], s_eq[kRowsE][kWarps];

  float b[kVec];
  load_quad<VEC>(w.bias, c, N, b);
  float v[kRowsE][kVec];
#pragma unroll
  for (int k = 0; k < kRowsE; ++k)
    if (r0 + k < B) load_quad<VEC>(x + static_cast<size_t>(r0 + k) * N, c, N, v[k]);
#pragma unroll
  for (int k = 0; k < kRowsE; ++k) {
    if (r0 + k >= B) break;
    const float at = w.target[r0 + k];
    int gt = 0, eq = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (!whole && c + j >= n_items) continue;  // padding counts nothing
      const float a = activate<ACT>(v[k][j] + b[j], p0, p1);
      gt += a > at;
      eq += a == at;
    }
    gt = __reduce_add_sync(kFull, gt);
    eq = __reduce_add_sync(kFull, eq);
    if (lane == 0) {
      s_gt[k][warp] = gt;
      s_eq[k][warp] = eq;
    }
  }
  __syncthreads();
  if (t < kRowsE && r0 + t < B) {
    int gt = 0, eq = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      gt += s_gt[t][k];
      eq += s_eq[t][k];
    }
    const int r = r0 + t;
    if (gt) atomicAdd(&counts[r], gt);
    if (gt + eq) atomicAdd(&counts[B + r], gt + eq);
    if (eq) atomicAdd(&counts[2 * B + r], eq);
  }
}

template <int ACT, bool VEC>
int launch_ew(const float* x, const void* bias, long long bias_stride, int bias_bf16,
              const int* tgt, int B, int N, int n_items, float p0, float p1, EwWork w,
              int* counts, cudaStream_t stream) {
  const int n = N > B ? N : B;
  const int packs = (n + kThreads - 1) / kThreads;
  if (bias_bf16)
    score_rank_ew_prep_kernel<ACT, __nv_bfloat16><<<packs, kThreads, 0, stream>>>(
        x, static_cast<const __nv_bfloat16*>(bias), bias_stride, tgt, B, N, n_items, p0, p1,
        w, counts);
  else
    score_rank_ew_prep_kernel<ACT, float><<<packs, kThreads, 0, stream>>>(
        x, static_cast<const float*>(bias), bias_stride, tgt, B, N, n_items, p0, p1, w,
        counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = (N + kHalf - 1) / kHalf;
  const int blocks = (B + kRowsE - 1) / kRowsE * C;
  score_rank_ew_count_kernel<ACT, VEC><<<blocks, kThreads, 0, stream>>>(
      x, B, N, n_items, C, p0, p1, w, counts);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT>
int launch_ew_any(const float* x, const void* bias, long long bias_stride, int bias_bf16,
                  const int* tgt, int B, int N, int n_items, float p0, float p1, EwWork w,
                  int* counts, int vec, cudaStream_t stream) {
  return vec ? launch_ew<ACT, true>(x, bias, bias_stride, bias_bf16, tgt, B, N, n_items, p0,
                                    p1, w, counts, stream)
             : launch_ew<ACT, false>(x, bias, bias_stride, bias_bf16, tgt, B, N, n_items, p0,
                                     p1, w, counts, stream);
}

}  // namespace

// Bytes of the workspace a call at (B, N) takes.
extern "C" size_t gru4rec_score_rank_workspace_bytes(int B, int N) {
  return workspace_bytes(B, N, tiles(N));
}

// x: (B, N) float32 logits, contiguous. bias: N values at `bias_stride`
// elements apart, float32 (bias_bf16 = 0) or bfloat16 (1). tgt: B int32
// target columns, each in [0, n_items). work: workspace_bytes(B, N) bytes,
// 16-byte aligned. counts: (3, B) int32 out: gt, ge, eq. vec: 1 when
// N % 4 == 0 and x is 16-byte aligned (the wrapper checks), else 0. Returns
// the launches' cudaGetLastError() (0 on success).
extern "C" int gru4rec_score_rank(const float* x, const void* bias, long long bias_stride,
                                  int bias_bf16, const int* tgt, int B, int N, int n_items,
                                  void* work, int* counts, int vec, void* stream) {
  if (B <= 0 || N <= 0 || n_items <= 0 || n_items > N) return static_cast<int>(cudaErrorInvalidValue);
  const int C = tiles(N);
  const Work w = carve(work, B, N, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, bias, bias_stride, bias_bf16, tgt, B, N, n_items, C, w, counts, st)
             : launch<false>(x, bias, bias_stride, bias_bf16, tgt, B, N, n_items, C, w, counts, st);
}

// Bytes of the workspace an elementwise call at (B, N) takes.
extern "C" size_t gru4rec_score_rank_ew_workspace_bytes(int B, int N) {
  return ew_workspace_bytes(B, N);
}

// The counts of gru4rec_score_rank under an elementwise activation: act one
// of enum Act (linear 0, relu 1, leaky 2, elu 3, selu 4, tanh 5, sigmoid 6),
// p0 and p1 its parameters (leaky: p0 the leak; elu: p0 alpha; selu: p0
// lambda, p1 alpha). The other arguments as there; work:
// gru4rec_score_rank_ew_workspace_bytes(B, N) bytes, 16-byte aligned.
extern "C" int gru4rec_score_rank_ew(const float* x, const void* bias, long long bias_stride,
                                     int bias_bf16, const int* tgt, int B, int N, int n_items,
                                     int act, float p0, float p1, void* work, int* counts,
                                     int vec, void* stream) {
  if (B <= 0 || N <= 0 || n_items <= 0 || n_items > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const EwWork w = carve_ew(work, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRU4REC_EW_CASE(A)                                                                  \
  case A:                                                                                   \
    return launch_ew_any<A>(x, bias, bias_stride, bias_bf16, tgt, B, N, n_items, p0, p1, w, \
                            counts, vec, st);
  switch (act) {
    GRU4REC_EW_CASE(kLinear)
    GRU4REC_EW_CASE(kRelu)
    GRU4REC_EW_CASE(kLeaky)
    GRU4REC_EW_CASE(kElu)
    GRU4REC_EW_CASE(kSelu)
    GRU4REC_EW_CASE(kTanh)
    GRU4REC_EW_CASE(kSigmoid)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GRU4REC_EW_CASE
}
