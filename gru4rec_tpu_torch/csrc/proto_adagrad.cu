// Row-sparse adagrad prototypes for Hopper (sm_90a), one launch per call.
//
// Replaces the two Pallas TPU kernels of the repo's measurement scripts,
// both adagrad with no momentum and no L2 on float32 tables:
//   P1  `merged_adagrad` (scripts/proto_merged_kernel.py:31, pallas_call at
//       :58): table and accumulator side by side in one (n, 2d) buffer whose
//       row is [t | a], updated in place. The TPU question: does one copy per
//       row instead of two help?
//   P2  `v3_adagrad` (scripts/proto_v3_kernel.py:63, pallas_call at :167):
//       separate (n, d) table and accumulator; one invocation that loops over
//       only the real (deduplicated) rows through a depth-4 pipeline of
//       asynchronous copies. The TPU question: does a loop over the real rows
//       beat a grid over all K positions?
// Per distinct row r with g the sum of its duplicate gradient rows:
//   a[r] += g * g;  t[r] -= lr * (g / sqrtf(a[r] + eps))
//
// Bound: memory. Per call the K indices and K gradient rows are read once
// and each distinct row's table and accumulator row are read and written
// once (16 d bytes); at the RetailRocket shape (37,120 x 225, K = 2,208)
// 9.7 MB, 2.9 us at 3.35 TB/s.
//
// Both kernels take the raw int32 or int64 indices: no sort, cast, fill,
// memset or scratch precedes them, so a call is one device operation and
// never synchronises the host. An index is narrowed to int32 as
// idx.to(int32) does; a row outside [0, n_rows) (the int32-max sentinel of
// masked lanes, a padding row) is dropped; every row up to n_rows - 1 is
// updated (the Pallas versions point dummy grid steps at the last 8-row
// group and so cannot update a row there).
//
// The dedup is csrc/dedup.cuh's, the row-sparse kernel's (K1-K4): a raw
// position heads its run when its row is real and no earlier position holds
// it, found by each block comparing the K indices with the rows of its own
// positions. The head sums the gradient rows of its run from 0 in ascending
// raw position, the order of a stable sort, as the CPU plain version's
// index_add_ sums them: the accumulator then equals the plain version's bit
// for bit, and so does the table wherever the plain version's square root
// is correctly rounded (the kernels' sqrtf is).
//
// Access width. cp.async, vector loads and stores need addresses aligned to
// their size. The host picks each access's width (16, 8 or 4 bytes) from
// every row pitch and base pointer (proto_adagrad.access_width), so every
// row start is aligned and no row needs a peeled head or tail. The merged
// row's pitch, 8d bytes, is 8-byte aligned at every width and 16-byte
// aligned at even d; a separate row's pitch, 4d bytes, is only 4-byte
// aligned at the published odd widths (513, 481, 225).
//
// P1: one warp per raw position, kWarps per block. Before the dedup pass
// each warp stages its gradient row and, once its index is known, its row's
// [t | a] span (2d floats, one contiguous span) into its own shared memory
// with cp.async in the widest access the host allows, so the pass runs while
// the whole row is in flight. A head then pairs t[c] with a[c] from shared
// memory, adds its run's further gradient rows, and stores the results to
// global memory directly in coalesced 4-byte stores; a non-head drops its
// copy. On the card (PERF.md) writing the span back from shared memory in
// wide stores was 5% slower, and staging after the pass or narrower
// accesses than the alignment allows moved the time by under 2%.
//
// P2: block-local loop. Each block owns a tile of T raw positions, T chosen
// by gru4rec_v3_tile so that one wave of blocks, at most kMaxBlocksPerSM per
// SM, covers K. The block prefetches its tile's rows into L2, finds the
// heads of its tile with the same sort-free compare (the tile's rows in
// shared memory), and compacts them into a list in shared memory: no global
// list and no count. Each warp then loops over every kV3Warps-th head
// through its own ring of kDepth shared-memory slots; a slot holds the
// head's table row, accumulator row and first gradient row, staged with
// cp.async, one commit group per item, so the next item's rows are in
// flight while one is computed. Duplicates cost no row bytes and no loop
// iteration. Results go back with plain global stores. On the card the
// number of resident warps matters most and a deeper ring costs resident
// blocks: at the published shapes a warp sees 0.6-0.8 heads (PERF.md).
//
// Both kernels compute a head's row in passes of kPassCols columns, kCols
// per lane, so kCols loads and updates are independent (update_row).
//
// Numerics: -fmad=false and sqrtf division, as the torch-op plain versions
// (ops/kernels/proto_adagrad.py) round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dedup.cuh"

namespace {

using dedup::kRunCap;

constexpr int kWarps = 8;             // P1: raw positions (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;            // indices a thread loads at once
constexpr int kCols = 8;              // columns a lane owns per pass
constexpr int kPassCols = 32 * kCols;  // columns per pass
constexpr int kBatch = 2;             // run rows read together

constexpr int kV3Warps = 8;           // P2: warps per block
constexpr int kV3Threads = 32 * kV3Warps;
constexpr int kDepth = 2;             // P2: ring slots per warp
constexpr int kTileMax = 64;          // P2: raw positions per block, at most
constexpr int kV3Unroll = 4;          // P2: indices a thread loads at once
constexpr int kMaxBlocksPerSM = 4;    // P2: resident blocks per SM it asks for
static_assert(kV3Threads >= kTileMax, "a P2 thread per tile position");

__device__ __forceinline__ void adagrad(float g, float& t, float& a, float lr,
                                        float eps) {
  a = a + g * g;
  t = t - lr * (g / sqrtf(a + eps));
}

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// An asynchronous copy of BYTES (4, 8 or 16) from global to shared memory.
// The "memory" clobbers keep the compiler from moving shared-memory reads
// and writes across the copies, commits and waits.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's copies of n floats (n a multiple of W) from src to dst, W
// floats per access; src and dst aligned to W floats.
template <int W>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n,
                                          int lane) {
  for (int i = lane * W; i < n; i += 32 * W) cp_async<4 * W>(dst + i, src + i);
}

struct Args {
  const float* g;   // (K, d) gradient rows
  const void* idx;  // (K) int32 or int64 raw indices
  int idx64, K;
  float* table;     // P1: the merged (n_rows, 2d) buffer; P2: (n_rows, d)
  float* acc;       // P2: (n_rows, d)
  int n_rows, d;
  int T;            // P2: raw positions per block
  float lr, eps;
};

// Raw index q, as dedup::real_row gives it.
__device__ __forceinline__ int row_at(const Args& a, int q) {
  return dedup::row_at(a.idx, a.idx64, q, a.n_rows);
}

// Column j of this lane in the pass starting at `base`.
__device__ __forceinline__ int col_of(int base, int j, int lane) {
  return base + j * 32 + lane;
}

// The update of one head's row r (raw position p), every lane of the warp:
// its table and accumulator values at st / sa and its gradient row at sg,
// all in shared memory, the further run positions list[0..n) in ascending
// order (or, past kRunCap listed, found by walking the indices again);
// results to gt / ga. Each lane owns kCols columns per pass, so kCols loads
// and kCols updates are independent; run rows are read kBatch at a time.
__device__ __forceinline__ void update_row(const Args& a, const float* st, const float* sa,
                                           const float* sg, float* gt, float* ga,
                                           const int* list, int n, int p, int r, int lane) {
  const int d = a.d;
  for (int base = 0; base < d; base += kPassCols) {
    float gs[kCols], t[kCols], acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = col_of(base, j, lane);
      const bool in = c < d;
      // the run's sum in ascending position, from 0 as the plain version's
      gs[j] = in ? 0.f + sg[c] : 0.f;
      t[j] = in ? st[c] : 0.f;
      acc[j] = in ? sa[c] : 0.f;
    }
    if (n <= kRunCap) {
      for (int k0 = 0; k0 < n; k0 += kBatch) {
        float y[kBatch][kCols];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const float* grow = a.g + (int64_t)list[k0 + k < n ? k0 + k : k0] * d;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int c = col_of(base, j, lane);
            y[k][j] = k0 + k < n && c < d ? grow[c] : 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (k0 + k < n) {
#pragma unroll
            for (int j = 0; j < kCols; ++j) gs[j] += y[k][j];
          }
      }
    } else {
      dedup::for_each_later(a.idx, a.idx64, a.K, a.n_rows, p, r, lane, [&](int q) {
        const float* grow = a.g + (int64_t)q * d;
        float y[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = col_of(base, j, lane);
          y[j] = c < d ? grow[c] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) gs[j] += y[j];
      });
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = col_of(base, j, lane);
      if (c >= d) continue;
      adagrad(gs[j], t[j], acc[j], a.lr, a.eps);
      gt[c] = t[j];
      ga[c] = acc[j];
    }
  }
}

// P1's shared memory per warp, in floats: the span, then the gradient row.
__host__ __device__ __forceinline__ int p1_warp_floats(int d) {
  return ((2 * d + 3) & ~3) + ((d + 3) & ~3);
}

// P1, WS / WG floats per access of the span / the gradient row.
template <int WS, int WG>
__global__ void __launch_bounds__(kThreads) merged_adagrad_kernel(Args a) {
  extern __shared__ float4 p1_smem[];
  __shared__ int s_row[kWarps];             // each warp's row, -2 if none
  __shared__ int s_earlier[kWarps];         // an earlier position holds it
  __shared__ int s_nlater[kWarps];          // later positions that hold it
  __shared__ int s_later[kWarps][kRunCap];  // the first kRunCap of them
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kWarps, p = p0 + w;
  const int d = a.d;
  float* span = reinterpret_cast<float*>(p1_smem) + w * p1_warp_floats(d);
  float* sg = span + round4(2 * d);

  const float* grow = a.g + (int64_t)p * d;
  // Speculative: the gradient row, then (once the index is known) the row's
  // span are in flight during the dedup pass (about 95% of positions head a
  // run at uniform draws).
  if (p < a.K) stage_row<WG>(sg, grow, d, lane);
  const int r = p < a.K ? row_at(a, p) : -1;
  float* row = a.table + (int64_t)(r < 0 ? 0 : r) * 2 * d;
  if (r >= 0) stage_row<WS>(span, row, 2 * d, lane);
  cp_async_commit();
  int v[kUnroll];
  dedup::first_round<kThreads>(v, a.idx, a.idx64, a.K, a.n_rows);
  if (lane == 0) {
    s_row[w] = r < 0 ? -2 : r;
    s_earlier[w] = 0;
    s_nlater[w] = 0;
  }

  // The dedup pass: every index against the block's rows.
  __syncthreads();
  int rows[kWarps];
#pragma unroll
  for (int k = 0; k < kWarps; ++k) rows[k] = s_row[k];
  const dedup::Runs runs{s_earlier, s_nlater, s_later};
  dedup::scan<kThreads>(v, a.idx, a.idx64, a.K, a.n_rows, [&](int x, int q) {
    dedup::match_rows(rows, x, q, p0, runs, a.g, d, d);
  });
  __syncthreads();
  if (r < 0 || s_earlier[w]) {
    cp_async_wait<0>();  // a non-head's copy lands before its block ends
    return;
  }

  const int nrun = s_nlater[w];
  if (nrun <= kRunCap) dedup::rank_list(s_later[w], nrun, lane);
  cp_async_wait<0>();
  __syncwarp();  // every lane's copies are visible to the warp
  update_row(a, span, span + d, sg, row, row + d, s_later[w], nrun, p, r, lane);
}

// P2's ring slot, in floats: the table, accumulator and gradient rows, each
// of round4(d).
__host__ __device__ __forceinline__ int v3_slot_floats(int d) {
  return 3 * ((d + 3) & ~3);
}

// P2, W floats per access of every row.
template <int W>
__global__ void __launch_bounds__(kV3Threads) v3_adagrad_kernel(Args a) {
  extern __shared__ float4 p2_smem[];
  __shared__ __align__(16) int s_row[kTileMax];  // tile rows, -2 if none
  __shared__ int s_earlier[kTileMax];
  __shared__ int s_nlater[kTileMax];
  __shared__ int s_later[kTileMax][kRunCap];
  __shared__ int s_heads[kTileMax];  // tile positions that head a run
  __shared__ int s_nheads;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int d = a.d, dp = round4(d), slot = v3_slot_floats(d);
  const int p0 = blockIdx.x * a.T, tb = min(a.T, a.K - p0);
  float* ring = reinterpret_cast<float*>(p2_smem) + w * kDepth * slot;

  int v[kV3Unroll];
  dedup::first_round<kV3Threads>(v, a.idx, a.idx64, a.K, a.n_rows);
  if (threadIdx.x < kTileMax) {
    const int k = threadIdx.x;
    const int r = k < tb ? row_at(a, p0 + k) : -1;
    s_row[k] = r < 0 ? -2 : r;
    s_earlier[k] = 0;
    s_nlater[k] = 0;
  }
  if (threadIdx.x == 0) s_nheads = 0;
  __syncthreads();
  // the tile's rows into L2 while the pass runs
  for (int k = w; k < tb; k += kV3Warps) {
    const int r = s_row[k];
    for (int c = lane * 32; c < d; c += 32 * 32) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.g + (int64_t)(p0 + k) * d + c));
      if (r < 0) continue;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.table + (int64_t)r * d + c));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.acc + (int64_t)r * d + c));
    }
  }

  // The dedup pass: every index against the tile's rows, four at a time.
  const int n4 = (tb + 3) >> 2;
  const dedup::Runs runs{s_earlier, s_nlater, s_later};
  dedup::scan<kV3Threads>(v, a.idx, a.idx64, a.K, a.n_rows, [&](int x, int q) {
    if (x < 0) return;
    bool hit = false;
    for (int k4 = 0; k4 < n4; ++k4) {
      const int4 rr = reinterpret_cast<const int4*>(s_row)[k4];
      hit |= (x == rr.x) | (x == rr.y) | (x == rr.z) | (x == rr.w);
    }
    if (!hit) return;
    for (int k = 0; k < tb; ++k)
      if (s_row[k] == x) dedup::note_match(runs, k, p0 + k, q, a.g, d, d);
  });
  __syncthreads();
  // the heads, compacted (in no order: each head's update is independent)
  if (threadIdx.x < tb && s_row[threadIdx.x] >= 0 && !s_earlier[threadIdx.x])
    s_heads[atomicAdd(&s_nheads, 1)] = threadIdx.x;
  __syncthreads();
  const int nmine = (s_nheads - w + kV3Warps - 1) / kV3Warps;  // this warp's
  for (int j = 0; j < nmine; ++j) {
    const int k = s_heads[w + j * kV3Warps];
    if (s_nlater[k] <= kRunCap) dedup::rank_list(s_later[k], s_nlater[k], lane);
  }

  // the copies of this warp's j-th head into slot j % kDepth; every lane
  // commits one group per call, empty past the warp's list
  auto stage = [&](int j) {
    if (j < nmine) {
      const int k = s_heads[w + j * kV3Warps];
      const int r = s_row[k];
      float* s = ring + (j % kDepth) * slot;
      stage_row<W>(s, a.table + (int64_t)r * d, d, lane);
      stage_row<W>(s + dp, a.acc + (int64_t)r * d, d, lane);
      stage_row<W>(s + 2 * dp, a.g + (int64_t)(p0 + k) * d, d, lane);
    }
    cp_async_commit();
  };

  for (int j = 0; j < kDepth - 1; ++j) stage(j);
  for (int j = 0; j < nmine; ++j) {
    __syncwarp();                // every lane is done with slot (j - 1)
    stage(j + kDepth - 1);       // into the slot that item j - 1 freed
    cp_async_wait<kDepth - 1>();  // item j's group has landed
    __syncwarp();                // ... for every lane of the warp
    const int k = s_heads[w + j * kV3Warps];
    const int r = s_row[k];
    const float* s = ring + (j % kDepth) * slot;
    update_row(a, s, s + dp, s + 2 * dp, a.table + (int64_t)r * d, a.acc + (int64_t)r * d,
               s_later[k], s_nlater[k], p0 + k, r, lane);
  }
  cp_async_wait<0>();
}

// Floats per access for an access width in bytes; 0 for a width the kernels
// do not take.
int floats_of(int bytes) {
  return bytes == 16 ? 4 : bytes == 8 ? 2 : bytes == 4 ? 1 : 0;
}

// Raises a kernel's dynamic shared memory limit, once per device, to what
// the card's opt-in limit leaves beside its static shared memory (the
// default 48 KB counts static and dynamic together); cudaErrorInvalidValue
// if `bytes` does not fit. limit[dev] keeps the raised limit.
template <typename Kernel>
int fit_smem(Kernel kernel, size_t bytes, int* limit) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!limit[dev]) {
    int optin;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    const int max_dynamic = optin - (int)fa.sharedSizeBytes;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_dynamic);
    if (err != cudaSuccess) return (int)err;
    limit[dev] = max_dynamic;
  }
  return bytes > (size_t)limit[dev] ? (int)cudaErrorInvalidValue : 0;
}

template <int WS, int WG>
int launch_p1(const Args& a, cudaStream_t st) {
  static int limit[64];
  const size_t smem = (size_t)kWarps * p1_warp_floats(a.d) * sizeof(float);
  const int err = fit_smem(merged_adagrad_kernel<WS, WG>, smem, limit);
  if (err != 0) return err;
  merged_adagrad_kernel<WS, WG>
      <<<(a.K + kWarps - 1) / kWarps, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int WS>
int launch_p1_grad(const Args& a, int wg, cudaStream_t st) {
  if (wg == 4) return launch_p1<WS, 4>(a, st);
  if (wg == 2) return launch_p1<WS, 2>(a, st);
  return launch_p1<WS, 1>(a, st);
}

size_t v3_smem(int d) {
  return (size_t)kV3Warps * kDepth * v3_slot_floats(d) * sizeof(float);
}

template <int W>
int launch_p2(const Args& a, cudaStream_t st) {
  static int limit[64];
  const size_t smem = v3_smem(a.d);
  const int err = fit_smem(v3_adagrad_kernel<W>, smem, limit);
  if (err != 0) return err;
  v3_adagrad_kernel<W><<<(a.K + a.T - 1) / a.T, kV3Threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// P1. g (K, d) float32; idx (K) int32, or int64 when idx64; merged
// (n_rows, 2d) float32 updated in place. span_bytes / grad_bytes: the
// access width (16, 8 or 4) that every row pitch and the base pointer of
// merged / g allow. Returns the launch's CUDA error (0 on success).
extern "C" int gru4rec_merged_adagrad(const void* g, const void* idx, int idx64,
                                      int K, void* merged, int n_rows, int d,
                                      int span_bytes, int grad_bytes, float lr,
                                      float eps, void* stream) {
  if (K <= 0) return 0;
  const int ws = floats_of(span_bytes), wg = floats_of(grad_bytes);
  if (!ws || !wg || (2 * d) % ws || d % wg) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(g), idx, idx64, K, static_cast<float*>(merged),
               nullptr, n_rows, d, 0, lr, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws == 4) return launch_p1_grad<4>(a, wg, st);
  if (ws == 2) return launch_p1_grad<2>(a, wg, st);
  return launch_p1_grad<1>(a, wg, st);
}

// P2's blocks per SM at width d: the blocks resident on one SM at once (its
// registers, threads and ring), at most kMaxBlocksPerSM, to *blocks; the
// wrapper multiplies it by the SM count. Returns a CUDA error code (0 on
// success; cudaErrorInvalidValue when the ring does not fit a block).
extern "C" int gru4rec_v3_blocks_per_sm(int d, int* blocks) {
  static int limit[64];
  const size_t smem = v3_smem(d);
  int err = fit_smem(v3_adagrad_kernel<1>, smem, limit);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, v3_adagrad_kernel<1>,
                                                           kV3Threads, smem);
  if (*blocks > kMaxBlocksPerSM) *blocks = kMaxBlocksPerSM;
  return err;
}

// P2's raw positions per block for K positions over a grid of `grid`
// resident blocks: enough that one wave covers K, within [1, kTileMax] (a
// K beyond kTileMax per block takes more waves).
extern "C" int gru4rec_v3_tile(int K, int grid) {
  const int t = grid > 0 ? (K + grid - 1) / grid : kTileMax;
  return t < 1 ? 1 : t > kTileMax ? kTileMax : t;
}

// P2's warps per block (each loops over every kV3Warps-th head of its tile).
extern "C" int gru4rec_v3_warps() { return kV3Warps; }

// P2. As P1 for g and idx; table and acc (n_rows, d) float32 updated in
// place; row_bytes the access width that every pitch and base pointer of
// g, table and acc allow; T the raw positions per block (gru4rec_v3_tile).
// Returns the launch's CUDA error (0 on success).
extern "C" int gru4rec_v3_adagrad(const void* g, const void* idx, int idx64, int K,
                                  void* table, void* acc, int n_rows, int d,
                                  int row_bytes, int T, float lr, float eps,
                                  void* stream) {
  if (K <= 0) return 0;
  const int w = floats_of(row_bytes);
  if (!w || d % w || T < 1 || T > kTileMax) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(g), idx, idx64, K, static_cast<float*>(table),
               static_cast<float*>(acc), n_rows, d, T, lr, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w == 4) return launch_p2<4>(a, st);
  if (w == 2) return launch_p2<2>(a, st);
  return launch_p2<1>(a, st);
}
