// Row-sparse adagrad prototypes for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the repo's measurement scripts,
// both adagrad with no momentum and no L2 on float32 tables:
//   P1  `merged_adagrad` (scripts/proto_merged_kernel.py:31, pallas_call at
//       :58): table and accumulator side by side in one (n, 2d) buffer whose
//       row is [t | a], updated in place;
//   P2  `v3_adagrad` (scripts/proto_v3_kernel.py:63, pallas_call at :167):
//       separate (n, d) table and accumulator; one invocation that loops over
//       only the real (deduplicated) rows, counted on the device, with a
//       depth-4 pipeline of asynchronous copies.
// Per distinct row r with g the sum of its duplicate gradient rows:
//   a[r] += g * g;  t[r] -= lr * (g / sqrtf(a[r] + eps))
// Indices >= n_rows (the int32-max sentinel of masked lanes) are dropped;
// every row up to n_rows - 1 is updated (the Pallas versions point dummy
// grid steps at the last 8-row group and so cannot update a row there).
//
// Both take the K raw indices stable-sorted by the wrapper (torch.sort) with
// the sort's permutation, standing for the scripts' `group_pack` feed, and
// sum each run of equal indices in sorted order (deterministic dedup, no
// atomics) through sorted_runs.cuh. (The row-sparse kernel, sparse_update.cu,
// takes no sort: it dedups the raw indices itself.)
//
// P1: one block per sorted position; a block that heads a run of a real row
// reads the run's gradient rows and the row's 2d-wide [t | a] once and
// writes it once: a sort-fed row-sparse update on the merged layout. The
// TPU's question was whether one copy per row instead of two helps; here
// both layouts cost one coalesced pass over the same bytes.
//
// P2: a small kernel writes one record per run head of a real row (`items`:
// row, run start and length, the first gradient rows' positions) and their
// count (`n_real`) on the device, so the host never learns the count. Then
// a persistent grid loops j = blockIdx.x; j < *n_real; j += gridDim.x. Its
// size is fixed per width: as many blocks as are resident at once (the
// occupancy API's blocks per SM for the ring's shared memory, times the SM
// count), since the loop is latency-bound and more resident blocks hide
// more of it than a deeper ring in fewer blocks. A call is thus three
// device operations: a memset of the count, the record kernel and the loop
// kernel. At the published shapes the ring barely runs: on an H100 (132
// SMs) the grid is 10 blocks per SM (1,320) at d = 225, 7 (924) at d = 481
// and 6 (792) at d = 513, for 1,200-2,100 distinct rows, so each block takes
// 1.3-2.0 items (chip_smoke.py's proto phase prints `v3_grid` and
// `v3_items_per_block`). Each block keeps a ring of kDepth = 4 shared-memory slots;
// a slot holds one item's table row, accumulator row and its first
// kGradRows gradient rows, staged with 4-byte cp.async (the published widths
// 513, 481 and 225 leave most rows unaligned to 16 bytes), one commit group
// per item, so up to three items are in flight while one is computed.
// Results go back with plain global stores; gradient rows past kGradRows
// are read from global memory in sorted order after the staged ones. The
// records are loaded one iteration ahead, so no dependent load stands
// between a slot's freeing and its refill. Each
// thread stages and computes the same columns (c = threadIdx.x + k *
// blockDim.x), so cp.async.wait_group alone orders its copies before its
// reads: the kernel needs no __syncthreads.
//
// Bound: memory. Per call the K indices and K gradient rows are read once
// and each distinct row's [t | a] is read and written once (16 d bytes); at
// the RetailRocket shape (d = 225, K = 2208) about 9.7 MB, ~2.9 us at
// 3.35 TB/s. At that size the launch latency and the sort dominate.
//
// Numerics: -fmad=false and sqrtf division, as the torch-op plain versions
// (ops/kernels/proto_adagrad.py) round; only the order of duplicate sums may
// differ from a plain version whose index_add_ runs on atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kDepth = 4;     // P2's pipeline depth (slots in flight + 1)
constexpr int kGradRows = 2;  // gradient rows staged per P2 item

__device__ __forceinline__ void adagrad(float g, float& t, float& a, float lr,
                                        float eps) {
  a = a + g * g;
  t = t - lr * (g / sqrtf(a + eps));
}

__global__ void merged_adagrad_kernel(const float* __restrict__ g,
                                      const int32_t* __restrict__ sidx,
                                      const int64_t* __restrict__ order, int K,
                                      float* __restrict__ merged, int n_rows,
                                      int d, float lr, float eps) {
  const int b = blockIdx.x;
  if (!is_run_head(sidx, b, n_rows)) return;
  const int end = run_end(sidx, b, K);
  float* row = merged + (int64_t)sidx[b] * 2 * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float gc = run_sum(g, order, b, end, d, c);
    float t = row[c], a = row[d + c];
    adagrad(gc, t, a, lr, eps);
    row[c] = t;
    row[d + c] = a;
  }
}

// One P2 work item: a distinct real row, the sorted position of its run's
// head, the run's length and the first kGradRows gradient rows of the run
// (their row in g, by the sort's permutation).
struct __align__(16) Item {
  int row, head, len, grad[kGradRows];
};

__global__ void v3_items_kernel(const int32_t* __restrict__ sidx,
                                const int64_t* __restrict__ order, int K,
                                int n_rows, Item* __restrict__ items,
                                int32_t* __restrict__ n_real) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= K || !is_run_head(sidx, b, n_rows)) return;
  Item it;
  it.row = sidx[b];
  it.head = b;
  it.len = run_end(sidx, b, K) - b;
  for (int k = 0; k < kGradRows; ++k)
    it.grad[k] = k < it.len ? (int)order[b + k] : 0;
  // the order of the list is free: each item's update is independent
  items[atomicAdd(n_real, 1)] = it;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void v3_adagrad_kernel(const float* __restrict__ g,
                                  const int64_t* __restrict__ order,
                                  const Item* __restrict__ items,
                                  const int32_t* __restrict__ n_real,
                                  float* __restrict__ table,
                                  float* __restrict__ acc, int d, float lr,
                                  float eps) {
  extern __shared__ float ring[];  // [kDepth][2 + kGradRows][d]
  const int n = *n_real;
  const int slot_floats = (2 + kGradRows) * d;

  // this block's i-th item (len 0 past the end of the list)
  auto item = [&](int i) {
    const int j = blockIdx.x + i * gridDim.x;
    if (j < n) return items[j];
    Item none{};
    return none;
  };
  // issue the copies of item ``it`` into slot i % kDepth; every thread
  // commits one group per call, empty for an empty item
  auto stage = [&](const Item& it, int i) {
    float* s = ring + (i % kDepth) * slot_floats;
    const float* trow = table + (int64_t)it.row * d;
    const float* arow = acc + (int64_t)it.row * d;
    const int ng = min(it.len, kGradRows);
    for (int c = threadIdx.x; it.len > 0 && c < d; c += blockDim.x) {
      cp_async4(s + c, trow + c);
      cp_async4(s + d + c, arow + c);
      for (int k = 0; k < ng; ++k)
        cp_async4(s + (2 + k) * d + c, g + (int64_t)it.grad[k] * d + c);
    }
    cp_async_commit();
  };

  for (int i = 0; i < kDepth - 1; ++i) stage(item(i), i);
  // the items' records are loaded one iteration before they are used, so
  // that their latency overlaps the wait and the compute
  Item to_stage = item(kDepth - 1);
  Item cur = item(0);
  for (int i = 0; cur.len > 0; ++i) {
    stage(to_stage, i + kDepth - 1);  // into the slot item i - 1 freed
    to_stage = item(i + kDepth);
    const Item next = item(i + 1);
    cp_async_wait<kDepth - 1>();  // item i's group has landed
    const float* s = ring + (i % kDepth) * slot_floats;
    const int ng = min(cur.len, kGradRows);
    float* trow = table + (int64_t)cur.row * d;
    float* arow = acc + (int64_t)cur.row * d;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float gc = 0.f;
      for (int k = 0; k < ng; ++k) gc += s[(2 + k) * d + c];
      gc = run_sum(g, order, cur.head + ng, cur.head + cur.len, d, c, gc);
      float t = s[c], a = s[d + c];
      adagrad(gc, t, a, lr, eps);
      trow[c] = t;
      arow[c] = a;
    }
    cur = next;
  }
  cp_async_wait<0>();
}

// P2's shared memory for width d, with the kernel's opt-in limit raised to
// it where it passes 48 KB; cudaErrorInvalidValue if a ring of kDepth slots
// of d-wide rows does not fit in a block.
int v3_smem(int d, size_t* smem) {
  *smem = (size_t)kDepth * (2 + kGradRows) * d * sizeof(float);
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return (int)err;
  if (*smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(v3_adagrad_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
  return 0;
}

}  // namespace

// P1. g (K, d), sidx (K) int32 sorted, order (K) int64 its permutation,
// merged (n_rows, 2d) float32 updated in place. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int gru4rec_merged_adagrad(const void* g, const void* sidx,
                                      const void* order, int K, void* merged,
                                      int n_rows, int d, float lr, float eps,
                                      void* stream) {
  if (K <= 0) return 0;
  merged_adagrad_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(sidx),
      static_cast<const int64_t*>(order), K, static_cast<float*>(merged),
      n_rows, d, lr, eps);
  return (int)cudaGetLastError();
}

// P2's persistent grid at width d: writes the number of blocks that are
// resident on one SM at once (its registers, threads and shared memory) to
// *blocks; the wrapper multiplies it by the SM count. Returns a CUDA error
// code (0 on success).
extern "C" int gru4rec_v3_blocks_per_sm(int d, int* blocks) {
  size_t smem;
  const int err = v3_smem(d, &smem);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, v3_adagrad_kernel, kThreads, smem);
}

// P2. As P1 for g, sidx and order; table and acc (n_rows, d) float32
// updated in place; items (K x 8 int32) and n_real (1 int32) scratch; grid
// the persistent grid's size. Returns the first CUDA error (0 on success).
extern "C" int gru4rec_v3_adagrad(const void* g, const void* sidx,
                                  const void* order, int K, void* items,
                                  void* n_real, void* table, void* acc,
                                  int n_rows, int d, int grid, float lr,
                                  float eps, void* stream) {
  static_assert(sizeof(Item) == 8 * sizeof(int32_t), "items are 8 int32 each");
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem;
  int code = v3_smem(d, &smem);
  if (code != 0) return code;
  cudaError_t err = cudaMemsetAsync(n_real, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t* op = static_cast<const int64_t*>(order);
  Item* ip = static_cast<Item*>(items);
  v3_items_kernel<<<(K + 255) / 256, 256, 0, st>>>(
      static_cast<const int32_t*>(sidx), op, K, n_rows, ip,
      static_cast<int32_t*>(n_real));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  v3_adagrad_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(g), op, ip, static_cast<const int32_t*>(n_real),
      static_cast<float*>(table), static_cast<float*>(acc), d, lr, eps);
  return (int)cudaGetLastError();
}
