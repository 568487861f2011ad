// Fused row-sparse optimizer update for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels of
// gru4rec_tpu/ops/kernels/sparse_update.py, one mode each:
//   K1  `_fused_update_v3` (pallas_call at :776), non-SR: adagrad / rmsprop /
//       adadelta / adam, each with optional momentum and L2, on a float32
//       table with float32 or bfloat16 state and velocity;
//   K2  the same kernel's stochastic-rounding mode (`sr_seed`, :484-504,
//       :614-688): adagrad's acc and adam's merged [acc | meang | count]
//       state stored in bfloat16 with stochastic rounding (SR template flag);
//   K3  `fused_update_v4` (:808), the compact mode: the same math on deduped
//       gradients, which this kernel always forms itself from the sorted
//       raw indices, so it needs no mode of its own;
//   K4  `_fused_update`, the v2 grid (pallas_call at :410): K1's math at
//       any width; threads stride over the columns, so that is K1's code.
// Table, state and velocity rows are updated in place.
//
// Design. The Pallas kernels walk 8-row groups (a grid, or a DMA ring)
// because of the TPU's (8,128) tiling; none of that carries over. Here the
// wrapper stable-sorts the K raw indices (torch.sort) and launches one block
// per sorted position. Block b exits unless its row is the head of a run of
// equal indices and a real row (sentinels are INT32_MAX, padding rows are
// >= n_rows). The head block sums the run's gradient rows in sorted order
// (the dedup, deterministic, no atomics; sorted_runs.cuh), then applies the update with
// float32 math in registers and writes the table, state and velocity rows.
//
// Bound. Memory: per distinct row it reads and writes the table, state and
// velocity rows and reads the K gradient rows once; at the flagship shape
// (d = 256, K = 2208) that is about 10 MB, ~3 us at 3.35 TB/s. At that size
// the launch latency dominates; a faster design is later work.
//
// Numerics follow the torch-op plain version (train/optimizers.py
// apply_sparse_plain) operation by operation: divide by sqrtf(acc + eps)
// (no rsqrt), native expm1f, bfloat16 stores round to nearest even, the
// (1 - v) factors arrive computed in double on the host as the plain
// version's Python scalars are. Build with -fmad=false and without
// --use_fast_math so that no multiply-add is contracted.
//
// Stochastic rounding (ops/sr.py): the dither of cell (row, col) is
// mix32(seed + (row_offset + row) * P_ROW + col * P_COL) & 0xFFFF in uint32
// arithmetic, the JAX package's wrapping int32 hash; the stored bf16 is the
// high half of (bits(x) + dither) & 0xFFFF0000. The unrounded float32 value
// drives the step's update. Adam's count is stored as base-256 limbs in
// lanes 0..2 of its block (lanes 3..127 are 0); its first moment is rounded
// stochastically (on buffer columns d..2d-1) only in SR mode 2 (v1 > 0.99),
// else to nearest.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

enum Adapt { ADAGRAD = 0, RMSPROP = 1, ADADELTA = 2, ADAM = 3 };

struct Hyper {
  float lr, momentum, lmbd;
  float v1, omv1, v2, omv2;  // decays and (1 - decay), rounded from double
  float ln_v1, ln_v2;        // log of the decays (-inf for a zero decay)
  float eps;
  uint32_t seed, row_offset;  // SR dither key
  int sr_m;                   // SR also for adam's first moment
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t sr_bits16(uint32_t seed, uint32_t row,
                                              uint32_t col) {
  return mix32(seed + row * 0x9E3779B9u + col * 0x27D4EB2Fu) & 0xFFFFu;
}

__device__ __forceinline__ void store_sr(__nv_bfloat16* p, float v,
                                         uint32_t bits) {
  const uint32_t u = (__float_as_uint(v) + bits) & 0xFFFF0000u;
  *p = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
}

template <int ADAPT, bool MOM, bool SR, typename ST, typename VT>
__global__ void sparse_update_kernel(const float* __restrict__ g,
                                     const int32_t* __restrict__ sidx,
                                     const int64_t* __restrict__ order, int K,
                                     float* __restrict__ table, int n_rows,
                                     int d, ST* __restrict__ state, int ds,
                                     VT* __restrict__ vel, Hyper h) {
  const int b = blockIdx.x;
  if (!is_run_head(sidx, b, n_rows)) return;
  const int r = sidx[b];
  const int end = run_end(sidx, b, K);

  float* trow = table + (int64_t)r * d;
  ST* srow = state + (int64_t)r * ds;
  VT* vrow = MOM ? vel + (int64_t)r * d : nullptr;

  const uint32_t hrow = h.row_offset + static_cast<uint32_t>(r);
  float cnt = 0.f, corr1 = 1.f, corr2 = 1.f;
  if (ADAPT == ADAM) {
    // every thread reads the old count before any thread rewrites its block
    if (SR)  // base-256 limbs in lanes 0..2
      cnt = (load(srow + 2 * d + 2) * 256.0f + load(srow + 2 * d + 1)) * 256.0f +
            load(srow + 2 * d) + 1.0f;
    else
      cnt = load(srow + 2 * d) + 1.0f;
    corr1 = -expm1f(cnt * h.ln_v1);
    corr2 = -expm1f(cnt * h.ln_v2);
    __syncthreads();
  }

  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float gc = run_sum(g, order, b, end, d, c);
    const float gg = gc * gc;
    float gs;
    if (ADAPT == ADAGRAD) {
      const float acc = load(srow + c) + gg;
      if constexpr (SR)
        store_sr(srow + c, acc, sr_bits16(h.seed, hrow, c));
      else
        store(srow + c, acc);
      gs = gc / sqrtf(acc + h.eps);
    } else if (ADAPT == RMSPROP) {
      const float acc = h.v1 * load(srow + c) + h.omv1 * gg;
      store(srow + c, acc);
      gs = gc / sqrtf(acc + h.eps);
    } else if (ADAPT == ADADELTA) {
      const float acc = h.v1 * load(srow + c) + h.omv1 * gg;
      const float upd_old = load(srow + d + c);
      const float scal = (upd_old + h.eps) / (acc + h.eps);
      const float upd = h.v1 * upd_old + (h.omv1 * scal) * gg;
      store(srow + c, acc);
      store(srow + d + c, upd);
      gs = gc * sqrtf(scal);
    } else {  // ADAM: [acc | meang | count block]
      const float acc = h.v2 * load(srow + c) + h.omv2 * gg;
      const float m = h.v1 * load(srow + d + c) + h.omv1 * gc;
      if constexpr (SR) {
        store_sr(srow + c, acc, sr_bits16(h.seed, hrow, c));
        if (h.sr_m)
          store_sr(srow + d + c, m, sr_bits16(h.seed, hrow, d + c));
        else
          store(srow + d + c, m);
      } else {
        store(srow + c, acc);
        store(srow + d + c, m);
      }
      gs = (m / corr1) / (sqrtf(acc / corr2) + h.eps);
    }
    const float t_old = trow[c];
    const float delta = h.lmbd > 0.f ? h.lr * (gs + h.lmbd * t_old) : h.lr * gs;
    if (MOM) {
      const float v = h.momentum * load(vrow + c) - delta;
      store(vrow + c, v);
      trow[c] = t_old + v;
    } else {
      trow[c] = t_old - delta;
    }
  }
  if (ADAPT == ADAM) {
    if (SR) {
      const float hi = floorf(cnt / 65536.0f);
      const float rem = cnt - hi * 65536.0f;
      const float mid = floorf(rem / 256.0f);
      const float lo = rem - mid * 256.0f;
      for (int c = 2 * d + threadIdx.x; c < ds; c += blockDim.x) {
        const int lane = c - 2 * d;
        store(srow + c, lane == 0 ? lo : lane == 1 ? mid : lane == 2 ? hi : 0.0f);
      }
    } else {
      for (int c = 2 * d + threadIdx.x; c < ds; c += blockDim.x) store(srow + c, cnt);
    }
  }
}

constexpr int kThreads = 128;

template <int ADAPT, bool MOM, bool SR, typename ST, typename VT>
void launch(const float* g, const int32_t* sidx, const int64_t* order, int K,
            float* table, int n_rows, int d, void* state, int ds, void* vel,
            const Hyper& h, cudaStream_t stream) {
  sparse_update_kernel<ADAPT, MOM, SR, ST, VT><<<K, kThreads, 0, stream>>>(
      g, sidx, order, K, table, n_rows, d, static_cast<ST*>(state), ds,
      static_cast<VT*>(vel), h);
}

template <int ADAPT, bool SR, typename ST>
void dispatch_vel(int vel_dtype, const float* g, const int32_t* sidx,
                  const int64_t* order, int K, float* table, int n_rows, int d,
                  void* state, int ds, void* vel, const Hyper& h,
                  cudaStream_t stream) {
  if (vel_dtype < 0)
    launch<ADAPT, false, SR, ST, float>(g, sidx, order, K, table, n_rows, d,
                                        state, ds, vel, h, stream);
  else if (vel_dtype == 0)
    launch<ADAPT, true, SR, ST, float>(g, sidx, order, K, table, n_rows, d,
                                       state, ds, vel, h, stream);
  else
    launch<ADAPT, true, SR, ST, __nv_bfloat16>(g, sidx, order, K, table,
                                               n_rows, d, state, ds, vel, h,
                                               stream);
}

// Returns cudaErrorInvalidValue for a combination the kernel does not take
// (SR is adagrad/adam with bfloat16 state only), else 0.
template <int ADAPT>
int dispatch_state(int state_dtype, int sr, int vel_dtype, const float* g,
                   const int32_t* sidx, const int64_t* order, int K,
                   float* table, int n_rows, int d, void* state, int ds,
                   void* vel, const Hyper& h, cudaStream_t stream) {
  if (sr) {
    if constexpr (ADAPT == ADAGRAD || ADAPT == ADAM) {
      if (state_dtype != 1) return (int)cudaErrorInvalidValue;
      dispatch_vel<ADAPT, true, __nv_bfloat16>(vel_dtype, g, sidx, order, K,
                                               table, n_rows, d, state, ds,
                                               vel, h, stream);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (state_dtype == 0)
    dispatch_vel<ADAPT, false, float>(vel_dtype, g, sidx, order, K, table,
                                      n_rows, d, state, ds, vel, h, stream);
  else
    dispatch_vel<ADAPT, false, __nv_bfloat16>(vel_dtype, g, sidx, order, K,
                                              table, n_rows, d, state, ds, vel,
                                              h, stream);
  return 0;
}

}  // namespace

// adapt: 0 adagrad, 1 rmsprop, 2 adadelta, 3 adam. state_dtype: 0 float32,
// 1 bfloat16. vel_dtype: -1 no momentum, 0 float32, 1 bfloat16. sr_mode: 0
// round to nearest, 1 stochastic rounding of adagrad's acc / adam's second
// moment, 2 also of adam's first moment; (seed, row_offset) key its dither.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int gru4rec_sparse_update(
    int adapt, int state_dtype, int vel_dtype, int sr_mode, uint32_t seed,
    uint32_t row_offset, const void* g, const void* sidx, const void* order,
    int K, void* table, int n_rows, int d, void* state, int ds, void* vel,
    float lr, float momentum, float lmbd, float v1, float omv1, float v2,
    float omv2, float ln_v1, float ln_v2, float eps, void* stream) {
  if (K <= 0) return 0;
  const Hyper h{lr,    momentum, lmbd, v1,   omv1,       v2,          omv2,
                ln_v1, ln_v2,    eps,  seed, row_offset, sr_mode == 2};
  const int sr = sr_mode != 0;
  const float* gp = static_cast<const float*>(g);
  const int32_t* sp = static_cast<const int32_t*>(sidx);
  const int64_t* op = static_cast<const int64_t*>(order);
  float* tp = static_cast<float*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (adapt) {
    case ADAGRAD:
      err = dispatch_state<ADAGRAD>(state_dtype, sr, vel_dtype, gp, sp, op, K,
                                    tp, n_rows, d, state, ds, vel, h, st);
      break;
    case RMSPROP:
      err = dispatch_state<RMSPROP>(state_dtype, sr, vel_dtype, gp, sp, op, K,
                                    tp, n_rows, d, state, ds, vel, h, st);
      break;
    case ADADELTA:
      err = dispatch_state<ADADELTA>(state_dtype, sr, vel_dtype, gp, sp, op, K,
                                     tp, n_rows, d, state, ds, vel, h, st);
      break;
    case ADAM:
      err = dispatch_state<ADAM>(state_dtype, sr, vel_dtype, gp, sp, op, K, tp,
                                 n_rows, d, state, ds, vel, h, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
