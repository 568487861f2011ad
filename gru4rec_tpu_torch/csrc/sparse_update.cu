// Fused row-sparse optimizer update for Hopper (sm_90a), one launch per call.
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
//       gradients, which this kernel always forms itself from the raw
//       indices, so it needs no mode of its own;
//   K4  `_fused_update`, the v2 grid (pallas_call at :410): K1's math at
//       any width (lanes own column chunks; a row wider than 256 columns
//       takes several passes), so that is K1's code.
// Table, state and velocity rows are updated in place.
//
// Bound. Per call the kernel must read the K indices and the K gradient
// rows once, and read and write once, per distinct real row, its table,
// state and velocity rows (of adam's 128-lane count block one lane read and
// 128 written, three limbs read and written under SR). At K1's shape (table
// 36,992 x 256, f32 acc, bf16 velocity, K = 2,208, ~2,099 distinct rows)
// that is 13.0 MB, 3.886 us at 3.35 TB/s: the kernel is bound by bytes.
//
// Design. The Pallas kernels walk 8-row groups fed by an XLA sort
// (`group_pack`), for the TPU's (8,128) tiling; none of that carries over.
// The port's first design sorted the indices with torch.sort before each
// launch: that sort took twice the kernel's device time and several launches
// of its own. Here nothing precedes the kernel: no sort, no cast, no fill, no
// scratch, so a call is one device operation and one host dispatch.
//   * One warp per raw position p, kWarps per block. Indices come as int32
//     or int64 and are narrowed to int32 as the plain version's
//     idx.to(int32) does; a row outside [0, n_rows) (the int32-max sentinel
//     of masked lanes, a padding row) is dropped.
//   * Run rule (the dedup). Warp p works only if idx[p] is real and no q < p
//     holds the same row: it is the run head. It sums the gradient rows of
//     every position q >= p with that row in ascending q, the order of the
//     stable sort the first design used, so every output is bit-identical to
//     it (the SR dither depends only on (seed, row, column)).
//   * The dedup pass (csrc/dedup.cuh, shared with the adagrad prototypes).
//     Each block reads the K indices once, coalesced from global memory (L2
//     after the first blocks), kUnroll per thread at a time, and compares
//     each with its kWarps warps' rows, held in registers. A match is rare
//     (another position of a warp's row): below the warp's position it marks
//     the warp as no head, above it appends the position to the warp's list
//     in shared memory (in no order; kRunCap kept), which the head then
//     ranks into ascending order. Slower on the
//     card at the flagship shape (PERF.md): every warp scanning all K
//     indices staged in shared memory, staging them with cp.async, loading
//     more of them per thread at a time, and blocks of 4 or 12 warps.
//   * Cost of the dedup: K^2 / kWarps index loads (from L2) and K^2
//     compares per call, ~12 instructions per index and thread: about
//     0.05 K^2 warp-instructions, 230k at K = 2,208, ~0.25 us of issue spread
//     over the 528 schedulers. It grows as K^2 while the byte bound grows as
//     K (~1.76 ns per position at d = 256), so it passes the bound near
//     K = 35,000; the repo's largest K (2 x 256 + 2,048) is 2,560.
//   * Speculative loads. Before the dedup pass each warp loads its own
//     gradient row and, once its index is known, its table, state and
//     velocity rows (about 95% of positions head a run at the flagship
//     shape), so the pass runs while those loads are in flight; the rows of
//     later passes (widths above 256) are prefetched into L2. The gradient
//     rows of a run's further positions are prefetched into L2 as the pass
//     finds them and read kBatch at a time.
//   * Mode tag. The kernel's last template argument names the TPU kernel a
//     launch stands for, as the wrapper's `mode_of` does: `k1_width128`
//     (non-SR, a width that is a multiple of 128), `k4_any_width` (non-SR,
//     any other width), `k2_k3_sr` (SR). It changes no generated code; it
//     makes K4's launches read apart from K1's by name in a trace.
//   * Vector access. A lane owns kCols columns per pass in chunks of VEC
//     contiguous columns: VEC = 4 (float4, or 8 bytes of bfloat16) when the
//     host finds every row pitch and base pointer aligned to that (widths
//     300, 256, 128, 12), else VEC = 1 (widths 225, 481, 513), both
//     coalesced. Every load of a pass is issued before the dependent math.
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
// high half of (bits(x) + dither) & 0xFFFF0000. The seed comes by value, or
// from device memory (`seed_ptr`, an int32 read by every head warp) where
// the caller's seed lives on the device: a captured training step replays
// with each step's seed (train/step.py). The unrounded float32 value
// drives the step's update. Adam's count is stored as base-256 limbs in
// lanes 0..2 of its block (lanes 3..127 are 0); its first moment is rounded
// stochastically (on buffer columns d..2d-1) only in SR mode 2 (v1 > 0.99),
// else to nearest.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "dedup.cuh"

namespace {

using dedup::kFull;
using dedup::kRunCap;

enum Adapt { ADAGRAD = 0, RMSPROP = 1, ADADELTA = 2, ADAM = 3 };

constexpr int kWarps = 8;               // raw positions (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;              // indices a thread loads at once
constexpr int kCols = 8;                // columns a lane owns per pass
constexpr int kPassCols = 32 * kCols;   // columns per pass
constexpr int kBatch = 2;               // gradient rows of a run read together
constexpr int kMinBlocks = 3;           // resident blocks per SM: <= 80 registers

struct Hyper {
  float lr, momentum, lmbd;
  float v1, omv1, v2, omv2;  // decays and (1 - decay), rounded from double
  float ln_v1, ln_v2;        // log of the decays (-inf for a zero decay)
  float eps;
  uint32_t seed, row_offset;  // SR dither key
  const int32_t* seed_ptr;    // the seed on the device, or null for `seed`
  int sr_m;                   // SR also for adam's first moment
};

struct Args {
  const float* g;    // (K, d) gradient rows
  const void* idx;   // (K) int32 or int64 raw indices
  int idx64, K;
  float* table;      // (n_rows, d)
  int n_rows, d;
  void* state;       // (n_rows, ds)
  int ds;
  void* vel;         // (n_rows, d), or null without momentum
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// bfloat16 bits of v: round to nearest even, or the SR dither `bits` added
// to the float32 bits and the low half dropped
__device__ __forceinline__ uint32_t bf16_rn(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t bf16_sr(float v, uint32_t bits) {
  return (__float_as_uint(v) + bits) >> 16;
}

// VEC contiguous values at p (aligned to VEC elements when VEC = 4), widened
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = load(p);
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(u.x << 16);
    out[1] = __uint_as_float(u.x & 0xFFFF0000u);
    out[2] = __uint_as_float(u.y << 16);
    out[3] = __uint_as_float(u.y & 0xFFFF0000u);
  }
}

// VEC values to p: float32 as they are; bfloat16 rounded to nearest even,
// or stochastically (SR) with the dither of (seed, hrow, col + e)
template <int VEC, bool SR = false, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in,
                                          uint32_t seed = 0, uint32_t hrow = 0,
                                          int col = 0) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 1)
      *p = in[0];
    else
      *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    uint32_t b[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      b[e] = SR ? bf16_sr(in[e], sr_bits16(seed, hrow, col + e)) : bf16_rn(in[e]);
    if constexpr (VEC == 1)
      *p = __ushort_as_bfloat16(static_cast<unsigned short>(b[0]));
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
  }
}

// Column of element e of chunk j of this lane in the pass starting at base.
template <int VEC>
__device__ __forceinline__ int col_of(int base, int j, int lane) {
  return base + (j * 32 + lane) * VEC;
}

// This lane's columns of the pass starting at `base` of `row` (d columns);
// columns past d are left 0.
template <int VEC, typename T>
__device__ __forceinline__ void load_cols(const T* row, int d, int base,
                                          int lane, float* out) {
#pragma unroll
  for (int j = 0; j < kCols / VEC; ++j) {
    const int c = col_of<VEC>(base, j, lane);
    if (c < d) load_vec<VEC>(row + c, out + j * VEC);
  }
}

// An L2 prefetch of this lane's columns of the pass at `base` of `row`.
template <int VEC, typename T>
__device__ __forceinline__ void prefetch_cols(const T* row, int d, int base,
                                              int lane) {
#pragma unroll
  for (int j = 0; j < kCols / VEC; ++j) {
    const int c = col_of<VEC>(base, j, lane);
    if (c < d) asm volatile("prefetch.global.L2 [%0];" ::"l"(row + c));
  }
}

// Raw index q, as dedup::real_row gives it.
__device__ __forceinline__ int row_at(const Args& a, int q) {
  return dedup::row_at(a.idx, a.idx64, q, a.n_rows);
}

// The mode tags (header: "Mode tag"): a kernel's name in a trace says which
// TPU kernel the launch stands for.
struct k1_width128 {};
struct k4_any_width {};
struct k2_k3_sr {};

// One column of the update, float32 math in registers: gc the summed
// gradient, t the table value, s1 / s2 the state slots (acc; adadelta's upd
// or adam's meang), v the velocity; updated in place.
template <int ADAPT, bool MOM>
__device__ __forceinline__ void update(float gc, float& t, float& s1,
                                       float& s2, float& v, const Hyper& h,
                                       float corr1, float corr2) {
  const float gg = gc * gc;
  float gs;
  if (ADAPT == ADAGRAD) {
    const float acc = s1 + gg;
    s1 = acc;
    gs = gc / sqrtf(acc + h.eps);
  } else if (ADAPT == RMSPROP) {
    const float acc = h.v1 * s1 + h.omv1 * gg;
    s1 = acc;
    gs = gc / sqrtf(acc + h.eps);
  } else if (ADAPT == ADADELTA) {
    const float acc = h.v1 * s1 + h.omv1 * gg;
    const float upd_old = s2;
    const float scal = (upd_old + h.eps) / (acc + h.eps);
    s2 = h.v1 * upd_old + (h.omv1 * scal) * gg;
    s1 = acc;
    gs = gc * sqrtf(scal);
  } else {  // ADAM: [acc | meang | count block]
    const float acc = h.v2 * s1 + h.omv2 * gg;
    const float m = h.v1 * s2 + h.omv1 * gc;
    s1 = acc;
    s2 = m;
    gs = (m / corr1) / (sqrtf(acc / corr2) + h.eps);
  }
  const float t_old = t;
  const float delta = h.lmbd > 0.f ? h.lr * (gs + h.lmbd * t_old) : h.lr * gs;
  if (MOM) {
    const float vn = h.momentum * v - delta;
    v = vn;
    t = t_old + vn;
  } else {
    t = t_old - delta;
  }
}

// The rows of one pass: this lane's columns of the gradient row (summed
// over the run later), the table, the state slots and the velocity.
struct Pass {
  float g[kCols], t[kCols], s1[kCols], s2[kCols], v[kCols];
};

template <int ADAPT, bool MOM, int VEC, typename ST, typename VT>
__device__ __forceinline__ void load_rows(Pass& x, const float* trow,
                                          const ST* srow, const VT* vrow,
                                          int d, int base, int lane) {
  load_cols<VEC>(trow, d, base, lane, x.t);
  load_cols<VEC>(srow, d, base, lane, x.s1);
  if (ADAPT == ADADELTA || ADAPT == ADAM) load_cols<VEC>(srow + d, d, base, lane, x.s2);
  if (MOM) load_cols<VEC>(vrow, d, base, lane, x.v);
}

template <int ADAPT, bool MOM, bool SR, typename ST, typename VT, int VEC, typename MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_update_kernel(Args a, Hyper h) {
  __shared__ int s_row[kWarps];             // each warp's row, -2 if none
  __shared__ int s_earlier[kWarps];         // an earlier position holds it
  __shared__ int s_nlater[kWarps];          // later positions that hold it
  __shared__ int s_later[kWarps][kRunCap];  // the first kRunCap of them
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kWarps, p = p0 + w;
  const int d = a.d;
  ST* state = static_cast<ST*>(a.state);
  VT* vel = static_cast<VT*>(a.vel);

  // Speculative: this position's gradient row and index, the dedup pass's
  // first indices, then (once the index is known) its row's table, state
  // and velocity, all of the first pass; the dedup pass runs while they
  // arrive.
  Pass x;
#pragma unroll
  for (int i = 0; i < kCols; ++i) x.g[i] = x.t[i] = x.s1[i] = x.s2[i] = x.v[i] = 0.f;
  int r = -1;
  if (p < a.K) {
    load_cols<VEC>(a.g + (int64_t)p * d, d, 0, lane, x.g);
    r = row_at(a, p);
  }
  int v[kUnroll];
  dedup::first_round<kThreads>(v, a.idx, a.idx64, a.K, a.n_rows);
  if (lane == 0) {
    s_row[w] = r < 0 ? -2 : r;
    s_earlier[w] = 0;
    s_nlater[w] = 0;
  }
  float* trow = a.table + (int64_t)(r < 0 ? 0 : r) * d;
  ST* srow = state + (int64_t)(r < 0 ? 0 : r) * a.ds;
  VT* vrow = MOM ? vel + (int64_t)(r < 0 ? 0 : r) * d : nullptr;
  for (int base = kPassCols; base < d; base += kPassCols) {  // later passes
    prefetch_cols<VEC>(a.g + (int64_t)p * d, p < a.K ? d : 0, base, lane);
    if (r < 0) continue;
    prefetch_cols<VEC>(trow, d, base, lane);
    prefetch_cols<VEC>(srow, d, base, lane);
    if (ADAPT == ADADELTA || ADAPT == ADAM) prefetch_cols<VEC>(srow + d, d, base, lane);
    if (MOM) prefetch_cols<VEC>(vrow, d, base, lane);
  }
  float cnt = 0.f;
  if (r >= 0) {
    load_rows<ADAPT, MOM, VEC>(x, trow, srow, vrow, d, 0, lane);
    if (ADAPT == ADAM) {
      if (SR)  // base-256 limbs in lanes 0..2
        cnt = (load(srow + 2 * d + 2) * 256.0f + load(srow + 2 * d + 1)) * 256.0f +
              load(srow + 2 * d) + 1.0f;
      else
        cnt = load(srow + 2 * d) + 1.0f;
    }
  }

  // The dedup pass (see the header): every index against the block's rows.
  __syncthreads();
  int rows[kWarps];
#pragma unroll
  for (int k = 0; k < kWarps; ++k) rows[k] = s_row[k];
  const dedup::Runs runs{s_earlier, s_nlater, s_later};
  const int pf_cols = min(d, kPassCols);  // the run rows' first pass to L2
  dedup::scan<kThreads>(v, a.idx, a.idx64, a.K, a.n_rows, [&](int x, int q) {
    dedup::match_rows(rows, x, q, p0, runs, a.g, d, pf_cols);
  });
  __syncthreads();
  if (r < 0 || s_earlier[w]) return;

  // The run's further positions, ascending: lane k holds the k-th.
  const int nrun = s_nlater[w];
  int myq = 0;
  if (nrun <= kRunCap) {
    dedup::rank_list(s_later[w], nrun, lane);
    myq = s_later[w][lane];
  }

  const uint32_t hrow = h.row_offset + static_cast<uint32_t>(r);
  const uint32_t seed = SR && h.seed_ptr ? static_cast<uint32_t>(*h.seed_ptr) : h.seed;
  const float corr1 = ADAPT == ADAM ? -expm1f(cnt * h.ln_v1) : 1.f;
  const float corr2 = ADAPT == ADAM ? -expm1f(cnt * h.ln_v2) : 1.f;
  for (int base = 0; base < d; base += kPassCols) {
    if (base) {
      load_cols<VEC>(a.g + (int64_t)p * d, d, base, lane, x.g);
      load_rows<ADAPT, MOM, VEC>(x, trow, srow, vrow, d, base, lane);
    }
    // the run's gradient sum in ascending position, from 0 as the first
    // design's (and the plain version's) sums start
    float* gs = x.g;
#pragma unroll
    for (int i = 0; i < kCols; ++i) gs[i] = 0.f + gs[i];
    if (nrun <= kRunCap) {
      for (int k0 = 0; k0 < nrun; k0 += kBatch) {
        float y[kBatch][kCols] = {};
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int q = __shfl_sync(kFull, myq, k0 + k);
          if (k0 + k < nrun) load_cols<VEC>(a.g + (int64_t)q * d, d, base, lane, y[k]);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (k0 + k < nrun) {
#pragma unroll
            for (int i = 0; i < kCols; ++i) gs[i] += y[k][i];
          }
      }
    } else {  // more further positions than listed: walk the indices again
      dedup::for_each_later(a.idx, a.idx64, a.K, a.n_rows, p, r, lane, [&](int q) {
        float y[kCols] = {};
        load_cols<VEC>(a.g + (int64_t)q * d, d, base, lane, y);
#pragma unroll
        for (int i = 0; i < kCols; ++i) gs[i] += y[i];
      });
    }

#pragma unroll
    for (int j = 0; j < kCols / VEC; ++j) {
      const int c = col_of<VEC>(base, j, lane);
      if (c >= d) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = j * VEC + e;
        update<ADAPT, MOM>(gs[i], x.t[i], x.s1[i], x.s2[i], x.v[i], h, corr1, corr2);
      }
      store_vec<VEC>(trow + c, x.t + j * VEC);
      constexpr bool sr_acc = SR && (ADAPT == ADAGRAD || ADAPT == ADAM);
      store_vec<VEC, sr_acc>(srow + c, x.s1 + j * VEC, seed, hrow, c);
      if (ADAPT == ADAM && SR && h.sr_m)
        store_vec<VEC, true>(srow + d + c, x.s2 + j * VEC, seed, hrow, d + c);
      else if (ADAPT == ADADELTA || ADAPT == ADAM)
        store_vec<VEC>(srow + d + c, x.s2 + j * VEC);
      if (MOM) store_vec<VEC>(vrow + c, x.v + j * VEC);
    }
  }

  if (ADAPT == ADAM) {  // the count block, after every lane has read it
    __syncwarp();
    const float hi = floorf(cnt / 65536.0f);  // the SR limbs
    const float rem = cnt - hi * 65536.0f;
    const float mid = floorf(rem / 256.0f);
    const float lo = rem - mid * 256.0f;
    for (int c = 2 * d + lane * VEC; c < a.ds; c += 32 * VEC) {
      float vals[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int k = c + e - 2 * d;
        vals[e] = !SR ? cnt : k == 0 ? lo : k == 1 ? mid : k == 2 ? hi : 0.0f;
      }
      store_vec<VEC>(srow + c, vals);
    }
  }
}

template <int ADAPT, bool MOM, bool SR, typename ST, typename VT, typename MODE>
void launch(const Args& a, int vec, const Hyper& h, cudaStream_t stream) {
  const int blocks = (a.K + kWarps - 1) / kWarps;
  if (vec)
    sparse_update_kernel<ADAPT, MOM, SR, ST, VT, 4, MODE><<<blocks, kThreads, 0, stream>>>(a, h);
  else
    sparse_update_kernel<ADAPT, MOM, SR, ST, VT, 1, MODE><<<blocks, kThreads, 0, stream>>>(a, h);
}

template <int ADAPT, bool SR, typename ST, typename MODE>
void dispatch_vel(int vel_dtype, const Args& a, int vec, const Hyper& h,
                  cudaStream_t stream) {
  if (vel_dtype < 0)
    launch<ADAPT, false, SR, ST, float, MODE>(a, vec, h, stream);
  else if (vel_dtype == 0)
    launch<ADAPT, true, SR, ST, float, MODE>(a, vec, h, stream);
  else
    launch<ADAPT, true, SR, ST, __nv_bfloat16, MODE>(a, vec, h, stream);
}

// Non-SR state, the launch tagged K1 or K4 by width (the wrapper's mode_of).
template <int ADAPT, typename MODE>
void dispatch_plain(int state_dtype, int vel_dtype, const Args& a, int vec,
                    const Hyper& h, cudaStream_t stream) {
  if (state_dtype == 0)
    dispatch_vel<ADAPT, false, float, MODE>(vel_dtype, a, vec, h, stream);
  else
    dispatch_vel<ADAPT, false, __nv_bfloat16, MODE>(vel_dtype, a, vec, h, stream);
}

// Returns cudaErrorInvalidValue for a combination the kernel does not take
// (SR is adagrad/adam with bfloat16 state only), else 0.
template <int ADAPT>
int dispatch_state(int state_dtype, int sr, int vel_dtype, const Args& a,
                   int vec, const Hyper& h, cudaStream_t stream) {
  if (sr) {
    if constexpr (ADAPT == ADAGRAD || ADAPT == ADAM) {
      if (state_dtype != 1) return (int)cudaErrorInvalidValue;
      dispatch_vel<ADAPT, true, __nv_bfloat16, k2_k3_sr>(vel_dtype, a, vec, h, stream);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (a.d % 128 == 0)
    dispatch_plain<ADAPT, k1_width128>(state_dtype, vel_dtype, a, vec, h, stream);
  else
    dispatch_plain<ADAPT, k4_any_width>(state_dtype, vel_dtype, a, vec, h, stream);
  return 0;
}

}  // namespace

// adapt: 0 adagrad, 1 rmsprop, 2 adadelta, 3 adam. state_dtype: 0 float32,
// 1 bfloat16. vel_dtype: -1 no momentum, 0 float32, 1 bfloat16. sr_mode: 0
// round to nearest, 1 stochastic rounding of adagrad's acc / adam's second
// moment, 2 also of adam's first moment; (seed, row_offset) key its dither,
// the seed read from the int32 at seed_ptr on the device unless it is null.
// idx64: the K raw indices are int64 (else int32). vec: 1 when every row
// pitch and base pointer of g, table, state and velocity is aligned to 4
// elements (the wrapper checks), else 0. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int gru4rec_sparse_update(
    int adapt, int state_dtype, int vel_dtype, int sr_mode, uint32_t seed,
    const int32_t* seed_ptr, uint32_t row_offset, const void* g, const void* idx, int idx64, int K,
    void* table, int n_rows, int d, void* state, int ds, void* vel, int vec,
    float lr, float momentum, float lmbd, float v1, float omv1, float v2,
    float omv2, float ln_v1, float ln_v2, float eps, void* stream) {
  if (K <= 0) return 0;
  const Hyper h{lr,    momentum, lmbd,       v1,      omv1,
                v2,    omv2,     ln_v1,      ln_v2,   eps,
                seed,  row_offset, seed_ptr, sr_mode == 2};
  const Args a{static_cast<const float*>(g), idx, idx64, K,
               static_cast<float*>(table), n_rows, d, state, ds, vel};
  const int sr = sr_mode != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (adapt) {
    case ADAGRAD:
      err = dispatch_state<ADAGRAD>(state_dtype, sr, vel_dtype, a, vec, h, st);
      break;
    case RMSPROP:
      err = dispatch_state<RMSPROP>(state_dtype, sr, vel_dtype, a, vec, h, st);
      break;
    case ADADELTA:
      err = dispatch_state<ADADELTA>(state_dtype, sr, vel_dtype, a, vec, h, st);
      break;
    case ADAM:
      err = dispatch_state<ADAM>(state_dtype, sr, vel_dtype, a, vec, h, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
