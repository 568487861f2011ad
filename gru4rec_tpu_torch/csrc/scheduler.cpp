// Native session-parallel schedule builder.
//
// C++ implementation of the lane-walk in gru4rec_tpu/data/scheduler.py (the
// re-design of the reference's host hot loop, gru4rec.py:587-651): windows of
// length (min remaining session length - 1), finished lanes refilled with the
// next session in order, dead lanes masked. Emits the dense (T, B) step
// arrays consumed by the device scan. Two-phase API: emit=0 counts steps,
// emit=1 fills caller-allocated buffers.
//
// Built as a shared library (see csrc/Makefile) and loaded through ctypes by
// gru4rec_tpu/data/_native_scheduler.py; the NumPy builder remains as the
// always-available fallback and differential-testing oracle (the same
// pattern as the reference's disable_custom_op fallbacks, gpu_ops.py:13-27).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of steps T (>= 0), or -1 on invalid arguments.
int64_t g4r_build_schedule(
    const int32_t* data_items, int64_t n_events,
    const int64_t* offsets, int64_t n_sessions,
    const int64_t* order,
    int64_t batch_size, int require_two_lanes,
    int emit,
    int32_t* in_idx, int32_t* out_idx, uint8_t* valid, uint8_t* reset) {
  if (batch_size <= 0 || n_sessions < 0 || n_events < 0) return -1;
  // validate the index structure up front: the NumPy fallback raises
  // IndexError on these, and native out-of-bounds reads would instead
  // produce a silently garbage schedule (or a segfault)
  for (int64_t s = 0; s < n_sessions; ++s) {
    if (offsets[s] > offsets[s + 1]) return -1;  // non-monotonic
    if (order[s] < 0 || order[s] >= n_sessions) return -1;
  }
  if (n_sessions > 0 &&
      (offsets[0] < 0 || offsets[n_sessions] > n_events)) return -1;

  const int64_t n_init = batch_size < n_sessions ? batch_size : n_sessions;
  std::vector<int64_t> lanes, slots, start, end;
  lanes.reserve(n_init);
  for (int64_t i = 0; i < n_init; ++i) {
    lanes.push_back(i);
    slots.push_back(i);
    start.push_back(offsets[order[i]]);
    end.push_back(offsets[order[i] + 1]);
  }
  std::vector<uint8_t> pending_reset(batch_size, 1);
  int64_t maxiter = n_init - 1;
  int64_t t = 0;

  while (!lanes.empty()) {
    // window length = min remaining session length
    int64_t minlen = INT64_MAX;
    for (size_t j = 0; j < lanes.size(); ++j) {
      const int64_t rem = end[j] - start[j];
      if (rem < minlen) minlen = rem;
    }
    const int64_t w = minlen - 1;
    if (w > 0) {
      if (emit) {
        for (int64_t i = 0; i < w; ++i) {
          int32_t* in_row = in_idx + (t + i) * batch_size;
          int32_t* out_row = out_idx + (t + i) * batch_size;
          uint8_t* va_row = valid + (t + i) * batch_size;
          uint8_t* re_row = reset + (t + i) * batch_size;
          std::memset(in_row, 0, sizeof(int32_t) * batch_size);
          std::memset(out_row, 0, sizeof(int32_t) * batch_size);
          std::memset(va_row, 0, batch_size);
          std::memset(re_row, 0, batch_size);
          for (size_t j = 0; j < lanes.size(); ++j) {
            const int64_t b = lanes[j];
            in_row[b] = data_items[start[j] + i];
            out_row[b] = data_items[start[j] + i + 1];
            va_row[b] = 1;
            if (i == 0) {
              re_row[b] = pending_reset[b];
              pending_reset[b] = 0;
            }
          }
        }
      } else {
        for (size_t j = 0; j < lanes.size(); ++j) pending_reset[lanes[j]] = 0;
      }
      t += w;
    }

    // advance + refill (reference: gru4rec.py:630-651)
    int64_t n_alive = 0;
    size_t keep = 0;
    for (size_t j = 0; j < lanes.size(); ++j) {
      start[j] += minlen - 1;
      const bool finished = (end[j] - start[j]) <= 1;
      if (finished) slots[j] = ++maxiter;
      if (slots[j] < n_sessions) ++n_alive;
    }
    if (n_alive == 0 || (require_two_lanes && n_alive < 2)) break;
    for (size_t j = 0; j < lanes.size(); ++j) {
      if (slots[j] >= n_sessions) continue;  // lane retired
      const bool finished = (end[j] - start[j]) <= 1;
      if (finished) {
        const int64_t sess = order[slots[j]];
        start[j] = offsets[sess];
        end[j] = offsets[sess + 1];
        pending_reset[lanes[j]] = 1;
      }
      lanes[keep] = lanes[j];
      slots[keep] = slots[j];
      start[keep] = start[j];
      end[keep] = end[j];
      ++keep;
    }
    lanes.resize(keep);
    slots.resize(keep);
    start.resize(keep);
    end.resize(keep);
  }
  return t;
}

}  // extern "C"
