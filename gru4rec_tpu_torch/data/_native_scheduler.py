"""ctypes binding for the native C++ schedule builder (``csrc/scheduler.cpp``).

The port's counterpart of ``gru4rec_tpu/data/_native_scheduler.py``, with
the same two-phase ``g4r_build_schedule`` call and argument types. The
source is a copy of the JAX package's ``csrc/scheduler.cpp``, built by
``g++`` into ``gru4rec_tpu_torch/_build/scheduler-<hash>.so`` at first use
(``ops/kernels/build.py``). The numpy builder stays as the oracle and the
fallback, which is exact, so falling back never changes a result.

It falls back only when ``GRU4REC_TPU_NO_NATIVE`` is set or no ``g++`` is
on ``PATH``. With a compiler present, a failed build or ``dlopen`` raises,
and the error carries the compiler's output. ``calls`` counts the
schedules built natively.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

_fn = None
calls = 0


def reset_calls() -> None:
    global calls
    calls = 0


def _load():
    """The bound ``g4r_build_schedule``, or None on the two fallback cases."""
    global _fn
    if os.environ.get("GRU4REC_TPU_NO_NATIVE") or shutil.which("g++") is None:
        return None
    if _fn is None:
        from gru4rec_tpu_torch.ops.kernels import build

        fn = build.load("scheduler").g4r_build_schedule
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # data_items, n_events
            ctypes.c_void_p, ctypes.c_int64,   # offsets, n_sessions
            ctypes.c_void_p,                   # order
            ctypes.c_int64, ctypes.c_int,      # batch_size, require_two_lanes
            ctypes.c_int,                      # emit
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _fn = fn
    return _fn


def available() -> bool:
    return _load() is not None


def build_schedule(data_items, offsets, order, batch_size, require_two_lanes):
    from gru4rec_tpu_torch.data.scheduler import Schedule, _build_schedule_numpy

    global calls
    fn = _load()
    if fn is None:
        return _build_schedule_numpy(
            data_items, offsets, order, batch_size, require_two_lanes
        )
    data_items = np.ascontiguousarray(data_items, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    n_sessions = len(offsets) - 1
    args_head = (
        data_items.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(data_items)),
        offsets.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n_sessions),
        order.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(batch_size), ctypes.c_int(int(require_two_lanes)),
    )
    T = fn(*args_head, 0, None, None, None, None)
    if T < 0:
        raise ValueError("native scheduler rejected its arguments")
    in_idx = np.zeros((T, batch_size), dtype=np.int32)
    out_idx = np.zeros((T, batch_size), dtype=np.int32)
    valid = np.zeros((T, batch_size), dtype=np.uint8)
    reset = np.zeros((T, batch_size), dtype=np.uint8)
    T2 = fn(
        *args_head, 1,
        in_idx.ctypes.data_as(ctypes.c_void_p),
        out_idx.ctypes.data_as(ctypes.c_void_p),
        valid.ctypes.data_as(ctypes.c_void_p),
        reset.ctypes.data_as(ctypes.c_void_p),
    )
    if T2 != T:
        raise RuntimeError(f"native scheduler counted {T} steps, then emitted {T2}")
    calls += 1
    return Schedule(in_idx, out_idx, valid.astype(bool), reset.astype(bool))
