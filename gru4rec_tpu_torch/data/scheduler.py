"""Session-parallel mini-batch schedule, precomputed as dense step arrays.

The counterpart of ``gru4rec_tpu/data/scheduler.py``: one row per step,
one column per lane —

* ``in_idx[t, b]``  — input item index of lane b at step t
* ``out_idx[t, b]`` — target item index
* ``valid[t, b]``   — lane b is alive at step t (dead lanes are masked, never
  physically removed, so every step has the same static width)
* ``reset[t, b]``   — lane b starts a new session at step t (its hidden state
  is zeroed *before* the step)

The lane walk (window length = min remaining session length; finished lanes
refilled with the next session in order; lanes that cannot refill are
retired) replicates the reference exactly, including its termination
condition (stop when fewer than 2 lanes remain and there are no extra
negative samples, reference gru4rec.py:637). ``build_schedule`` runs the
native C++ builder (``data/_native_scheduler.py``) where it can, and the
numpy builder, its oracle, otherwise: both give the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd


@dataclass
class Schedule:
    """Dense per-step schedule for session-parallel iteration."""

    in_idx: np.ndarray   # (T, B) int32
    out_idx: np.ndarray  # (T, B) int32
    valid: np.ndarray    # (T, B) bool
    reset: np.ndarray    # (T, B) bool

    @property
    def n_steps(self) -> int:
        return self.in_idx.shape[0]

    @property
    def batch_size(self) -> int:
        return self.in_idx.shape[1]

    @property
    def n_events(self) -> int:
        """Number of (input, target) training events = valid lane-steps."""
        return int(self.valid.sum())


def session_order(
    data: pd.DataFrame,
    session_key: str,
    time_key: str,
    time_sort: bool,
    n_sessions: int,
) -> np.ndarray:
    """Order in which sessions enter lanes (reference: gru4rec.py:585).

    ``time_sort=True`` orders sessions by their first-event timestamp;
    otherwise sessions are taken in session-key order.
    """
    if time_sort:
        return np.argsort(
            data.groupby(session_key, sort=True)[time_key].min().values, kind="stable"
        ).astype(np.int64)
    return np.arange(n_sessions, dtype=np.int64)


def build_schedule(
    data_items: np.ndarray,
    offsets: np.ndarray,
    order: np.ndarray,
    batch_size: int,
    require_two_lanes: bool = False,
) -> Schedule:
    """Build the dense step schedule for one epoch.

    Parameters
    ----------
    data_items : (n_events,) int array of dense item indices, session-sorted.
    offsets : (n_sessions+1,) session boundary index (CSR-style).
    order : (n_sessions,) order in which sessions are assigned to lanes.
    batch_size : number of parallel lanes (static width of the schedule).
    require_two_lanes : stop when fewer than 2 lanes remain — the reference
        does this during training when ``n_sample == 0`` because a single
        lane would have no within-batch negatives (gru4rec.py:637).
    """
    from gru4rec_tpu_torch.data import _native_scheduler

    # the native builder, or this module's numpy builder where it falls back
    return _native_scheduler.build_schedule(
        data_items, offsets, order, batch_size, require_two_lanes
    )


def _build_schedule_numpy(
    data_items: np.ndarray,
    offsets: np.ndarray,
    order: np.ndarray,
    batch_size: int,
    require_two_lanes: bool,
) -> Schedule:
    data_items = np.asarray(data_items, dtype=np.int32)
    offsets = np.asarray(offsets, dtype=np.int64)
    n_sessions = len(offsets) - 1

    n_lanes_init = min(batch_size, n_sessions)
    lanes = np.arange(n_lanes_init, dtype=np.int64)      # fixed lane ids of live lanes
    slots = np.arange(n_lanes_init, dtype=np.int64)      # order-slot per live lane
    maxiter = n_lanes_init - 1
    start = offsets[order[slots]].copy()
    end = offsets[order[slots] + 1].copy()
    pending_reset = np.ones(batch_size, dtype=bool)      # lanes starting a session next step

    blocks_in, blocks_out, blocks_valid, blocks_reset = [], [], [], []

    while True:
        if len(lanes) == 0:
            break
        minlen = int((end - start).min())
        w = minlen - 1
        if w > 0:
            # Vectorized emit of the whole window: rows = steps, cols = live lanes.
            pos = start[None, :] + np.arange(minlen, dtype=np.int64)[:, None]  # (minlen, L)
            ev = data_items[pos]                                               # (minlen, L)
            blk_in = np.zeros((w, batch_size), dtype=np.int32)
            blk_out = np.zeros((w, batch_size), dtype=np.int32)
            blk_valid = np.zeros((w, batch_size), dtype=bool)
            blk_reset = np.zeros((w, batch_size), dtype=bool)
            blk_in[:, lanes] = ev[:-1]
            blk_out[:, lanes] = ev[1:]
            blk_valid[:, lanes] = True
            blk_reset[0, lanes] = pending_reset[lanes]
            pending_reset[lanes] = False
            blocks_in.append(blk_in)
            blocks_out.append(blk_out)
            blocks_valid.append(blk_valid)
            blocks_reset.append(blk_reset)

        # Advance lanes and refill finished ones (reference: gru4rec.py:630-651).
        start = start + minlen - 1
        finished = (end - start) <= 1
        n_finished = int(finished.sum())
        slots[finished] = maxiter + np.arange(1, n_finished + 1)
        maxiter += n_finished
        alive = slots < n_sessions
        n_alive = int(alive.sum())
        if n_alive == 0 or (require_two_lanes and n_alive < 2):
            break
        refill = finished & alive
        sess = order[slots[refill]]
        start[refill] = offsets[sess]
        end[refill] = offsets[sess + 1]
        pending_reset[lanes[refill]] = True
        lanes = lanes[alive]
        slots = slots[alive]
        start = start[alive]
        end = end[alive]

    if not blocks_in:
        z = np.zeros((0, batch_size), dtype=np.int32)
        zb = np.zeros((0, batch_size), dtype=bool)
        return Schedule(z, z.copy(), zb, zb.copy())
    return Schedule(
        np.concatenate(blocks_in, axis=0),
        np.concatenate(blocks_out, axis=0),
        np.concatenate(blocks_valid, axis=0),
        np.concatenate(blocks_reset, axis=0),
    )
