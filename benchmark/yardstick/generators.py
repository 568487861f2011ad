"""The synthetic click streams, frozen copies of the repository's generators.

* :func:`synth_data` is ``gru4rec_tpu_torch/bench.py::synth_data``;
* :func:`synth_split` is ``chip_smoke.py::synth_split``;
* :func:`eval_sessions` is ``chip_smoke.py::eval_sessions``.

Each takes its original's arguments with the same defaults, draws with the
same calls in the same order and so gives the same frame; the catalog
size, the event count, the mean session length and the zipf exponent are
arguments here (the originals fix some of them as module constants). Item
ids are integers ``0 .. n_items - 1`` and item ``i`` has popularity
``(i + 1) ** -zipf``; session lengths are ``2 + geometric(1 / (mean_len -
2))``; ``Time`` counts the events, so sessions start in id order.

:func:`seed32` derives the 32-bit seeds of these generators (and every
other draw of the benchmark) from a run's ``--seed``, which may exceed 32
bits, and a name that keeps the streams of one run apart.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pandas as pd

# bench.py's RetailRocket shape
N_ITEMS = 36_968
N_EVENTS_TARGET = 750_000
MEAN_SESSION_LEN = 5.5
ZIPF = 0.8
# chip_smoke.py's default event count for synth_split
N_EVENTS = 100_000


def seed32(seed: int, stream: str) -> int:
    """A seed in [0, 2**31) for ``stream`` of the run seeded ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def _zipf_p(n_items: int, zipf: float) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = 1.0 / ranks**zipf
    p /= p.sum()
    return p


def synth_data(seed=0, n_items=N_ITEMS, n_events=N_EVENTS_TARGET,
               mean_len=MEAN_SESSION_LEN, zipf=ZIPF) -> pd.DataFrame:
    """``n_events`` events (about) in sessions over a zipf catalog."""
    rng = np.random.RandomState(seed)
    n_sessions = int(n_events / mean_len)
    lens = 2 + rng.geometric(1.0 / (mean_len - 2.0), size=n_sessions)
    total = int(lens.sum())
    p = _zipf_p(n_items, zipf)
    items = rng.choice(n_items, size=total, p=p).astype(np.int64)
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    return pd.DataFrame(
        {"SessionId": sess, "ItemId": items, "Time": np.arange(total, dtype=np.int64)}
    )


def synth_split(seed=0, n_items=N_ITEMS, mean_len=MEAN_SESSION_LEN, n_events=N_EVENTS,
                zipf=ZIPF):
    """:func:`synth_data`'s stream split into train (the first 90% of
    sessions) and test (the rest). Item ids that the zipf draw missed in
    train overwrite random repeated train events, so every item is in the
    training catalog."""
    rng = np.random.RandomState(seed)
    n_sessions = int(n_events / mean_len)
    lens = 2 + rng.geometric(1.0 / (mean_len - 2.0), size=n_sessions)
    total = int(lens.sum())
    p = _zipf_p(n_items, zipf)
    items = rng.choice(n_items, size=total, p=p).astype(np.int64)
    n_train = int(lens[: n_sessions * 9 // 10].sum())
    _, first = np.unique(items[:n_train], return_index=True)
    repeats = np.setdiff1d(np.arange(n_train), first)  # not an item's only event
    missing = np.setdiff1d(np.arange(n_items), items[:n_train])
    items[rng.choice(repeats, size=len(missing), replace=False)] = missing
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    data = pd.DataFrame(
        {"SessionId": sess, "ItemId": items, "Time": np.arange(total, dtype=np.int64)}
    )
    return data.iloc[:n_train], data.iloc[n_train:]


def eval_sessions(n_events, n_items, seed=1, mean_len=MEAN_SESSION_LEN,
                  zipf=ZIPF) -> pd.DataFrame:
    """``n_events`` events (about) of test sessions over a zipf catalog of
    ``n_items`` integer ids."""
    rng = np.random.RandomState(seed)
    n_sessions = int(n_events / mean_len)
    lens = 2 + rng.geometric(1.0 / (mean_len - 2.0), size=n_sessions)
    total = int(lens.sum())
    p = _zipf_p(n_items, zipf)
    items = rng.choice(n_items, size=total, p=p).astype(np.int64)
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    return pd.DataFrame({"SessionId": sess, "ItemId": items,
                         "Time": np.arange(total, dtype=np.int64)})


def sessions_csr(frame: pd.DataFrame):
    """``(items, offsets)`` of a frame sorted by session then time: the
    items of session ``s`` are ``items[offsets[s]:offsets[s + 1]]``."""
    sess = frame["SessionId"].to_numpy()
    items = frame["ItemId"].to_numpy().astype(np.int64)
    starts = np.flatnonzero(np.r_[True, sess[1:] != sess[:-1]])
    return items, np.r_[starts, len(sess)].astype(np.int64)


def lane_streams(items: np.ndarray, offsets: np.ndarray, lanes: int):
    """Serving traffic: ``lanes`` live sessions, each lane sending its
    session's clicks one call at a time and taking the next session of the
    stream when its own ends. Returns ``(session_ids, item_ids)``, both
    (calls, lanes) int64, with as many calls as every lane can fill.

    Session ``s`` goes to lane ``s % lanes``: a lane's sessions follow each
    other in stream order, as if each lane drew the next session from its
    own share of the stream."""
    n_sess = len(offsets) - 1
    sess = np.repeat(np.arange(n_sess, dtype=np.int64), np.diff(offsets))
    lane = sess % lanes
    order = np.argsort(lane, kind="stable")  # by lane, then stream order
    counts = np.bincount(lane, minlength=lanes)
    starts = np.r_[0, np.cumsum(counts)[:-1]]
    ev = order[starts[None, :] + np.arange(counts.min())[:, None]]
    return sess[ev], items[ev].astype(np.int64)
