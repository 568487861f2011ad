"""``eval/evaluation.py::_eval_schedule`` against the pandas path it
replaced (:func:`pandas_schedule`, the oracle): an inner ``pd.merge`` with
the item map, a ``sort_values`` on (session, time, item) and
``data/tools.py::compute_offset``, then the same lane walk.

Every frame below gives equal ``in_idx``, ``out_idx``, ``valid`` and
``reset`` arrays, so equal evaluable-event counts, at batch 8 and 512, and
runs the sort route the frame's dtypes and ranges call for
(``schedule_sorts_by_route``). ``scripts/measure_eval_schedule_torch.py``
times both paths at the benchmark's size with this oracle.
"""

from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from gru4rec_tpu_torch.data.scheduler import build_schedule
from gru4rec_tpu_torch.data.tools import compute_offset
from gru4rec_tpu_torch.eval import evaluation

FIELDS = ("in_idx", "out_idx", "valid", "reset")
KEYS = dict(session_key="SessionId", item_key="ItemId", time_key="Time")
N_ITEMS = 60


def pandas_schedule(itemidmap, test_data, batch_size, session_key="SessionId",
                    item_key="ItemId", time_key="Time"):
    """The oracle: the evaluation schedule as pandas builds it."""
    data = pd.merge(
        test_data,
        pd.DataFrame({"ItemIdx": itemidmap.values, item_key: itemidmap.index}),
        on=item_key,
        how="inner",
    )
    data.sort_values([session_key, time_key, item_key], inplace=True)
    offsets = compute_offset(data, session_key)
    order = np.arange(len(offsets) - 1, dtype=np.int64)
    return build_schedule(data["ItemIdx"].values.astype(np.int32), offsets, order,
                          batch_size)


def sessions(rng, n_sessions=300):
    """Sessions of 1-8 clicks in order, times rising, over ``N_ITEMS`` items;
    the item map's ids in a shuffled first-appearance order."""
    lens = rng.randint(1, 9, size=n_sessions)
    n = int(lens.sum())
    frame = pd.DataFrame({"SessionId": np.repeat(np.arange(n_sessions, dtype=np.int64), lens),
                          "ItemId": rng.randint(0, N_ITEMS, size=n).astype(np.int64),
                          "Time": np.arange(n, dtype=np.int64)})
    itemidmap = pd.Series(np.arange(N_ITEMS, dtype=np.int64),
                          index=rng.permutation(N_ITEMS).astype(np.int64), name="ItemIdx")
    return frame, itemidmap


def shuffled(rng, frame):
    return frame.iloc[rng.permutation(len(frame))].reset_index(drop=True)


def case_sorted(rng):
    return sessions(rng) + ("packed",)


def case_shuffled(rng):
    frame, itemidmap = sessions(rng)
    return shuffled(rng, frame), itemidmap, "packed"


def case_unseen_items(rng):
    frame, itemidmap = sessions(rng)
    return shuffled(rng, frame), itemidmap[itemidmap.index % 4 != 1], "packed"


def case_time_ties(rng):
    # pairs of clicks at one time in a session, mostly on two items: the
    # item decides their order
    frame, itemidmap = sessions(rng)
    frame["Time"] = frame["Time"] // 2
    return shuffled(rng, frame), itemidmap, "packed"


def case_duplicate_rows(rng):
    frame, itemidmap = sessions(rng)
    frame = pd.concat([frame, frame.iloc[::3], frame.iloc[::7]], ignore_index=True)
    return shuffled(rng, frame), itemidmap, "packed"


def case_session_ids(rng):
    # non-contiguous, negative and descending session ids
    frame, itemidmap = sessions(rng)
    frame["SessionId"] = 1_000 - 37 * frame["SessionId"]
    return shuffled(rng, frame), itemidmap, "packed"


def case_extreme_ids(rng):
    # uint32 sessions, uint64 times past int64's range, item ids just below
    # int64's largest
    frame, itemidmap = sessions(rng)
    frame["SessionId"] = frame["SessionId"].astype(np.uint32)
    frame["Time"] = frame["Time"].astype(np.uint64) * np.uint64(3) + np.uint64(2**63)
    frame["ItemId"] += 2**63 - 1_000
    itemidmap.index = itemidmap.index + (2**63 - 1_000)
    return shuffled(rng, frame), itemidmap, "packed"


def case_float_times(rng):
    frame, itemidmap = sessions(rng)
    frame["Time"] = rng.uniform(0, 1e4, size=len(frame)).round(1)
    return shuffled(rng, frame), itemidmap, "lexsort"


def case_string_ids(rng):
    # "s10" sorts before "s9": string order, not the numbers'; the sorted
    # codes of strings pack as integers do
    frame, itemidmap = sessions(rng)
    frame["SessionId"] = ["s%d" % s for s in frame["SessionId"]]
    frame["ItemId"] = ["i%d" % i for i in frame["ItemId"]]
    itemidmap.index = ["i%d" % i for i in itemidmap.index]
    return shuffled(rng, frame), itemidmap, "packed"


def case_missing_values(rng):
    # rows of a missing session are no session (``groupby`` leaves them
    # out); missing times (a nullable integer column) sort last in their
    # session
    frame, itemidmap = sessions(rng)
    frame["SessionId"] = pd.Series(["s%d" % s for s in frame["SessionId"]], dtype=object)
    frame.loc[rng.rand(len(frame)) < 0.05, "SessionId"] = None
    frame["Time"] = frame["Time"].astype("Int64")
    frame.loc[rng.rand(len(frame)) < 0.1, "Time"] = pd.NA
    return shuffled(rng, frame), itemidmap, "packed"


def case_empty_join(rng):
    frame, itemidmap = sessions(rng)
    itemidmap.index = itemidmap.index + N_ITEMS
    return frame, itemidmap, "lexsort"


def case_wide_ranges(rng):
    # session and time ranges whose product with the items' passes 63 bits
    frame, itemidmap = sessions(rng)
    frame["SessionId"] = frame["SessionId"] * 2**40 - 2**45
    frame["Time"] = frame["Time"] * 2**30
    return shuffled(rng, frame), itemidmap, "lexsort"


CASES = [case_sorted, case_shuffled, case_unseen_items, case_time_ties,
         case_duplicate_rows, case_session_ids, case_extreme_ids, case_float_times,
         case_string_ids, case_missing_values, case_empty_join, case_wide_ranges]


@pytest.mark.parametrize("batch_size", [8, 512])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_schedule_equals_the_pandas_path(case, batch_size):
    frame, itemidmap, route = case(np.random.RandomState(CASES.index(case)))
    before = frame.copy()
    want = pandas_schedule(itemidmap, frame, batch_size)
    evaluation.reset_schedule_sorts()
    got = evaluation._eval_schedule(SimpleNamespace(itemidmap=itemidmap), frame,
                                    batch_size, **KEYS)
    assert evaluation.schedule_sorts_by_route == {
        r: int(r == route) for r in evaluation.SORT_ROUTES}
    assert got.n_events == want.n_events
    assert (want.n_events == 0) == (case is case_empty_join)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    pd.testing.assert_frame_equal(frame, before)


def test_a_cache_hit_sorts_nothing():
    frame, itemidmap, _ = case_shuffled(np.random.RandomState(0))
    model, cache = SimpleNamespace(itemidmap=itemidmap), {}
    evaluation.reset_schedule_sorts()
    first = evaluation._eval_schedule(model, frame, 8, **KEYS, sched_cache=cache)
    again = evaluation._eval_schedule(model, frame, 8, **KEYS, sched_cache=cache)
    assert again is first
    assert evaluation.schedule_sorts_by_route == {"packed": 1, "lexsort": 0}
