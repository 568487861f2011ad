"""Host time of the port's evaluation schedule
(``eval/evaluation.py::_eval_schedule``) at rees46.eval's size, beside the
pandas path it replaced.

The frame is the benchmark's ``eval_1m`` stream
(``benchmark/yardstick/generators.py::eval_sessions``: 1,000,000 clicks
over 200,000 items, sorted by session and time) and a shuffled copy of it;
the item map is the benchmark model's (item id ``i`` is row ``i``); batch
512. For each frame, in turns (``--repeats`` rounds, after one untimed call
of each): the schedule (no cache, as every ``evaluate`` call of the cell
builds it) and the oracle (``tests/test_torch_eval_schedule.py::
pandas_schedule``: ``pd.merge``, a three-key ``sort_values``,
``compute_offset``, the same walk), each on the host clock. One more call
runs under a CPU ``torch.profiler`` for the ms of each of the schedule's
spans (``gru4rec.evaluate.schedule.join``, ``.sort``, ``.offsets``,
``.walk``). Both paths' arrays are compared once per frame. Prints one
JSON line per frame: each round's ms, their median and least, the spans'
ms, the sort route taken (``schedule_sorts_by_route``) and whether the
arrays matched. Needs no card.

    python3 scripts/measure_eval_schedule_torch.py [--clicks 1000000] [--items 200000]
        [--batch 512] [--repeats 5] [--seed 1]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

SPANS = ("join", "sort", "offsets", "walk")
FIELDS = ("in_idx", "out_idx", "valid", "reset")


def timed_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def span_ms(fn) -> dict:
    """The ms of each schedule span in one call of ``fn`` under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ms = dict.fromkeys(SPANS, 0.0)
    for e in prof.key_averages():
        for s in SPANS:
            if e.key == f"gru4rec.evaluate.schedule.{s}":
                ms[s] += e.cpu_time_total / 1e3
    return ms


def main():
    import pandas as pd
    import torch

    from benchmark.yardstick.generators import eval_sessions
    from gru4rec_tpu_torch.eval import evaluation
    from test_torch_eval_schedule import pandas_schedule

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clicks", type=int, default=1_000_000)
    ap.add_argument("--items", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    sorted_frame = eval_sessions(args.clicks, args.items, args.seed)
    rng = np.random.RandomState(args.seed)
    frames = {"sorted": sorted_frame,
              "shuffled": sorted_frame.iloc[rng.permutation(len(sorted_frame))]
              .reset_index(drop=True)}
    n = args.items
    itemidmap = pd.Series(np.arange(n, dtype=np.int64), index=np.arange(n, dtype=np.int64),
                          name="ItemIdx")
    model = SimpleNamespace(itemidmap=itemidmap)
    keys = ("SessionId", "ItemId", "Time")
    for name, frame in frames.items():
        def schedule():
            return evaluation._eval_schedule(model, frame, args.batch, *keys)

        def oracle():
            return pandas_schedule(itemidmap, frame, args.batch)

        evaluation.reset_schedule_sorts()
        got, want = schedule(), oracle()
        routes = dict(evaluation.schedule_sorts_by_route)
        equal = all(np.array_equal(getattr(got, f), getattr(want, f)) for f in FIELDS)
        new_ms, old_ms = [], []
        for r in range(args.repeats):
            # alternate which path goes first
            pair = (schedule, oracle) if r % 2 == 0 else (oracle, schedule)
            for fn in pair:
                (new_ms if fn is schedule else old_ms).append(timed_ms(fn))
        print(json.dumps({
            "frame": name, "rows": len(frame), "items": n, "batch": args.batch,
            "events": got.n_events, "steps": got.n_steps, "equal": equal,
            "routes": routes,
            "schedule_ms": new_ms, "schedule_ms_median": statistics.median(new_ms),
            "schedule_ms_min": min(new_ms),
            "pandas_ms": old_ms, "pandas_ms_median": statistics.median(old_ms),
            "pandas_ms_min": min(old_ms),
            "span_ms": span_ms(schedule),
            "host": {"machine": platform.machine(), "cpus": os.cpu_count(),
                     "cpu_capability": torch.backends.cpu.get_cpu_capability(),
                     "numpy": np.__version__, "pandas": pd.__version__}}), flush=True)


if __name__ == "__main__":
    main()
