"""Evaluation throughput of the PyTorch port at the reference's published
protocol, on one CUDA device: the counterpart of ``scripts/measure_eval.py``.

The protocol: batch 512, cutoffs 1/5/10/20, the standard tie mode, a
synthetic test set of 60,000 events (zipf-0.8 item popularity, mean session
length 5.5; ``measure_eval.py``'s generator, ``chip_smoke.eval_sessions``)
at two published shapes:

  retailrocket  36,968 items, GRU-224, bpr-max / elu-0.5
  rees46        200,000 items, GRU-512, cross-entropy / softmax

The model's weights come from the seeded initialisation over the whole
catalog (evaluation cost does not depend on training). At each shape, in
one process and in turns (``--repeats`` rounds), ``evaluate`` runs three
ways: ``eager`` (the eager loop, ``_eager=True``), ``graph`` (the default:
the call captures its step and frees the graph when it returns) and
``graph_kept`` (the graph kept across calls, as ``fit``'s validation keeps
it: every step replays). A first call of each way is not timed. Prints one
JSON line per shape and way: warm seconds (each round, and their minimum
and median), events/s and ms per 512-event block at the median, ms per
step, the device memory peak of a call and the graph pool's bytes, with
the card's name and power limit.

    python3 scripts/measure_eval_torch.py [--shapes retailrocket rees46] [--events 60000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_TEST_EVENTS = 60_000
CUTOFFS = [1, 5, 10, 20]
BATCH = 512
SHAPES = {
    "retailrocket": dict(n_items=36_968, layers=[224], loss="bpr-max",
                         final_act="elu-0.5"),
    "rees46": dict(n_items=200_000, layers=[512], loss="cross-entropy",
                   final_act="softmax"),
}
WAYS = ("eager", "graph", "graph_kept")


def shape_model(shape, seed=0):
    """``chip_smoke.seeded_model`` at ``shape``: the card, the whole catalog
    (integer item ids), the seeded initialisation."""
    from chip_smoke import seeded_model
    from gru4rec_tpu_torch import GRU4RecConfig

    sh = SHAPES[shape]
    cfg = GRU4RecConfig(loss=sh["loss"], final_act=sh["final_act"], layers=sh["layers"],
                        batch_size=80, n_sample=2048, constrained_embedding=True,
                        seed=seed)
    return seeded_model(cfg, sh["n_items"])


def eval_test_set(shape, n_events):
    """``measure_eval.py``'s test set (``chip_smoke.eval_sessions``)."""
    from chip_smoke import eval_sessions

    return eval_sessions(n_events, SHAPES[shape]["n_items"], seed=1)


def run_way(model, test, way, graphs, mode="standard"):
    """One ``evaluate`` call the given way: (seconds, recall, mrr)."""
    from gru4rec_tpu_torch import evaluate

    t0 = time.perf_counter()
    rec, mrr = evaluate(model, test, cut_off=CUTOFFS, batch_size=BATCH, mode=mode,
                        _eager=way == "eager",
                        _graphs=graphs if way == "graph_kept" else None)
    return time.perf_counter() - t0, rec, mrr


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--events", type=int, default=N_TEST_EVENTS)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import gc

    import torch

    from gru4rec_tpu_torch.eval.evaluation import _eval_schedule
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line

    card = nvidia_smi_line()
    for shape in args.shapes:
        model = shape_model(shape)
        test = eval_test_set(shape, args.events)
        sched = _eval_schedule(model, test, BATCH, "SessionId", "ItemId", "Time")
        graphs = {}
        times = {w: [] for w in WAYS}
        peaks, results = {}, {}
        for way in WAYS:  # first calls: set-up, capture; not timed
            results[way] = run_way(model, test, way, graphs)[1:]
        for _ in range(args.repeats):
            for way in WAYS:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dt, rec, mrr = run_way(model, test, way, graphs)
                peaks[way] = max(peaks.get(way, 0), torch.cuda.max_memory_allocated())
                times[way].append(dt)
                if (rec, mrr) != results[way]:
                    raise SystemExit(f"{shape} {way}: metrics changed between calls")
        if not results["eager"] == results["graph"] == results["graph_kept"]:
            raise SystemExit(f"{shape}: the graph and the eager loop disagree: {results}")
        (kept,) = graphs.values()
        for way in WAYS:
            med = float(np.median(times[way]))
            print(json.dumps({
                "metric": f"eval_seconds_{shape}_shape", "way": way,
                "n_items": SHAPES[shape]["n_items"], "hidden": SHAPES[shape]["layers"][0],
                "n_test_events": len(test), "scored_events": sched.n_events,
                "steps": sched.n_steps, "batch_size": BATCH, "cutoffs": CUTOFFS,
                "warm_seconds": times[way], "min_seconds": min(times[way]),
                "median_seconds": med, "events_per_s": sched.n_events / med,
                "ms_per_512_events": med * 1e3 / (sched.n_events / BATCH),
                "ms_per_step": med * 1e3 / sched.n_steps,
                "max_memory_allocated": peaks[way],
                "graph_pool_bytes": kept.pool_bytes if way != "eager" else None,
                "recall": results[way][0], "mrr": results[way][1],
                "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
        del model, graphs, kept
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
