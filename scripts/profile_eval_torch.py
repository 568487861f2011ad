"""Where an evaluation step of the PyTorch port spends its time, on one
CUDA device: the counterpart of ``scripts/profile_eval.py``.

At each shape of ``scripts/measure_eval_torch.py`` (its seeded model and
60,000-event test set, batch 512, cutoffs 1/5/10/20, the standard tie
mode), for the eager loop (``evaluate(_eager=True)``) and the captured step
(the graph kept across calls, every step a replay): a first call sets up
(and captures), a timed call gives the wall ms per step (host clock around
the call, which ends by reading the counters back), and a call under
``torch.profiler`` gives, per step, the device's busy ms (the union of its
kernels, copies and fills), its idle share of the wall time, the launches
the host issued (kernel and graph launches, asynchronous copies and fills),
the device kernels, and the top device operations by time. Prints one JSON
line per shape and way with the card's name and power limit.

    python3 scripts/profile_eval_torch.py [--shapes retailrocket rees46] [--top 12]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    from measure_eval_torch import (BATCH, CUTOFFS, N_TEST_EVENTS, SHAPES, run_way,
                                    shape_model, eval_test_set)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--events", type=int, default=N_TEST_EVENTS)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    from gru4rec_tpu_torch.eval.evaluation import _eval_schedule
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line
    from gru4rec_tpu_torch.utils.profiling import trace

    card = nvidia_smi_line()
    for shape in args.shapes:
        model = shape_model(shape)
        test = eval_test_set(shape, args.events)
        steps = _eval_schedule(model, test, BATCH, "SessionId", "ItemId", "Time").n_steps
        for way in ("eager", "graph_kept"):
            graphs = {}
            run_way(model, test, way, graphs)  # set-up, capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_way(model, test, way, graphs)
            wall = (time.perf_counter() - t0) * 1e3 / steps
            rec = trace(lambda: run_way(model, test, way, graphs), steps)
            top = list(rec.pop("by_name").items())[:args.top]
            print(json.dumps({
                "shape": shape, "way": way, "steps": steps, "batch_size": BATCH,
                "cutoffs": CUTOFFS, "wall_ms_per_step": wall,
                "device_busy_ms_per_step": rec["device_busy_ms"],
                "idle_share_of_wall": 1.0 - rec["device_busy_ms"] / wall,
                **{f"{k}_per_step": v for k, v in rec.items() if k != "device_busy_ms"},
                "graph_pool_bytes": (next(iter(graphs.values())).pool_bytes
                                     if graphs else None),
                "top_ops": [{"name": n[:100], "ms_per_step": v[0], "runs_per_step": v[1]}
                            for n, v in top],
                "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
