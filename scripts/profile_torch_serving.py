"""Where a ``predict_topk`` call of the PyTorch port spends its time.

Builds a flagship-shaped serving model on one CUDA device (chip_smoke.py's
``flagship_cfg``: 36,968 items, GRU-224, constrained embedding; weights from
the seeded initialisation, integer item ids) and, at each batch size, after
a warm-up, serves the same requests two ways in one process: ``graph``
(the default on the card: one captured call per (batch, k) replayed) and
``eager`` (``_serve_graphs = None``, the graph's plain version). For each:

* ``call_ms``: the median host ms of ``--reps`` whole ``predict_topk`` calls
  (k = 20; each ends with the host fetch of its ids and scores);
* ``device_ms``: the device busy time per call (the union of the traced
  kernels', copies' and fills' intervals, ``torch.profiler``), its share of
  ``call_ms``, ``kernels`` per call, the launches the host issued per call
  (kernel and graph launches, asynchronous copies and fills) and the host
  operations ranked by their own CPU time;
* ``stage_ms``: the median host ms, over the traced calls, of each of the
  call's own spans (``gru4rec.serve`` and its children, README.md: the
  keep mask, the id lookup, the upload, the replay or, eagerly, the step,
  the fetch of ids and scores, which waits for the device, and the id
  map), read from the same trace as ``device_ms``;
* the SM clock (``nvidia-smi``) just before and just after the timed calls.

Requests carry the item ids as int64 (the catalog's dtype), or with
``--id-dtype object`` as an object array of Python ints, which takes
pandas' slow lookup path.

Prints one JSON line per batch size and way with the card's name and power
limit.

    python3 scripts/profile_torch_serving.py --reps 50
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def span_ms(path: str) -> dict:
    """The median ms of each ``gru4rec.serve*`` span of a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("gru4rec.serve"):
            by_name[e["name"]].append(e["dur"] / 1e3)
    return {name: float(np.median(v)) for name, v in sorted(by_name.items())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 64, 256])
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--id-dtype", choices=["int64", "object"], default="int64")
    args = ap.parse_args()

    import pandas as pd
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import N_ITEMS, flagship_cfg
    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.models import gru
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line
    from gru4rec_tpu_torch.utils.profiling import trace

    m = GRU4Rec(flagship_cfg())
    m.n_items = N_ITEMS
    ids = np.arange(N_ITEMS, dtype=np.int64)
    m.itemidmap = pd.Series(ids, index=ids, name="ItemIdx")
    m.params = gru.init_params(m.config, N_ITEMS, m.device)
    vocab = ids.astype(args.id_dtype)
    rng = np.random.RandomState(0)
    card = nvidia_smi_line()

    for batch in args.batches:
        sess = np.arange(batch)
        calls = [vocab[rng.randint(0, N_ITEMS, batch)] for _ in range(args.reps)]
        for way, graphs in (("graph", {}), ("eager", None)):
            m._serve_graphs = graphs
            for x in calls[:3]:  # warm-up (a graph is captured at the second call)
                m.predict_topk(sess, x, k=args.k, batch=batch)
            clock_before = _sm_clock()
            wall = []
            for x in calls:
                t0 = time.perf_counter()
                m.predict_topk(sess, x, k=args.k, batch=batch)
                wall.append((time.perf_counter() - t0) * 1e3)
            clock_after = _sm_clock()

            def serve():
                for x in calls:
                    m.predict_topk(sess, x, k=args.k, batch=batch)

            with profile(activities=[ProfilerActivity.CPU]) as prof:
                serve()
            host = sorted(((e.key, e.self_cpu_time_total / 1e3 / args.reps,
                            e.count / args.reps) for e in prof.key_averages()),
                          key=lambda r: -r[1])[:10]
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                rec = trace(serve, args.reps, path)
                stage = span_ms(path)
            call_ms = float(np.median(wall))
            print(json.dumps({
                "batch": batch, "way": way, "id_dtype": args.id_dtype, "k": args.k,
                "reps": args.reps, "n_items": N_ITEMS, "call_ms": call_ms,
                "stage_ms": stage, "device_ms": rec["device_busy_ms"],
                "device_share": rec["device_busy_ms"] / call_ms,
                "kernels": rec["kernels"], "host_launches": rec["host_launches"],
                "host_launches_by_call": rec["host_launches_by_call"],
                "host_ops_ms": {k: [ms, n] for k, ms, n in host},
                "sm_clock": [clock_before, clock_after], "card": card}), flush=True)


if __name__ == "__main__":
    main()
