"""Where a ``predict_topk`` call of the PyTorch port spends its time.

Builds a flagship-shaped serving model on one CUDA device (chip_smoke.py's
``flagship_cfg``: 36,968 items, GRU-224, constrained embedding; weights from
the seeded initialisation, integer item ids) and, at each batch size, after
a warm-up call:

* ``call_ms``: the median host ms of ``--reps`` whole ``predict_topk`` calls
  (k = 20; each ends with the host fetch of its ids and scores);
* ``stage_ms``: the median host ms of each stage of the same call, run
  separately with a synchronisation after the device work: the lane
  bookkeeping, the item-id lookup and upload, the dispatch of the serving
  step and ``torch.topk``, the wait for the device, the fetch of ids and
  scores, and the id take;
* ``device_ms``: the device busy time per call (the union of the traced
  kernels' intervals, ``torch.profiler``), ``kernels`` per call, and the
  host operations ranked by their own CPU time;
* the SM clock (``nvidia-smi``) just before and just after the timed calls.

Requests carry the item ids as int64 (the catalog's dtype), or with
``--id-dtype object`` as an object array of Python ints, which takes
pandas' slow lookup path.

Prints one JSON line per batch size with the card's name and power limit.

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

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("lanes", "lookup", "dispatch", "device_wait", "fetch", "ids")


def _sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _busy_ms(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and "dur" in e)
    total, end = 0.0, -1.0
    for ts, dur in spans:
        if ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    return total / 1e3, kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 64, 256])
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--id-dtype", choices=["int64", "object"], default="int64")
    args = ap.parse_args()

    import pandas as pd
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import N_ITEMS, flagship_cfg
    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.models import gru
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line

    m = GRU4Rec(flagship_cfg())
    m.n_items = N_ITEMS
    ids = np.arange(N_ITEMS, dtype=np.int64)
    m.itemidmap = pd.Series(ids, index=ids, name="ItemIdx")
    m.params = gru.init_params(m.config, N_ITEMS, m.device)
    vocab = ids.astype(args.id_dtype)
    rng = np.random.RandomState(0)
    card = nvidia_smi_line()

    def stages(sess, items):
        t = [time.perf_counter()]
        m._ensure_lanes(len(sess))
        m._reset_changed_lanes(sess)
        t.append(time.perf_counter())
        idx = m._item_indices(items)
        t.append(time.perf_counter())
        H, yhat = m._build_predict_fn(False)(m.params, m.H, idx)
        sc, ix = torch.topk(yhat, args.k, dim=1, sorted=True)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ix, sc = ix.cpu().numpy(), sc.cpu().numpy()
        t.append(time.perf_counter())
        np.asarray(m.itemidmap.index[ix.ravel()], dtype=object).reshape(ix.shape)
        t.append(time.perf_counter())
        m.H = H
        return np.diff(t) * 1e3

    for batch in args.batches:
        sess = np.arange(batch)
        calls = [vocab[rng.randint(0, N_ITEMS, batch)] for _ in range(args.reps)]
        m.predict_topk(sess, calls[0], k=args.k, batch=batch)  # warm-up
        clock_before = _sm_clock()
        wall = []
        for x in calls:
            t0 = time.perf_counter()
            m.predict_topk(sess, x, k=args.k, batch=batch)
            wall.append((time.perf_counter() - t0) * 1e3)
        clock_after = _sm_clock()
        stage = np.median([stages(sess, x) for x in calls], axis=0)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for x in calls:
                    m.predict_topk(sess, x, k=args.k, batch=batch)
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            busy, kernels = _busy_ms(path)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / args.reps, e.count / args.reps)
                       for e in prof.key_averages()), key=lambda r: -r[1])[:10]
        print(json.dumps({
            "batch": batch, "id_dtype": args.id_dtype, "k": args.k, "reps": args.reps,
            "n_items": N_ITEMS,
            "call_ms": float(np.median(wall)),
            "stage_ms": dict(zip(STAGES, map(float, stage))),
            "device_ms": busy / args.reps, "kernels": kernels / args.reps,
            "host_ops_ms": {k: [ms, n] for k, ms, n in host},
            "sm_clock": [clock_before, clock_after], "card": card}), flush=True)


if __name__ == "__main__":
    main()
