"""What the port's own tracing costs on the card, off and on.

At the RetailRocket flagship config (chip_smoke.py's ``flagship_cfg``, on
its synthetic data), on one CUDA device, prints one JSON line:

* ``span_off_us`` / ``record_function_off_us``: host us per use of
  ``utils/profiling.py::span`` and of a bare ``record_function`` with no
  profiler recording; ``span_on_us``: per use of ``span`` while
  ``torch.profiler`` records (CPU activity);
* ``untraced`` / ``traced``: the wall ms per step of ``--rounds`` chunks of
  ``--steps`` steps each, in turns, with no profiler and under
  ``torch.profiler`` (CPU and CUDA activities), each chunk synchronised;
  ``traced_over_untraced``, the ratio of their medians; ``spans_per_chunk``,
  the program's ``gru4rec.*`` spans in one traced chunk;
* ``pace``: each untraced chunk's counters (``utils/profiling.py::Pace``):
  issue ms per step, device ms per step, whether the device was behind;
* the card's name and power limit.

    python3 scripts/measure_tracing_cost_torch.py [--steps 512] [--rounds 6]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def per_use_us(make, n=200_000):
    t = time.perf_counter()
    for _ in range(n):
        with make("gru4rec.cost"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import flagship_cfg, synth_split
    from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap
    from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order
    from gru4rec_tpu_torch.data.tools import compute_offset
    from gru4rec_tpu_torch.models.gru4rec import resolve_device
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line
    from gru4rec_tpu_torch.ops.sampling import build_alias_table
    from gru4rec_tpu_torch.train import step as tstep
    from gru4rec_tpu_torch.utils.profiling import Pace, span

    out = {"device": None, "card": nvidia_smi_line()}
    out["span_off_us"] = statistics.median(per_use_us(span) for _ in range(5))
    out["record_function_off_us"] = statistics.median(
        per_use_us(record_function, 50_000) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on_us"] = per_use_us(span, 20_000)

    dev = resolve_device("cuda")
    out["device"] = torch.cuda.get_device_name(0)
    cfg = flagship_cfg()
    train, _ = synth_split(n_events=1_000_000)
    itemidmap = build_itemidmap(train, "ItemId")
    data = apply_itemidmap(train, itemidmap, "ItemId")
    offsets = compute_offset(data, "SessionId")
    order = session_order(data, "SessionId", "Time", True, len(offsets) - 1)
    sched = build_schedule(data["ItemIdx"].values.astype(np.int32), offsets, order,
                           cfg.batch_size)
    n_items = len(itemidmap)
    pop = data.groupby("ItemId").size().reindex(itemidmap.index.values).values
    samp1 = torch.from_numpy(build_alias_table(pop, cfg.sample_alpha)).to(dev)
    logp0 = torch.zeros(n_items + 128, device=dev)
    state = tstep.init_train_state(cfg, n_items, dev)
    chunk_fn = tstep.make_chunk_fn(cfg, n_items)
    S = args.steps
    n_chunks = sched.n_steps // S
    pos = [0]

    def chunk():
        t0 = (pos[0] % n_chunks) * S
        pos[0] += 1
        sl = [a[t0:t0 + S] for a in (sched.in_idx, sched.out_idx, sched.valid, sched.reset)]
        return chunk_fn(state, *sl, samp1, logp0)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / S

    timed(chunk)  # warm-up: kernel build and load, capture
    untraced, traced, pace, events = [], [], [], None
    for _ in range(args.rounds):
        state.pace = Pace(True)
        untraced.append(timed(chunk))
        p = state.pace.read()
        pace.append({"issue_ms_per_step": p["host_s"]["issue"] * 1e3 / S,
                     "device_ms_per_step": p["device_s"] * 1e3 / S, "behind": p["behind"]})
        state.pace = None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced.append(timed(chunk))
        if events is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
    out.update(steps=S, rounds=args.rounds, untraced=untraced, traced=traced,
               traced_over_untraced=statistics.median(traced) / statistics.median(untraced),
               pace=pace)
    out["spans_per_chunk"] = sum(1 for e in events if e.get("cat") == "user_annotation"
                                 and e["name"].startswith("gru4rec."))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
