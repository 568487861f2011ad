"""Where a flagship training step of the PyTorch port spends its time.

Runs ``gru4rec_tpu_torch``'s chunk function at the RetailRocket flagship
config (chip_smoke.py's ``flagship_cfg``, on its synthetic data) on one
CUDA device: a warm-up chunk (on a card the chunk function captures its
step there), a timed chunk (host clock around a synchronised chunk of
``--steps`` steps), then the same number of steps under ``torch.profiler``.
Prints one JSON line: the card's ``nvidia-smi`` name and power limit, wall
ms per step, device busy ms per step (the union of the traced kernels' and
device copies' intervals), the device's idle share, the launches the host
issued per step (CUDA API calls that put work on a stream: kernel and
graph launches, asynchronous copies and fills), the device
operations per step (kernels, run by a graph replay or launched alone;
copies and fills apart), the row-sparse kernel's runs per step in the
trace and in its launch counters (they must agree: a replay is counted
from the captured step's tally), every kernel ranked by device time, and
the bytes the captured step's graph pool reserved; writes the chrome trace to
``--trace`` when given. ``--root`` profiles another checkout's package
(for a parent-and-change comparison in one call).

    python3 scripts/profile_torch_step.py --steps 64 [--root DIR] [--label NAME]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

# the row-sparse kernel's name (csrc/sparse_update.cu)
SPARSE_KERNEL = "sparse_update_kernel"


def _trace_helper():
    """``utils/profiling.py::trace`` of this script's checkout, loaded by
    path: ``--root`` may name a checkout that lacks it."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "gru4rec_tpu_torch", "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("_profiling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.trace


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--trace", default=None, help="write the chrome trace here")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), help="the checkout whose package runs (default: this one)")
    ap.add_argument("--label", default=None, help="a name for the record")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from chip_smoke import flagship_cfg, synth_split
    from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap
    from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order
    from gru4rec_tpu_torch.data.tools import compute_offset
    from gru4rec_tpu_torch.models.gru4rec import resolve_device
    from gru4rec_tpu_torch.ops.kernels import sparse_update
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line
    from gru4rec_tpu_torch.ops.sampling import build_alias_table
    from gru4rec_tpu_torch.train import step as tstep

    dev = resolve_device("cuda")
    cfg = flagship_cfg()
    train, _ = synth_split()
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

    def run(t0):
        sl = [a[t0:t0 + S] for a in (sched.in_idx, sched.out_idx, sched.valid,
                                     sched.reset)]
        return chunk_fn(state, *sl, samp1, logp0)

    run(0)  # warm-up: allocator, cuBLAS handles, kernel library load, capture
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(S)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / S

    sparse_update.reset_launches()
    rec = _trace_helper()(lambda: run(2 * S), S, args.trace)
    launched = sum(sparse_update.launches_by_mode.values())
    busy = rec["device_busy_ms"]
    runner = getattr(chunk_fn, "runner", None)
    # the row-sparse kernel's runs in the trace against the wrapper's count
    # (which a graph replay adds its captured tally to)
    traced = round(sum(v[1] for n, v in rec["by_name"].items() if SPARSE_KERNEL in n) * S)
    if traced != launched:
        raise SystemExit(f"the trace holds {traced} runs of {SPARSE_KERNEL}, the "
                         f"launch counters {launched}")
    print(json.dumps({
        "label": args.label or os.path.basename(os.path.abspath(args.root)),
        "device": torch.cuda.get_device_name(0),
        "card": nvidia_smi_line(),
        "steps": S,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy,
        "idle_share_of_wall": 1.0 - busy / wall_ms,
        "kernel_window_ms_per_step": rec["kernel_window_ms"],
        "host_launches_per_step": rec["host_launches"],
        "host_launches_by_call": rec["host_launches_by_call"],
        "kernel_launches_per_step": rec["kernels"],
        "device_copies_per_step": rec["device_copies"],
        "sparse_update_runs_per_step": traced / S,
        "sparse_update_counted_per_step": launched / S,
        "graph_pool_bytes": getattr(runner, "pool_bytes", None),
        "kernels": [{"name": n[:100], "ms_per_step": v[0], "calls_per_step": v[1]}
                    for n, v in rec["by_name"].items()],
    }))


if __name__ == "__main__":
    main()
