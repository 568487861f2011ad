"""Weak-scaling benchmark of the port over data-parallel widths.

The counterpart of the repository's ``bench_scaling.py``. For each
data-parallel width d (1, 2, 4, 8, 16, up to the ranks available), trains
the flagship shape with a proportionally larger global batch (80 lanes per
rank) for three epochs and reports the events/s of the epochs after the
first. The mesh runs one process per rank (``parallel/mesh.py``), so width 1
trains in this process without a mesh, and each width d > 1 is a child
launch of d ranks under ``python -m torch.distributed.run`` on a d x 1 mesh,
whose rank 0 prints the row; a mesh ``fit``'s ``epoch_stats`` count the
events of every rank, as JAX's replicated stats do.

    python -m gru4rec_tpu_torch.bench_scaling            # the cards, NCCL
    python -m gru4rec_tpu_torch.bench_scaling --device cpu --ranks 2

By default the ranks are the cards (``torch.cuda.device_count()``, one NCCL
rank each), so one card prints one row; with no card it raises. ``--device
cpu`` runs gloo ranks on the CPU, ``--ranks`` of them (default 1): the
mechanism, not the performance, as ``bench_scaling.py``'s virtual CPU
devices. ``--events`` and ``--epochs`` cut the run for such checks.

Prints one JSON line per width to stdout:
  {"devices": d, "batch": B, "value": events_per_s, "unit": "events/s"}
and, per width, ``fit``'s log and one ``{"fit": ...}`` line (the width,
per-epoch stats, the row-sparse kernel's launches by mode) to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd

N_ITEMS = 36_968
PER_DEVICE_BATCH = 80
N_EVENTS = 400_000
N_EPOCHS = 3
WIDTHS = (1, 2, 4, 8, 16)
LAUNCH_TIMEOUT = 3600  # seconds for one width's launch of d ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synth_data(n_events, seed=0):
    rng = np.random.RandomState(seed)
    n_sessions = int(n_events / 5.5)
    lens = 2 + rng.geometric(1.0 / 3.5, size=n_sessions)
    total = int(lens.sum())
    ranks = np.arange(1, N_ITEMS + 1, dtype=np.float64)
    p = 1.0 / ranks**0.8
    p /= p.sum()
    items = rng.choice(N_ITEMS, size=total, p=p).astype(np.int64)
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    return pd.DataFrame(
        {"SessionId": sess, "ItemId": items, "Time": np.arange(total, dtype=np.int64)}
    )


def width_cfg(d):
    """The configuration at width ``d``: the flagship at batch 80 per rank."""
    from gru4rec_tpu_torch import GRU4RecConfig

    return GRU4RecConfig(
        loss="bpr-max", final_act="elu-0.5", layers=[224], batch_size=PER_DEVICE_BATCH * d,
        n_sample=2048, sample_alpha=0.4, bpreg=1.95, learning_rate=0.05,
        momentum=0.4, constrained_embedding=True, n_epochs=3, chunk_size=256,
    )


def row(d, eps):
    """The result line of width ``d``: ``bench_scaling.py``'s keys."""
    return {"devices": d, "batch": PER_DEVICE_BATCH * d, "value": round(eps, 1),
            "unit": "events/s"}


def measure(data, d, n_epochs=N_EPOCHS, device=None, mesh=None):
    """``fit`` of ``data`` at width ``d`` for ``n_epochs``, on ``device``
    (``None``: the card) or on every rank of ``mesh``: ``(row, detail)``."""
    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.bench import fit_quietly, warm_events_per_s
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    model = GRU4Rec(width_cfg(d), device=device if mesh is None else mesh.device)
    sparse_update.reset_launches()
    fit_quietly(model, data, n_epochs, mesh=mesh)
    detail = {"devices": d, "epochs": model.epoch_stats,
              "launches": dict(sparse_update.launches_by_mode)}
    return row(d, warm_events_per_s(model.epoch_stats)), detail


def widths(n_ranks):
    return [d for d in WIDTHS if d <= n_ranks]


def emit(row_, detail):
    print(json.dumps({"fit": detail}), file=sys.stderr, flush=True)
    print(json.dumps(row_), flush=True)


def launch(d, device, n_events, n_epochs):
    """Width ``d`` as ``d`` ranks under ``torch.distributed.run``; they
    share this process's stdout and stderr. Returns the launch's exit code."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(d), "-m", "gru4rec_tpu_torch.bench_scaling",
           "--rank-of", str(d), "--device", device, "--events", str(n_events),
           "--epochs", str(n_epochs)]
    return subprocess.run(cmd, cwd=_ROOT, timeout=LAUNCH_TIMEOUT).returncode


def rank_main(d, device, n_events, n_epochs):
    """One rank of width ``d``'s launch: a d x 1 mesh (NCCL on the rank's
    card, or gloo on the CPU); rank 0 prints the row."""
    import torch.distributed as dist

    from gru4rec_tpu_torch.parallel import make_mesh

    mesh = make_mesh(d, 1, device=None if device == "cuda" else device)
    try:
        row_, detail = measure(synth_data(n_events), d, n_epochs, mesh=mesh)
        if mesh.rank == 0:
            emit(row_, detail)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks available (default: the cards; 1 on the CPU)")
    ap.add_argument("--events", type=int, default=N_EVENTS)
    ap.add_argument("--epochs", type=int, default=N_EPOCHS)
    ap.add_argument("--rank-of", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        rank_main(args.rank_of, args.device, args.events, args.epochs)
        return 0
    if args.device == "cuda":
        import torch

        from gru4rec_tpu_torch.models.gru4rec import resolve_device

        resolve_device("cuda")  # raises where there is no card
        cards = torch.cuda.device_count()
        n_ranks = cards if args.ranks is None else args.ranks
        if n_ranks > cards:
            raise ValueError(f"{n_ranks} NCCL ranks need {n_ranks} cards, have {cards}")
    else:
        n_ranks = 1 if args.ranks is None else args.ranks
    for d in widths(n_ranks):
        if d == 1:
            emit(*measure(synth_data(args.events), 1, args.epochs, device=args.device))
        elif launch(d, args.device, args.events, args.epochs) != 0:
            print(f"width {d}: the launch of {d} ranks failed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
