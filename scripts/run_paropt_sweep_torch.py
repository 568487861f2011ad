"""A paropt sweep of the port on the card: the reference's primary workflow.

The counterpart of ``scripts/run_paropt_sweep.py``. It drives ``python -m
gru4rec_tpu_torch.cli.paropt`` with N process-isolated trials over a space
whose shape does not change (learning_rate / momentum / bpreg at a fixed
GRU-224 / batch-80 / 2048-negative shape) on synthetic data (20,000 items,
400,000 training and 40,000 test events), and checks that the trials share
their build:

  * trial 1 is cold: it pays the ``nvcc`` build of ``csrc/sparse_update.cu``
    and the ``g++`` build of ``csrc/scheduler.cpp``;
  * trials 2 and later start warm: every child loads the libraries that
    trial 1 built into the package's ``_build/`` directory
    (``ops/kernels/build.py``), so their first epoch is the proof that the
    build is shared across processes.

So that trial 1 is cold without touching the checkout's ``_build/``, the
sweep runs the package from a copy of ``gru4rec_tpu_torch/`` in the work
directory with an empty ``_build/``, reached through ``PYTHONPATH`` (the
work directory is the children's working directory, so ``python -m`` finds
the copy, not the checkout).

Prints one JSON line per trial ``{trial, params, epoch<n>_s, metric,
wall_s}`` and then a summary line with the keys of the JAX script's, in its
order; ``cache_shared`` is true when trial 1's first epoch took more than
3x the warm trials' median. Unlike the JAX script's parser, a trial's lines
end at its ``PRIMARY METRIC:`` line, so the final re-run of the best
parameters (which paropt starts after the last trial) is not read as the
last trial's epochs.

Usage: python3 scripts/run_paropt_sweep_torch.py [n_trials] [workdir] [-d cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pandas as pd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS = 20_000
TRAIN_EVENTS = 400_000
TEST_EVENTS = 40_000
MEAN_SESSION_LEN = 5.5

SPACE = [
    {"name": "learning_rate", "dtype": "float", "values": [0.02, 0.2],
     "log": True},
    {"name": "momentum", "dtype": "float", "values": [0.0, 0.5], "step": 0.1},
    {"name": "bpreg", "dtype": "float", "values": [0.5, 2.0], "step": 0.25},
]

FIXED = ("loss=bpr-max,final_act=elu-0.5,layers=224,batch_size=80,"
         "n_sample=2048,sample_alpha=0.4,constrained_embedding=True,"
         "n_epochs=3,chunk_size=512,dropout_p_hidden=0.0,dropout_p_embed=0.0")

TRIAL_RE = re.compile(r"--- trial (\d+)/(\d+): (.*)")
EPOCH_RE = re.compile(r"Epoch(\d+) --> .*\(([\d.]+)s\)")
METRIC_RE = re.compile(r"PRIMARY METRIC:\s*([-\d.eE+]+)")


def synth(n_events, seed):
    rng = np.random.RandomState(seed)
    n_sessions = int(n_events / MEAN_SESSION_LEN)
    lens = 2 + rng.geometric(1.0 / (MEAN_SESSION_LEN - 2.0), size=n_sessions)
    total = int(lens.sum())
    ranks = np.arange(1, N_ITEMS + 1, dtype=np.float64)
    p = 1.0 / ranks ** 0.8
    p /= p.sum()
    items = rng.choice(N_ITEMS, size=total, p=p).astype(np.int64)
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    return pd.DataFrame({"SessionId": sess, "ItemId": items,
                         "Time": np.arange(total, dtype=np.int64)})


def write_inputs(workdir):
    """The train / test TSVs (written once per work directory) and the
    space file; returns their paths."""
    train_p = os.path.join(workdir, "train.tsv")
    test_p = os.path.join(workdir, "test.tsv")
    space_p = os.path.join(workdir, "space.jsonl")
    if not os.path.exists(train_p):
        # every item must appear in train so test inner-join keeps most events
        tr = synth(TRAIN_EVENTS, seed=0)
        pad = pd.DataFrame({
            "SessionId": np.arange(N_ITEMS) // 4 + tr["SessionId"].max() + 1,
            "ItemId": np.arange(N_ITEMS),
            "Time": np.arange(N_ITEMS) + len(tr)})
        pd.concat([tr, pad], ignore_index=True).to_csv(train_p, sep="\t", index=False)
        synth(TEST_EVENTS, seed=1).to_csv(test_p, sep="\t", index=False)
    with open(space_p, "w") as f:
        for p in SPACE:
            f.write(json.dumps(p) + "\n")
    return train_p, test_p, space_p


def cold_package(workdir):
    """A copy of the package in ``workdir/pkg`` with an empty ``_build/``;
    returns the directory to put on ``PYTHONPATH``."""
    root = os.path.join(workdir, "pkg")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "gru4rec_tpu_torch"),
                    os.path.join(root, "gru4rec_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    os.makedirs(os.path.join(root, "gru4rec_tpu_torch", "_build"))
    return root


class TrialParser:
    """Reads paropt's output line by line into one row per trial: ``trial``,
    ``params``, ``epoch<n>_s`` and, at its ``PRIMARY METRIC:`` line,
    ``metric`` and ``wall_s`` (seconds since its ``--- trial`` line, on
    ``clock``)."""

    def __init__(self, clock=time.time):
        self.clock = clock
        self.rows = []
        self.cur = None

    def feed(self, line):
        line = line.rstrip()
        m = TRIAL_RE.match(line)
        if m:
            self.cur = {"trial": int(m.group(1)), "params": m.group(3),
                        "t_start": self.clock()}
            self.rows.append(self.cur)
            return
        if self.cur is None:
            return
        m = EPOCH_RE.match(line)
        if m:
            self.cur[f"epoch{m.group(1)}_s"] = float(m.group(2))
            return
        m = METRIC_RE.match(line)
        if m:
            self.cur["metric"] = float(m.group(1))
            self.cur["wall_s"] = round(self.clock() - self.cur.pop("t_start"), 1)
            self.cur = None

    def trials(self):
        for row in self.rows:
            row.pop("t_start", None)
        return self.rows


def summary(rows, rc, total_wall_s, log_path):
    """The summary line's dict: the JAX script's keys, in its order."""
    warm = [r["epoch1_s"] for r in rows[1:] if "epoch1_s" in r]
    t1e1 = rows[0].get("epoch1_s") if rows else None
    return {
        "metric": "paropt_sweep", "n_trials": len(rows), "rc": rc,
        "total_wall_s": round(total_wall_s, 1),
        "trial1_epoch1_s": t1e1,
        "warm_epoch1_s_median": round(float(np.median(warm)), 2) if warm else None,
        "cache_shared": bool(warm and t1e1 is not None
                             and t1e1 > 3 * float(np.median(warm))),
        "log": log_path,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_trials", nargs="?", type=int, default=8)
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "g4r_paropt_sweep_torch"))
    ap.add_argument("-d", "--device", default=None,
                    help="forwarded to paropt (default: the CUDA card)")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    train_p, test_p, space_p = write_inputs(args.workdir)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (cold_package(args.workdir), os.environ.get("PYTHONPATH")) if p))

    # -u: unbuffered child stdout, or the per-trial wall times would be the
    # times of block flushes
    cmd = [sys.executable, "-u", "-m", "gru4rec_tpu_torch.cli.paropt", train_p, test_p,
           "-opf", space_p, "-fp", FIXED, "-nt", str(args.n_trials), "-m", "20",
           "-pm", "recall"]
    if args.device:
        cmd += ["-d", args.device]
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=args.workdir, env=env)
    log_path = os.path.join(args.workdir, "sweep.log")
    parser = TrialParser()
    with open(log_path, "w") as logf:
        for line in proc.stdout:
            logf.write(line)
            parser.feed(line)
    rc = proc.wait()
    rows = parser.trials()
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps(summary(rows, rc, time.time() - t0, log_path)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
