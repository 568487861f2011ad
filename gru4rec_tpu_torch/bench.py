"""Headline benchmark of the port: training throughput on the RetailRocket best-config.

The counterpart of the repository's ``bench.py`` on PyTorch and CUDA. The
reference's flagship number (BASELINE.md): GRU-224, batch 80, bpr-max, 2048
extra negatives, constrained embedding, ~81,400 events/s (~6.8 s/epoch) on
an NVIDIA A30 (reference README.md:153-163).

It trains on ``bench.py``'s synthetic data, matched to RetailRocket's
published shape (~37k items, ~750k training events, zipf-ish popularity,
short sessions), made by the same RNG calls, so the frame is ``bench.py``'s
bit for bit. Run from the root of a checkout, on the card:

    python -m gru4rec_tpu_torch.bench

It runs on the card only: with no card it raises (``resolve_device``).
``fit`` runs four epochs in this process; the first builds the kernels (if
``gru4rec_tpu_torch/_build/`` lacks them), captures the training step and
warms up, and the metric is the events of epochs 2-4 over their seconds.
Then epoch 1 runs in fresh processes (``--epoch1 <build dir>``): twice with
the populated build directory (warm; the min is reported, both draws ship
beside it) and once with an empty temporary one (cold: the child pays the
``nvcc`` build of ``csrc/sparse_update.cu`` and the ``g++`` build of
``csrc/scheduler.cpp``), the counterparts of ``bench.py``'s populated and
empty persistent compile caches. ``GRU4REC_TPU_BENCH_SKIP_COLD`` skips both
splits, as in ``bench.py``. A failed child reports ``None``.

``fit``'s log, the card's ``nvidia-smi`` name and power limit and one
``{"fit": ...}`` line (per-epoch stats and the row-sparse kernel's launches
by mode) go to stderr. The last line of stdout is one JSON object with
``bench.py``'s keys in its order (:func:`headline`); ``vs_baseline`` divides
by the reference's A30 number, across hardware generations and vendors.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pandas as pd

BASELINE_EVENTS_PER_S = 81_400.0  # reference README.md:153-163 (NVIDIA A30)
BASELINE_HW = "NVIDIA A30 (reference README.md:153-163)"
METRIC = "train_events_per_s_retailrocket_shape"

# RetailRocket-shaped synthetic data (README.md:349-356 row: retailrocket)
N_ITEMS = 36_968
N_EVENTS_TARGET = 750_000
MEAN_SESSION_LEN = 5.5
N_EPOCHS = 4  # epoch 1 = build, capture and warm-up; epochs 2-4 are the measurement
CHILD_TIMEOUT = 1800  # seconds for one epoch-1 child

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synth_data(seed=0):
    rng = np.random.RandomState(seed)
    n_sessions = int(N_EVENTS_TARGET / MEAN_SESSION_LEN)
    lens = 2 + rng.geometric(1.0 / (MEAN_SESSION_LEN - 2.0), size=n_sessions)
    total = int(lens.sum())
    # zipf-ish popularity over items
    ranks = np.arange(1, N_ITEMS + 1, dtype=np.float64)
    p = 1.0 / ranks**0.8
    p /= p.sum()
    items = rng.choice(N_ITEMS, size=total, p=p).astype(np.int64)
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    return pd.DataFrame(
        {"SessionId": sess, "ItemId": items, "Time": np.arange(total, dtype=np.int64)}
    )


def _flagship_cfg():
    from gru4rec_tpu_torch import GRU4RecConfig

    return GRU4RecConfig(
        loss="bpr-max", final_act="elu-0.5", hidden_act="tanh", layers=[224],
        batch_size=80, n_sample=2048, sample_alpha=0.4, bpreg=1.95,
        learning_rate=0.05, momentum=0.4, dropout_p_embed=0.0,
        dropout_p_hidden=0.0, constrained_embedding=True,
        n_epochs=1, chunk_size=512,
    )


def fit_quietly(model, data, n_epochs, **kw):
    """``model.fit(data, n_epochs=n_epochs, **kw)`` with its stdout sent to
    stderr, so that stdout holds the result alone."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model.fit(data, n_epochs=n_epochs, **kw)
    print(buf.getvalue(), file=sys.stderr)


def warm_events_per_s(epoch_stats):
    """Events over seconds of every epoch after the first."""
    warm = epoch_stats[1:]
    return sum(e["events"] for e in warm) / sum(e["seconds"] for e in warm)


def measure(data, n_epochs=N_EPOCHS, device=None):
    """The flagship ``fit`` of ``data`` for ``n_epochs`` on ``device``
    (``None``: the card): ``(events/s of the epochs after the first,
    {"epochs": epoch_stats, "launches": the kernel's launches by mode})``."""
    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    model = GRU4Rec(_flagship_cfg(), device=device)
    sparse_update.reset_launches()
    fit_quietly(model, data, n_epochs)
    detail = {"epochs": model.epoch_stats, "launches": dict(sparse_update.launches_by_mode)}
    return warm_events_per_s(model.epoch_stats), detail


def epoch1(build_dir, data, device=None):
    """Epoch 1 of the flagship ``fit`` of ``data``, its seconds, with the
    native libraries found in or built into ``build_dir``. In a fresh
    process (``--epoch1``) nothing is loaded yet, so every library the epoch
    needs comes from there."""
    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.ops.kernels import build

    build.BUILD_DIR = build_dir
    model = GRU4Rec(_flagship_cfg(), device=device)
    fit_quietly(model, data, 1)
    return model.epoch_stats[0]["seconds"]


def measure_epoch1(build_dir):
    """Run ``python -m gru4rec_tpu_torch.bench --epoch1 <build_dir>`` in a
    subprocess; returns epoch-1 seconds or None on failure (the headline
    metric must never die on this)."""
    try:
        out = subprocess.run(
            [sys.executable, "-m", "gru4rec_tpu_torch.bench", "--epoch1", build_dir],
            cwd=_ROOT, capture_output=True, text=True, timeout=CHILD_TIMEOUT, check=True,
        ).stdout
        return json.loads(out.strip().splitlines()[-1])["epoch1_s"]
    except Exception as exc:  # noqa: BLE001 — report, don't fail the bench
        err = getattr(exc, "stderr", None) or ""
        print(f"epoch1 subprocess failed: {exc}\n{err[-3000:]}", file=sys.stderr)
        return None


def headline(eps, epoch1_warm, epoch1_warm_runs, epoch1_cold, bench_hw):
    """The result line: ``bench.py``'s keys, in its order."""
    return {
        "metric": METRIC,
        "value": round(eps, 1),
        "unit": "events/s",
        "vs_baseline": round(eps / BASELINE_EVENTS_PER_S, 3),
        # the ratio compares across hardware generations AND vendors: the
        # denominator is the reference's published A30 number, the
        # numerator runs on this host's card
        "baseline_hw": BASELINE_HW,
        "bench_hw": bench_hw,
        "epoch1_warm_s": epoch1_warm,
        "epoch1_warm_runs_s": epoch1_warm_runs,
        "epoch1_cold_s": epoch1_cold,
    }


def main():
    import torch

    from gru4rec_tpu_torch.ops.kernels import build
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line

    warm_dir = build.BUILD_DIR
    print(f"build directory: {warm_dir}", file=sys.stderr)
    eps, detail = measure(synth_data())
    print(f"nvidia-smi: {nvidia_smi_line()}", file=sys.stderr)
    print(json.dumps({"fit": detail}), file=sys.stderr)

    # Cold/warm epoch-1 split in fresh subprocesses: warm finds the
    # libraries the fit above built; cold builds them into an empty
    # directory.
    epoch1_warm = epoch1_cold = None
    epoch1_warm_runs = []
    if not os.environ.get("GRU4REC_TPU_BENCH_SKIP_COLD"):
        # two warm draws, min reported; the raw draws ship beside it
        epoch1_warm_runs = [r for r in (measure_epoch1(warm_dir),
                                        measure_epoch1(warm_dir)) if r is not None]
        epoch1_warm = min(epoch1_warm_runs, default=None)
        with tempfile.TemporaryDirectory(prefix="g4r_coldbuild_") as td:
            epoch1_cold = measure_epoch1(td)

    print(json.dumps(headline(eps, epoch1_warm, epoch1_warm_runs, epoch1_cold,
                              torch.cuda.get_device_name(0))))


def epoch1_child(build_dir):
    print(json.dumps({"epoch1_s": round(epoch1(build_dir, synth_data()), 2)}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--epoch1"]:
        epoch1_child(sys.argv[2])
    else:
        main()
