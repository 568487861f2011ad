"""Self-contained quickstart: train, evaluate, save, reload and serve a
GRU4Rec model on synthetic session data, no dataset download needed.

Usage: python -m gru4rec_tpu_torch.examples.quickstart_synthetic [-d cpu]

The same data, config and steps as the JAX package's
``examples/quickstart_synthetic.py``. The model runs on the card unless
``-d cpu`` asks for the CPU; the archive goes to a temporary directory.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import pandas as pd

from gru4rec_tpu_torch import GRU4Rec
from gru4rec_tpu_torch.eval import evaluate

N_TRAIN_SESSIONS = 4000
N_TEST_SESSIONS = 400
CONFIG = dict(
    loss="bpr-max", final_act="elu-0.5", layers=[96], batch_size=64,
    n_sample=256, sample_alpha=0.5, constrained_embedding=True, n_epochs=5,
)


def synthetic_sessions(n_sessions, n_items=500, seed=0):
    """Sessions following a noisy first-order transition structure."""
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 10)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items if rng.rand() < 0.8 else rng.randint(n_items)
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-d", "--device", default=None,
                    help="device (e.g. cpu, cuda:1); default is the CUDA card")
    args = ap.parse_args(argv)
    train = synthetic_sessions(N_TRAIN_SESSIONS)
    test = synthetic_sessions(N_TEST_SESSIONS, seed=7)

    gru = GRU4Rec(device=args.device, **CONFIG)
    gru.fit(train)

    recall, mrr = evaluate(gru, test, cut_off=[1, 5, 20], batch_size=64)
    for c, r, m in zip([1, 5, 20], recall, mrr):
        print(f"Recall@{c}: {r:.4f}   MRR@{c}: {m:.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "quickstart_model.npz")
        gru.savemodel(path)
        reloaded = GRU4Rec.loadmodel(path, device=args.device)
    preds = reloaded.predict_next_batch(
        np.array([0, 1]), np.array(["item_3", "item_10"]), batch=2
    )
    print("top-3 next items for two live sessions:")
    print(preds.apply(lambda col: col.nlargest(3).index.tolist(), axis=0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
