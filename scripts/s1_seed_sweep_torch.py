"""Seed sweeps of suspects S1 and S2: does a configuration learn worse in
the port than in the JAX package, or is one seed's gap the spread of the
seed?

S1 (the default): the one-hot ``rsc15:bpr-max`` configuration on the
markov chain. S2 (``--fuzz-draw D``): draw D of the JAX package's
config-surface fuzz (``tests/test_config_fuzz.py``: ``draw_config`` with
seed ``1000 + D``, its 120 training and 25 test sessions, 2 epochs,
Recall@5 at batch 8, the draw's own dtypes and dropout) with the draw's
``seed`` replaced by each seed of the sweep.

Trains that configuration as published (GRU-100, one-hot input, bpr-max
with elu-0.5, 2,048 uniform negatives, batch 32, adagrad with momentum 0.3;
``gru4rec_tpu_torch/examples/rsc15/run_rsc15.py``'s ``CONFIGS``) for 3
epochs on ``chip_smoke.py``'s 60-item markov chain (800 training sessions,
100 test sessions drawn with seed 5) at each seed, in the JAX package and
in the port, both on the CPU with the configuration's own dtypes (the
settings of ``tests/test_torch_published.py``'s check at seed 42). Prints one
JSON line per seed with Recall@5 and the training loss of each epoch of
each package (JAX ranking activated scores, as the port does: hazard F1),
then a summary line: each package's
mean, standard deviation, minimum and maximum, and two tests of the
hypothesis that both draw from one distribution, Welch's t-test and the
Mann-Whitney U test (scipy).

It is the one script of the port that imports the JAX package, because it
compares the two. Run it on the CPU:

    JAX_PLATFORMS=cpu python scripts/s1_seed_sweep_torch.py [--seeds 0 1 ...] [--threads 4]
    JAX_PLATFORMS=cpu python scripts/s1_seed_sweep_torch.py --fuzz-draw 0 --threads 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

EPOCHS = 3
CUT_OFF = 5


def config_params(seed):
    from gru4rec_tpu_torch.examples.rsc15.run_rsc15 import CONFIGS

    name, params, _ = CONFIGS[0]
    assert name == "bpr-max" and not params["constrained_embedding"]
    return dict(params, n_epochs=EPOCHS, seed=seed)


def fuzz_draw(draw):
    """The fuzz draw's config (as a function of the seed), training and
    test sessions, cutoff and batch size (``tests/test_config_fuzz.py``)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_config_fuzz import draw_config, sessions

    kw = draw_config(np.random.RandomState(1000 + draw))
    return (lambda seed: dict(kw, seed=seed), sessions(120, seed=draw),
            sessions(25, seed=100 + draw), 8)


def jax_recall(params, train, test, batch_size=512):
    import gru4rec_tpu
    from gru4rec_tpu.eval import evaluation as jeval

    m = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**params))
    m.fit(train)
    rank_invariant = jeval.rank_invariant
    jeval.rank_invariant = lambda name: False  # activated scores (F1)
    jeval._CHUNK_FN_CACHE.clear()
    try:
        return (jeval.evaluate(m, test, cut_off=[CUT_OFF], batch_size=batch_size)[0][0],
                [e["loss"] for e in m.epoch_stats])
    finally:
        jeval.rank_invariant = rank_invariant
        jeval._CHUNK_FN_CACHE.clear()


def port_recall(params, train, test, batch_size=512):
    import gru4rec_tpu_torch

    m = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**params), device="cpu")
    m.fit(train)
    return (gru4rec_tpu_torch.evaluate(m, test, cut_off=[CUT_OFF], batch_size=batch_size)[0][0],
            [e["loss"] for e in m.epoch_stats])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(10)))
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--fuzz-draw", type=int, default=None,
                    help="sweep this draw of tests/test_config_fuzz.py (S2) "
                         "instead of the one-hot rsc15:bpr-max configuration (S1)")
    args = ap.parse_args()

    import torch
    from scipy import stats

    torch.set_num_threads(args.threads)
    if args.fuzz_draw is None:
        from chip_smoke import markov

        params_of, train, test, batch = config_params, markov(800), markov(100, seed=5), 512
    else:
        params_of, train, test, batch = fuzz_draw(args.fuzz_draw)
    recall = {"jax": [], "port": []}
    for seed in args.seeds:
        params = params_of(seed)
        t0 = time.time()
        rec_j, loss_j = jax_recall(params, train, test, batch)
        rec_p, loss_p = port_recall(params, train, test, batch)
        recall["jax"].append(rec_j)
        recall["port"].append(rec_p)
        print(json.dumps({"seed": seed, f"jax_recall@{CUT_OFF}": rec_j,
                          f"port_recall@{CUT_OFF}": rec_p, "jax_epoch_losses": loss_j,
                          "port_epoch_losses": loss_p, "seconds": time.time() - t0}),
              flush=True)
    summary = {pkg: {"mean": float(np.mean(v)), "std": float(np.std(v, ddof=1)),
                     "min": float(np.min(v)), "max": float(np.max(v))}
               for pkg, v in recall.items()}
    welch = stats.ttest_ind(recall["port"], recall["jax"], equal_var=False)
    mwu = stats.mannwhitneyu(recall["port"], recall["jax"], alternative="two-sided")
    print(json.dumps({"fuzz_draw": args.fuzz_draw, "seeds": args.seeds,
                      "epochs": params["n_epochs"], "threads": args.threads,
                      "device": "cpu", f"recall@{CUT_OFF}": summary,
                      "welch_t": float(welch.statistic), "welch_p": float(welch.pvalue),
                      "mannwhitney_u": float(mwu.statistic),
                      "mannwhitney_p": float(mwu.pvalue)}), flush=True)


if __name__ == "__main__":
    main()
