"""Training events/s of the PyTorch port, the first epoch and the later ones apart.

Fits each training configuration of ``chip_smoke.py`` on the same
synthetic data as there, for ``--epochs`` epochs on one CUDA device: the
flagship (``train``, ``train_sr``, ``train_adam_sr``), the one-hot RSC15
configuration (``train_onehot``) and the nine published configurations of
its ``published`` phase at their catalog sizes. Prints one JSON line per
configuration: the events/s of each epoch (host clock, ``epoch_stats``),
the median of the epochs after the first, and the card's ``nvidia-smi``
name and power limit. The first epoch holds ``fit``'s one-off costs (on a
card the chunk function's eager warm-up steps and its capture); the later
epochs are warm. ``--root`` runs another checkout's package and its
``chip_smoke.py`` data, so a parent and a change compare in one call (run
parent, change, change, parent).

    python3 scripts/measure_train_torch.py [--epochs 3] [--root DIR] [--label NAME] [--only NAME ...]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys


def configurations(smoke):
    """{name: (config, train split)} in the order ``chip_smoke.py`` trains them."""
    flagship = smoke.synth_split()[0]
    out = {
        "train": (smoke.flagship_cfg(), flagship),
        "train_sr": (smoke.flagship_cfg(opt_state_dtype="bfloat16_sr"), flagship),
        "train_adam_sr": (smoke.flagship_cfg(adapt="adam", learning_rate=0.001,
                                             opt_state_dtype="bfloat16_sr"), flagship),
        "train_onehot": (smoke.rsc15_cfg(), smoke.synth_split(
            seed=1, n_items=smoke.RSC15_ITEMS, mean_len=smoke.RSC15_MEAN_SESSION_LEN)[0]),
    }
    for name, (cfg, ds) in smoke.published_configs().items():
        rsc15 = ds == "rsc15"
        n_items = smoke.PUBLISHED_ITEMS[ds]
        n_events = max(smoke.PUBLISHED_RSC15_EVENTS if rsc15 else smoke.PUBLISHED_EVENTS,
                       2 * n_items)
        mean_len = smoke.RSC15_MEAN_SESSION_LEN if rsc15 else smoke.MEAN_SESSION_LEN
        out[name] = (cfg, smoke.synth_split(seed=3, n_items=n_items, mean_len=mean_len,
                                            n_events=n_events)[0])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), help="the checkout whose package runs (default: this one)")
    ap.add_argument("--label", default=None, help="a name for the records")
    ap.add_argument("--only", nargs="*", default=None, help="these configurations only")
    args = ap.parse_args()
    if args.epochs < 2:
        ap.error("--epochs must be at least 2: the first epoch is not a warm one")
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke as smoke
    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = nvidia_smi_line()
    label = args.label or os.path.basename(os.path.abspath(args.root))
    for name, (cfg, train) in configurations(smoke).items():
        if args.only and name not in args.only:
            continue
        cfg.n_epochs = args.epochs
        model = GRU4Rec(cfg, device="cuda")
        model.fit(train)
        torch.cuda.synchronize()
        per_epoch = [e["events"] / e["seconds"] for e in model.epoch_stats]
        print(json.dumps({"label": label, "config": name, "events": model.epoch_stats[0]["events"],
                          "steps": model.epoch_stats[0]["steps"],
                          "events_per_s": per_epoch,
                          "warm_median_events_per_s": statistics.median(per_epoch[1:]),
                          "loss": [e["loss"] for e in model.epoch_stats], "card": card}),
              flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
