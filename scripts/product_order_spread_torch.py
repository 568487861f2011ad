"""How far a configuration's training trajectory moves when only the order
of the float32 sums in its matrix products changes.

Trains one published configuration of ``chip_smoke.py`` (its synthetic
split, one epoch, the eager loop one step at a time, the same negatives)
four ways on one CUDA device:

* ``plain``: the bfloat16 product's plain version (``ops/mixed_mm.py``:
  operands rounded to bfloat16, widened, a float32 GEMM);
* ``plain_T``: the same arithmetic computed as ``(b.T @ a.T).T``, which
  cuBLAS sums in another order;
* ``route``: the tensor-core route (``_MixedMM``);
* ``route_T``: the route as ``(b.T @ a.T).T``.

Prints one JSON line: for each way, against ``plain``, the first step
whose loss is more than 1e-6, 1e-4 and 1e-2 away (relative), the largest
relative step-loss difference, the mean step loss, the largest ``Wy``
difference after the epoch. A configuration whose ``plain_T`` moves as far
as ``route`` does is sensitive to the order of float32 sums itself.

``--learn N`` instead fits ``chip_smoke.py``'s ``learn_sr`` configuration
(adam, an embedding of 12, ``bfloat16_sr`` state, three epochs on the
markov chain) the four ways at seeds 0 .. N-1 and at its own seed, and
prints Recall@1 and the last epoch's loss of each: the spread that a
change of summation order alone gives the phase's bar.

    python3 scripts/product_order_spread_torch.py [CONFIG ...]
    python3 scripts/product_order_spread_torch.py --learn 10
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

THRESHOLDS = (1e-6, 1e-4, 1e-2)


def ways():
    """The four products, by name."""
    import torch

    from gru4rec_tpu_torch.ops import mixed_mm

    class ContiguousGrad(torch.autograd.Function):
        """The identity, whose gradient is made contiguous: the row-sparse
        kernel takes contiguous gradient rows, and a transposed product
        hands its operands transposed ones."""

        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    def transposed(product):
        return lambda a, b: product(ContiguousGrad.apply(b).T,
                                    ContiguousGrad.apply(a).T).T

    return {"plain": mixed_mm.mixed_mm_plain,
            "plain_T": transposed(mixed_mm.mixed_mm_plain),
            "route": mixed_mm.mixed_mm,
            "route_T": transposed(mixed_mm._MixedMM.apply)}


def learn(n_seeds):
    """``learn_sr`` fitted each way at seeds 0 .. n_seeds - 1 and its own."""
    import contextlib
    import io

    import chip_smoke as smoke
    from gru4rec_tpu_torch import GRU4Rec, evaluate
    from gru4rec_tpu_torch.models import gru
    from gru4rec_tpu_torch.ops import mixed_mm
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line

    train, test = smoke.markov(800), smoke.markov(100, seed=5)
    seeds = list(range(n_seeds)) + [smoke.learn_sr_cfg().seed]
    out = {"config": "learn_sr", "seeds": seeds, "card": nvidia_smi_line()}
    try:
        for way, product in ways().items():
            gru.mixed_mm = product
            recall, loss = [], []
            for seed in seeds:
                cfg = smoke.learn_sr_cfg()
                cfg.seed = seed
                model = GRU4Rec(cfg, device="cuda")
                with contextlib.redirect_stdout(io.StringIO()):
                    model.fit(train)
                    rec, _ = evaluate(model, test, cut_off=[1], batch_size=512)
                recall.append(rec[0])
                loss.append(model.epoch_stats[-1]["loss"])
            out[way] = {"recall1": recall, "loss": loss,
                        "recall1_mean": float(np.mean(recall)),
                        "below_0.9": sum(r < 0.9 for r in recall)}
    finally:
        gru.mixed_mm = mixed_mm.mixed_mm
    return out


def spread(name):
    import chip_smoke as smoke
    from gru4rec_tpu_torch.models import gru
    from gru4rec_tpu_torch.models.gru4rec import resolve_device
    from gru4rec_tpu_torch.ops import mixed_mm
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line
    from gru4rec_tpu_torch.train.step import init_train_state, make_chunk_fn

    dev = resolve_device("cuda")
    cfg, ds = smoke.published_configs()[name]
    cfg.n_epochs = 1
    n_items = smoke.PUBLISHED_ITEMS[ds]
    rsc15 = ds == "rsc15"
    n_events = max(smoke.PUBLISHED_RSC15_EVENTS if rsc15 else smoke.PUBLISHED_EVENTS,
                   2 * n_items)
    mean_len = smoke.RSC15_MEAN_SESSION_LEN if rsc15 else smoke.MEAN_SESSION_LEN
    train, _ = smoke.synth_split(seed=3, n_items=n_items, mean_len=mean_len,
                                 n_events=n_events)
    model, built = smoke._fit_built(cfg, train)
    sched = built["schedules"][0]
    samp1, logp0 = built["samp1"].to(dev), built["logp0"].to(dev)
    runs = {}
    try:
        for way, product in ways().items():
            gru.mixed_mm = product
            state = init_train_state(cfg, model.n_items, dev)
            fn = make_chunk_fn(cfg, model.n_items, _eager=True)
            losses, t0 = [], time.time()
            for t in range(sched.n_steps):
                sl = [x[t:t + 1] for x in (sched.in_idx, sched.out_idx, sched.valid,
                                           sched.reset)]
                if sl[2].any():
                    loss, events = fn(state, *sl, samp1, logp0)
                    losses.append(float(loss) / events)
            runs[way] = (np.array(losses), state.params["Wy"].cpu().numpy(),
                         time.time() - t0)
    finally:
        gru.mixed_mm = mixed_mm.mixed_mm
    base, base_wy, _ = runs["plain"]
    out = {"config": name, "steps": len(base), "card": nvidia_smi_line()}
    for way, (losses, wy, seconds) in runs.items():
        rel = np.abs(losses - base) / np.abs(base)
        out[way] = {"first_step_past": {f"{th:g}": (int(np.argmax(rel > th))
                                                    if (rel > th).any() else None)
                                        for th in THRESHOLDS},
                    "max_rel": float(rel.max()), "mean_step_loss": float(losses.mean()),
                    "wy_max_abs": float(np.abs(wy - base_wy).max()), "seconds": seconds}
    return out


def main():
    if sys.argv[1:2] == ["--learn"]:
        print(json.dumps(learn(int(sys.argv[2]))), flush=True)
        return
    names = sys.argv[1:] or ["rsc15:bpr-max-constrained", "retailrocket"]
    for name in names:
        print(json.dumps(spread(name)), flush=True)


if __name__ == "__main__":
    main()
