"""The control and the planted faults of a cell's comparison, read at the
cell's own size, with the reference put in the program's place:

    python3 -m benchmark.control --workload <cell> --seeds <n> <n> <n> [--serve-calls N]
        [--sampler-only]

For each seed, one JSON line per variant with the numbers the cell
compares (``yardstick/compare.py``) against the reference in the stated
precision. The benchmark's own runs never run this; it sets the upper
reading of every limit (``limits/<cell>.json``, ``PERF.md``).

* ``control``: the reference with float8 (e4m3, per-tensor scale) product
  operands and gradients, the precision below the stated bfloat16;
* ``half`` (training, evaluation, serving): half of the batch left out
  (training: the cost over the first half of the live lanes, divided by
  half the batch; evaluation: every other event's rank, the means over
  the rest; serving: every other lane's answer left at zero);
* ``token``: an answer altered where it is produced (training: every
  target one item on; evaluation: every rank one worse; serving: every
  served item one on);
* ``state`` (serving): the lane state not carried between calls (each
  call scored from the current click alone).

Training cells also read ``sampler_gap`` on a chunk's draw (``C`` steps of
``n_sample``, ``C`` the program's chunk size) from the program's own
sampler (``ops/sampling.py``, its table built from the clicks' counts):
``sampler`` as the configuration states it, the lower reading; and with
the fault planted in it, an answer altered where it is produced:
``sampler_uniform`` (``sample_alpha`` 0: every item alike),
``sampler_alpha_low`` and ``sampler_alpha_high`` (``sample_alpha`` 0.1
off). The reference has no sampler of the program's kind; its
``sampler_control`` is ``pop ** alpha`` with the probabilities rounded to
bfloat16, drawn by numpy.

A training step that leaves the state unchanged reads 1 by
``change_gap``'s measure and is not run. No exchange between chips exists
in a one-chip cell.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def train_variants(cell, run):
    from benchmark.jobs import fit
    from benchmark.reference import gru4rec as ref
    from benchmark.yardstick import compare, generators

    c, t, dev = cell.config, cell.traffic, run.device
    data = fit.clicks(cell, run)
    items, offsets = generators.sessions_csr(data)
    pop = np.bincount(items, minlength=int(c["n_items"]))
    negs = fit.draw_negatives(np.random.default_rng(run.stream("negatives")), pop,
                              float(c["params"]["sample_alpha"]), int(t["checked_steps"]),
                              int(c["params"]["n_sample"]))
    n_items = int(c["n_items"])

    class Half(ref.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.norm = self.B / 2

        def step(self, inputs, targets, live, fresh, neg, gen):
            lanes = np.flatnonzero(live)
            kept = live.copy()
            kept[lanes[len(lanes) // 2:]] = False
            return super().step(inputs, targets, kept, fresh, neg, gen)

    class Token(ref.Trainer):
        def step(self, inputs, targets, live, fresh, neg, gen):
            return super().step(inputs, (targets + 1) % n_items, live, fresh, neg, gen)

    args = (c, run.stream("weights"), run.stream("program"), items, offsets, pop, negs)
    stated = ref.ROUNDINGS[c["program"]["compute_dtype"]]
    reference = fit.reference_numbers(*args, stated, dev)
    yield "control", compare.train_numbers(
        fit.reference_numbers(*args, ref.round_fp8, dev), reference)
    yield "half", compare.train_numbers(
        fit.reference_numbers(*args, stated, dev, trainer_cls=Half), reference)
    yield "token", compare.train_numbers(
        fit.reference_numbers(*args, stated, dev, trainer_cls=Token), reference)


def sampler_variants(cell, run):
    """``sampler_gap`` of a chunk's draw from the program's sampler, as
    stated and with a fault planted in it, and of the control."""
    import torch

    from benchmark.jobs import common, fit
    from benchmark.reference import gru4rec as ref
    from benchmark.yardstick import compare, generators
    from gru4rec_tpu_torch.ops import sampling

    c, dev = cell.config, run.device
    P = c["params"]
    items, _ = generators.sessions_csr(fit.clicks(cell, run))
    pop = np.bincount(items, minlength=int(c["n_items"]))
    alpha, n_sample = float(P["sample_alpha"]), int(P["n_sample"])
    steps = common.program_config(cell, run.stream("program")).chunk_size

    def program(a):
        gen = torch.Generator(device=dev)
        gen.manual_seed(run.stream("program"))
        table = torch.from_numpy(sampling.build_alias_table(pop, a)).to(dev)
        neg = sampling.draw_negatives(gen, table, steps, n_sample, len(pop), a, "alias")
        return compare.sampler_gap(neg.cpu().numpy(), pop, alpha)

    yield "sampler", {"sampler_gap": program(alpha)}
    yield "sampler_uniform", {"sampler_gap": program(0.0)}
    yield "sampler_alpha_low", {"sampler_gap": program(alpha - 0.1)}
    yield "sampler_alpha_high", {"sampler_gap": program(alpha + 0.1)}
    p = ref.round_bf16(torch.from_numpy(pop.astype(np.float64) ** alpha).float()).double()
    draw = np.random.default_rng(run.stream("negatives")).choice(
        len(pop), size=steps * n_sample, p=(p / p.sum()).numpy())
    yield "sampler_control", {"sampler_gap": compare.sampler_gap(draw, pop, alpha)}


def eval_variants(cell, run):
    from benchmark.reference import gru4rec as ref
    from benchmark.yardstick import compare, generators, weights

    c, t, dev = cell.config, cell.traffic, run.device
    data = generators.eval_sessions(int(t["clicks"]), int(c["n_items"]), run.stream("clicks"),
                                    c["clicks"]["mean_session_len"], c["clicks"]["zipf"])
    items, offsets = generators.sessions_csr(data)
    ref.strict_float32()
    P = weights.flat(weights.make_params(c, run.stream("weights"), dev))

    def ranks(rnd):
        return ref.event_ranks(P, items, offsets, int(c["n_items"]), c["params"]["final_act"],
                               rnd)

    stated = ranks(ref.ROUNDINGS[c["program"]["compute_dtype"]])
    reference = ref.ranking_metrics(stated, t["cutoffs"])
    for name, r in (("control", ranks(ref.round_fp8)), ("half", stated[::2]),
                    ("token", stated + 1)):
        yield name, compare.eval_numbers([ref.ranking_metrics(r, t["cutoffs"])], reference)


def serve_variants(cell, run, calls_in_window):
    from benchmark.jobs import serve
    from benchmark.reference import gru4rec as ref
    from benchmark.yardstick import compare, weights

    c, t, dev = cell.config, cell.traffic, run.device
    n, k = int(c["n_items"]), int(t["k"])
    items, offsets, sids, _ = serve.stream(cell, run)
    end = min(len(sids), int(t["warmup_calls"]) + calls_in_window)
    sel, q_sess, q_len = serve.sample(cell, run, sids, end)
    ref.strict_float32()
    P = weights.flat(weights.make_params(c, run.stream("weights"), dev))
    stated = ref.ROUNDINGS[c["program"]["compute_dtype"]]
    act = c["params"]["final_act"]

    def top(rnd, lengths):
        _, best, idx = ref.serve_scores(P, items, offsets[q_sess], lengths, n, k, act, rnd,
                                        np.zeros((len(lengths), k), dtype=np.int64))
        return best, idx

    def judged(scores, idx):
        at, best, _ = ref.serve_scores(P, items, offsets[q_sess], q_len, n, k, act, stated,
                                       np.clip(idx, 0, n - 1))
        return compare.serve_numbers(scores, at, best)

    best, idx = top(stated, q_len)
    half = np.arange(len(q_len)) % 2 == 1
    yield "control", judged(*top(ref.round_fp8, q_len))
    yield "half", judged(np.where(half[:, None], 0.0, best), np.where(half[:, None], 0, idx))
    yield "token", judged(best, (idx + 1) % n)
    yield "state", judged(*top(stated, np.ones_like(q_len)))


def main(argv=None) -> int:
    import torch

    from benchmark import spec
    from benchmark.jobs import common

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--serve-calls", type=int, default=90000,
                   help="window calls the checked serving calls are drawn from")
    p.add_argument("--sampler-only", action="store_true",
                   help="training cells: the sampler's readings alone")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", flush=True)
        return 3
    dev = torch.device("cuda", 0)
    kind = cell.traffic["kind"]
    for seed in args.seeds:
        run = common.Run(seed=seed, seconds=spec.load_spec()["run_seconds"], trace=False,
                         device=dev)
        variants = {"fit": lambda: (*(() if args.sampler_only else train_variants(cell, run)),
                                    *sampler_variants(cell, run)),
                    "evaluate": lambda: eval_variants(cell, run),
                    "serve": lambda: serve_variants(cell, run, args.serve_calls)}[kind]()
        for name, numbers in variants:
            print(json.dumps({"workload": cell.name, "seed": seed, "variant": name,
                              "numbers": numbers}), flush=True)
        common.free(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
