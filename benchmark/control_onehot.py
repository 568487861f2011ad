"""The control and the planted faults of the one-hot training cell's
comparison (the traffic kind ``fit_onehot``), read at the cell's own size,
with the reference put in the program's place:

    python3 -m benchmark.control_onehot --workload <cell> --seeds <n> <n> <n>
        [--sampler-only]

:mod:`benchmark.control`'s training variants for the one-hot model: one
JSON line per variant and seed with the numbers the cell compares, against
:mod:`benchmark.reference.gru4rec_onehot` in the stated precision.

* ``control``: the reference with float8 (e4m3, per-tensor scale) product
  operands and gradients, the precision below the stated bfloat16;
* ``half``: the cost over the first half of the live lanes, divided by
  half the batch;
* ``token``: every target one item on.

``sampler_gap`` comes from :func:`benchmark.control.sampler_variants`. The
configuration's ``sample_alpha`` is 0, so its draw is uniform and
``sampler_uniform`` is the stated draw, no fault: the faults that the
check must separate here are ``sampler_alpha_low`` (``pop ** -0.1``, rare
items favoured) and ``sampler_alpha_high`` (``pop ** 0.1``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def train_variants(cell, run):
    from benchmark.jobs import fit, fit_onehot
    from benchmark.reference import gru4rec as ref
    from benchmark.reference import gru4rec_onehot as ref_onehot
    from benchmark.yardstick import compare, generators

    c, t, dev = cell.config, cell.traffic, run.device
    data = fit.clicks(cell, run)
    items, offsets = generators.sessions_csr(data)
    pop = np.bincount(items, minlength=int(c["n_items"]))
    negs = fit.draw_negatives(np.random.default_rng(run.stream("negatives")), pop,
                              float(c["params"]["sample_alpha"]), int(t["checked_steps"]),
                              int(c["params"]["n_sample"]))
    n_items = int(c["n_items"])

    class Half(ref_onehot.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.norm = self.B / 2

        def step(self, inputs, targets, live, fresh, neg, gen):
            lanes = np.flatnonzero(live)
            kept = live.copy()
            kept[lanes[len(lanes) // 2:]] = False
            return super().step(inputs, targets, kept, fresh, neg, gen)

    class Token(ref_onehot.Trainer):
        def step(self, inputs, targets, live, fresh, neg, gen):
            return super().step(inputs, (targets + 1) % n_items, live, fresh, neg, gen)

    args = (c, run.stream("weights"), run.stream("program"), items, offsets, pop, negs)
    stated = ref.ROUNDINGS[c["program"]["compute_dtype"]]
    reference = fit_onehot.reference_numbers(*args, stated, dev)
    yield "control", compare.train_numbers(
        fit_onehot.reference_numbers(*args, ref.round_fp8, dev), reference)
    yield "half", compare.train_numbers(
        fit_onehot.reference_numbers(*args, stated, dev, trainer_cls=Half), reference)
    yield "token", compare.train_numbers(
        fit_onehot.reference_numbers(*args, stated, dev, trainer_cls=Token), reference)


def main(argv=None) -> int:
    import torch

    from benchmark import control, spec
    from benchmark.jobs import common

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sampler-only", action="store_true",
                   help="the sampler's readings alone")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if cell.traffic["kind"] != "fit_onehot":
        print(f"{args.workload} is no one-hot training cell", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("the control runs on the card", flush=True)
        return 3
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        run = common.Run(seed=seed, seconds=spec.load_spec()["run_seconds"], trace=False,
                         device=dev)
        variants = (*(() if args.sampler_only else train_variants(cell, run)),
                    *control.sampler_variants(cell, run))
        for name, numbers in variants:
            print(json.dumps({"workload": cell.name, "seed": seed, "variant": name,
                              "numbers": numbers}), flush=True)
        common.free(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
