"""Asserting reproduction harness for ALL published-dataset results.

The reference publishes golden Recall@N / MRR@N (N in {1, 5, 10, 20}) for
six public datasets trained with the shipped best-hyperparameter files
(reference README.md:349-368; ``paramfiles/``, copied beside this module).
This harness trains the mapped paramfile config on a dataset's official
``train_full`` split, evaluates on ``test``, ASSERTS every metric within a
relative tolerance (the reference's own bar: "some slight variation (even
up to a few percent) ... is expected and acceptable", README.md:359), and
writes a machine-readable JSON report.

    python -m gru4rec_tpu_torch.examples.reproduce_published retailrocket \\
        retailrocket_train_full.txt retailrocket_test.txt

Exit status 0 only if every metric lands inside tolerance: a one-command
parity gate for whoever holds the datasets (obtain them from the original
sources; see the reference README's links). RSC15's CIKM'18 three-config
protocol has its own harness (``examples/rsc15/run_rsc15.py``); the RSC15
row HERE is the newer shared-embedding xe config
(``paramfiles/rsc15_xe_shared_100_best.py``), matching the published table.

Options: ``--tol`` relative tolerance (default 0.05), ``--cutoffs`` subset,
``--out`` report path, ``--mesh NDxNM`` (or ``auto``: ``factor_mesh`` of the
launched ranks) to train and evaluate over a (data, model) mesh of ranks,
``-d/--device``. The model runs on the card unless ``-d cpu`` asks for the
CPU (the JAX harness takes its backend from the environment instead). A
mesh of more than one rank runs one process per rank under ``python -m
torch.distributed.run --nproc_per_node ND*NM`` (``torchrun``), as
``cli/run.py --mesh`` does; only rank 0 prints the metrics and writes the
report, and every rank exits with the same status.
"""

import argparse
import json
import os
import sys
import time

import pandas as pd

from gru4rec_tpu_torch import GRU4Rec, GRU4RecConfig
from gru4rec_tpu_torch.eval import evaluate

PARAMFILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "paramfiles")
CUTOFFS = [1, 5, 10, 20]

# reference README.md:361-368 (the RetailRocket row is spelled
# "ReatilRocket" there; values reproduced verbatim)
EXPECTED = {
    "rsc15": {
        "paramfile": "rsc15_xe_shared_100_best",
        "recall": {1: 0.1845, 5: 0.4906, 10: 0.6218, 20: 0.7283},
        "mrr": {1: 0.1845, 5: 0.2954, 10: 0.3130, 20: 0.3205},
    },
    "yoochoose": {
        "paramfile": "yoochoose_best",
        "recall": {1: 0.1829, 5: 0.4478, 10: 0.5715, 20: 0.6789},
        "mrr": {1: 0.1829, 5: 0.2783, 10: 0.2949, 20: 0.3024},
    },
    "rees46": {
        "paramfile": "rees46_best",
        "recall": {1: 0.1114, 5: 0.3010, 10: 0.4135, 20: 0.5293},
        "mrr": {1: 0.1114, 5: 0.1778, 10: 0.1928, 20: 0.2008},
    },
    "coveo": {
        "paramfile": "coveo_best",
        "recall": {1: 0.0513, 5: 0.1496, 10: 0.2212, 20: 0.3135},
        "mrr": {1: 0.0513, 5: 0.0852, 10: 0.0946, 20: 0.1010},
    },
    "retailrocket": {
        "paramfile": "retailrocket_best",
        "recall": {1: 0.1274, 5: 0.3237, 10: 0.4207, 20: 0.5186},
        "mrr": {1: 0.1274, 5: 0.1977, 10: 0.2107, 20: 0.2175},
    },
    "diginetica": {
        "paramfile": "diginetica_best",
        "recall": {1: 0.0725, 5: 0.2369, 10: 0.3542, 20: 0.4995},
        "mrr": {1: 0.0725, 5: 0.1288, 10: 0.1442, 20: 0.1542},
    },
}


def load_config(paramfile):
    """Load a shipped paramfile through the same loader the CLI uses
    (GRU4RecConfig.from_parameter_file, which also echoes each SET line)."""
    return GRU4RecConfig.from_parameter_file(os.path.join(PARAMFILES, paramfile + ".py"))


def make_mesh(spec, device):
    """The (data, model) mesh of ``--mesh NDxNM`` or ``auto``; a mesh of more
    than one rank must have been started by torchrun."""
    from gru4rec_tpu_torch.parallel import factor_mesh, make_mesh as build
    from gru4rec_tpu_torch.parallel.mesh import world_size

    if spec.lower() == "auto":
        nd, nm = factor_mesh(world_size())
    else:
        try:
            nd, nm = (int(v) for v in spec.lower().split("x"))
        except ValueError:
            raise SystemExit(f"ERROR. --mesh must be 'NDxNM' (e.g. 2x2) or 'auto', "
                             f"got {spec!r}")
    if nd * nm > 1 and "RANK" not in os.environ:
        raise SystemExit(
            f"ERROR. --mesh {spec} runs {nd * nm} processes, one per rank: start it as "
            f"`python -m torch.distributed.run --nproc_per_node {nd * nm} "
            f"-m gru4rec_tpu_torch.examples.reproduce_published ...` (torchrun)")
    return build(nd, nm, device=device)


def run(dataset, train_path, test_path, tol, cutoffs, out_path, mesh=None, device=None):
    primary = mesh is None or mesh.rank == 0
    say = print if primary else (lambda *a, **k: None)
    exp = EXPECTED[dataset]
    say(f"dataset={dataset} paramfile={exp['paramfile']}")
    cfg = load_config(exp["paramfile"])
    data = pd.read_csv(train_path, sep="\t", dtype={"ItemId": str})
    valid = pd.read_csv(test_path, sep="\t", dtype={"ItemId": str})

    t0 = time.time()
    gru = GRU4Rec(cfg, device=device)
    gru.fit(data, mesh=mesh)
    t_fit = time.time() - t0
    rec, mrr = evaluate(gru, valid, batch_size=512, cut_off=cutoffs, mesh=mesh)

    report = {
        "dataset": dataset, "paramfile": exp["paramfile"],
        "train": os.path.abspath(train_path),
        "test": os.path.abspath(test_path),
        "tolerance_rel": tol, "fit_seconds": round(t_fit, 1),
        "metrics": [], "pass": True,
    }
    for kind, measured_list, table in (("recall", rec, exp["recall"]),
                                       ("mrr", mrr, exp["mrr"])):
        for c, measured in zip(cutoffs, measured_list):
            expected = table[c]
            rel = abs(measured - expected) / expected
            ok = rel <= tol
            report["pass"] = report["pass"] and ok
            report["metrics"].append({
                "metric": f"{kind}@{c}", "expected": expected,
                "measured": measured, "rel_err": rel, "pass": ok,
            })
            say(f"{kind}@{c}: {measured:.4f} (expected {expected:.4f}, "
                f"rel err {rel*100:.2f}%, {'PASS' if ok else 'FAIL'})")
    if primary:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    say(f"report written to {out_path}")
    say("PARITY " + ("PASS" if report["pass"] else "FAIL"))
    return 0 if report["pass"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", choices=sorted(EXPECTED))
    ap.add_argument("train", help="<dataset>_train_full.txt")
    ap.add_argument("test", help="<dataset>_test.txt")
    ap.add_argument("--tol", type=float, default=0.05)
    # nargs='+': a bare --cutoffs (e.g. an empty shell variable) must error,
    # not assert nothing and exit 0 from an asserting gate
    ap.add_argument("--cutoffs", type=int, nargs="+", default=CUTOFFS,
                    help="subset of the published cutoffs 1 5 10 20")
    ap.add_argument("--out", default=None,
                    help="report path (default PARITY_<DATASET>.json)")
    ap.add_argument("--mesh", default=None,
                    help="NDxNM data/model mesh (e.g. 2x2) or 'auto'; more than one "
                         "rank runs under torchrun, one process per rank")
    ap.add_argument("-d", "--device", default=None,
                    help="device (e.g. cpu, cuda:1); default is the CUDA card")
    args = ap.parse_args(argv)
    bad = [c for c in args.cutoffs if c not in CUTOFFS]
    if bad:
        ap.error(f"no published numbers for cutoffs {bad}; pick from {CUTOFFS}")
    mesh = make_mesh(args.mesh, args.device) if args.mesh else None
    out = args.out or f"PARITY_{args.dataset.upper()}.json"
    try:
        return run(args.dataset, args.train, args.test, args.tol, args.cutoffs,
                   out, mesh=mesh, device=args.device)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
