"""CLI: train or load a GRU4Rec model & measure recall/MRR on test sets.

The PyTorch counterpart of ``gru4rec_tpu/cli/run.py``, with its flags
(reference: run.py:10-27), the exactly-one-mode check (exit code 1), the
``PRIMARY METRIC:`` stdout line that the paropt driver reads (reference:
run.py:133), and exit code 2 when training diverges. ``-g`` selects the
module of the GRU4Rec class (default ``gru4rec_tpu_torch``). The model runs
on the card unless ``-d cpu`` asks for the CPU.

``--mesh NDxNM`` (or ``auto``: ``factor_mesh`` of the launched ranks)
trains, validates and evaluates over a (data, model) mesh of ranks
(``parallel/mesh.py``), one process per rank: a mesh of more than one rank
runs under ``python -m torch.distributed.run --nproc_per_node ND*NM``
(``torchrun``), which sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; a
1x1 mesh also runs without it. Each rank takes ``cuda:<LOCAL_RANK>`` over
``nccl``, or the CPU over ``gloo`` with ``-d cpu``. Only rank 0 saves and
prints the results and ``PRIMARY METRIC:``.

    python -m gru4rec_tpu_torch.cli.run train.tsv -ps layers=224,... \\
        -s model.npz -t test.tsv -m 1 5 20 -lpm
    python -m gru4rec_tpu_torch.cli.run model.npz -l -t test.tsv -lpm
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m gru4rec_tpu_torch.cli.run train.tsv -ps ... -t test.tsv --mesh 2x2
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import sys
import time
from collections import OrderedDict


class MyHelpFormatter(argparse.HelpFormatter):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._width = shutil.get_terminal_size().columns


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=MyHelpFormatter,
        description="Train or load a GRU4Rec model & measure recall and MRR on the specified test set(s).",
    )
    parser.add_argument("path", metavar="PATH", type=str,
                        help="Path to the training data (TAB separated file (.tsv or .txt) or pickled pandas.DataFrame (.pickle)) or, with --load_model, to a serialized model checkpoint.")
    parser.add_argument("-ps", "--parameter_string", metavar="PARAM_STRING", type=str,
                        help="Training parameters as a single string: `param_name1=param_value1,param_name2=param_value2...`. Lists use / as separator (e.g. layers=200/200). Mutually exclusive with -pf and -l.")
    parser.add_argument("-pf", "--parameter_file", metavar="PARAM_PATH", type=str,
                        help="Training parameters from a config file containing an OrderedDict named `gru4rec_params`. Mutually exclusive with -ps and -l.")
    parser.add_argument("-l", "--load_model", action="store_true",
                        help="Load an already trained model instead of training. Mutually exclusive with -ps and -pf.")
    parser.add_argument("-s", "--save_model", metavar="MODEL_PATH", type=str,
                        help="Save the trained model to MODEL_PATH.")
    parser.add_argument("-t", "--test", metavar="TEST_PATH", type=str, nargs="+",
                        help="Path(s) to test set(s).")
    parser.add_argument("-m", "--measure", metavar="AT", type=int, nargs="+", default=[20],
                        help="Measure recall & MRR at the given recommendation list length(s). (Default: 20)")
    parser.add_argument("-e", "--eval_type", metavar="EVAL_TYPE",
                        choices=["standard", "conservative", "median", "tiebreaking"],
                        default="standard",
                        help="Tie-handling mode for equal prediction scores. (Default: standard)")
    parser.add_argument("-ss", "--sample_store_size", metavar="SS", type=int, default=10_000_000,
                        help="Negative-sample buffer length (accepted for parity; negatives are drawn on the device per chunk). (Default: 10000000)")
    parser.add_argument("--sample_store_on_cpu", action="store_true",
                        help="Accepted for parity; negatives are always drawn on the model's device.")
    parser.add_argument("-g", "--gru4rec_model", metavar="GRFILE", type=str, default="gru4rec_tpu_torch",
                        help="Module containing the GRU4Rec class, for selecting variants. (Default: gru4rec_tpu_torch)")
    parser.add_argument("-ik", "--item_key", metavar="IK", type=str, default="ItemId",
                        help="Column name of item IDs (default: ItemId).")
    parser.add_argument("-sk", "--session_key", metavar="SK", type=str, default="SessionId",
                        help="Column name of session IDs (default: SessionId).")
    parser.add_argument("-tk", "--time_key", metavar="TK", type=str, default="Time",
                        help="Column name of timestamps (default: Time).")
    parser.add_argument("-pm", "--primary_metric", metavar="METRIC",
                        choices=["recall", "mrr"], default="recall",
                        help="Primary metric, recall or mrr (e.g. for paropt). (Default: recall)")
    parser.add_argument("-lpm", "--log_primary_metric", action="store_true",
                        help="Log the primary metric at the end of the run. Only works with one test file and one list length.")
    parser.add_argument("-d", "--device", metavar="D", type=str, default=None,
                        help="Device (e.g. cpu, cuda:1); default is the CUDA card.")
    parser.add_argument("-vd", "--valid_data", metavar="PATH", type=str, default=None,
                        help="Held-out set evaluated during training (validation "
                             "Recall/MRR per epoch; beyond the reference).")
    parser.add_argument("-vp", "--valid_patience", metavar="N", type=int, default=0,
                        help="Early-stop after N validation evaluations without "
                             "improvement (0 = off; requires -vd). The best-"
                             "validation parameters are kept.")
    parser.add_argument("-vm", "--valid_cutoff", metavar="AT", type=int, default=20,
                        help="Cutoff for the validation metric (default 20).")
    parser.add_argument("--mesh", metavar="DATAxMODEL", type=str, default=None,
                        help="Run over a (data, model) mesh of ranks: 'NDxNM' (e.g. "
                             "2x2 = lanes over 2 ranks, item-table rows over 2) or "
                             "'auto' to factor the launched ranks. More than one rank "
                             "runs under `python -m torch.distributed.run "
                             "--nproc_per_node ND*NM`, one process per rank. Applies "
                             "to training, in-fit validation and evaluation; batch "
                             "sizes must divide the data axis.")
    return parser


def _parse_mesh(spec: str, device):
    from gru4rec_tpu_torch.parallel.mesh import factor_mesh, make_mesh, world_size

    if spec.lower() == "auto":
        nd, nm = factor_mesh(world_size())
    else:
        try:
            nd, nm = (int(p) for p in spec.lower().split("x"))
        except ValueError:
            raise SystemExit(
                f"ERROR. --mesh must be 'NDxNM' (e.g. 2x2) or 'auto', got {spec!r}")
    if nd * nm > 1 and "RANK" not in os.environ:
        raise SystemExit(
            f"ERROR. --mesh {spec} runs {nd * nm} processes, one per rank: start it as "
            f"`python -m torch.distributed.run --nproc_per_node {nd * nm} "
            f"-m gru4rec_tpu_torch.cli.run ...` (torchrun)")
    print(f"Device mesh: {nd} data x {nm} model ({world_size()} ranks)")
    return make_mesh(nd, nm, device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.parameter_string is not None) + (args.parameter_file is not None) + args.load_model != 1:
        print("ERROR. Exactly one of the following parameters must be provided: "
              "--parameter_string, --parameter_file, --load_model")
        return 1
    mesh = _parse_mesh(args.mesh, args.device) if args.mesh else None
    try:
        return _run(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, mesh) -> int:
    from gru4rec_tpu_torch.data.loader import load_data
    from gru4rec_tpu_torch.eval import evaluate

    GRU4Rec = importlib.import_module(args.gru4rec_model).GRU4Rec
    primary = mesh is None or mesh.rank == 0

    if args.load_model:
        print(f"Loading trained model from file: {args.path}")
        gru = GRU4Rec.loadmodel(args.path, device=args.device)
    else:
        if args.parameter_file:
            from gru4rec_tpu_torch.config import GRU4RecConfig

            cfg = GRU4RecConfig.from_parameter_file(args.parameter_file)
            print(f"Loaded parameters from file: {args.parameter_file}")
            gru = GRU4Rec(cfg, device=args.device)
        else:
            print("Creating GRU4Rec model")
            gru = GRU4Rec(device=args.device)
            gru4rec_params = OrderedDict(
                x.split("=", 1) for x in args.parameter_string.split(",") if x
            )
            gru.set_params(**gru4rec_params)
        gru.config.session_key = args.session_key
        gru.config.item_key = args.item_key
        gru.config.time_key = args.time_key
        print("Loading training data...")
        data = load_data(args.path, args.session_key, args.item_key, args.time_key)
        print("Started training")
        fit_kwargs = {}
        if args.valid_data is not None:
            fit_kwargs.update(
                eval_data=load_data(args.valid_data, args.session_key,
                                    args.item_key, args.time_key),
                eval_cutoff=args.valid_cutoff,
                early_stop_patience=args.valid_patience,
            )
        t0 = time.time()
        gru.fit(data, sample_store=args.sample_store_size,
                store_type="cpu" if args.sample_store_on_cpu else "gpu", mesh=mesh,
                **fit_kwargs)
        print("Total training time: {:.2f}s".format(time.time() - t0))
        if gru.error_during_train:
            print("ERROR: training diverged (NaN loss)")
            return 2
        if args.save_model is not None:
            if primary:
                print(f"Saving trained model to: {args.save_model}")
            gru.savemodel(args.save_model)  # rank 0 writes

    if args.test is not None:
        pm_index = 0 if args.primary_metric.lower() == "recall" else 1
        for test_file in args.test:
            print("Loading test data...")
            test_data = load_data(test_file, args.session_key, args.item_key, args.time_key)
            print("Starting evaluation (cut-off={}, using {} mode for tiebreaking)".format(
                args.measure, args.eval_type))
            t0 = time.time()
            res = evaluate(
                gru, test_data, batch_size=512, cut_off=args.measure,
                mode=args.eval_type, item_key=args.item_key,
                session_key=args.session_key, time_key=args.time_key, mesh=mesh,
            )
            if not primary:
                continue
            print("Evaluation took {:.2f}s".format(time.time() - t0))
            for i, c in enumerate(args.measure):
                print("Recall@{}: {:.6f} MRR@{}: {:.6f}".format(c, res[0][i], c, res[1][i]))
            if args.log_primary_metric:
                print("PRIMARY METRIC: {}".format(res[pm_index][0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
