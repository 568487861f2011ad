"""Hyperparameter optimization over CLI subprocesses (paropt).

The PyTorch counterpart of ``gru4rec_tpu/cli/paropt.py``, with its flags.
Parity with the reference's paropt.py: JSONL parameter-space files
(int/float/categorical with step and log options, paropt.py:59-88), trials
run as isolated subprocesses of ``python -m gru4rec_tpu_torch.cli.run``
whose stdout is scraped for the ``PRIMARY METRIC:`` line (paropt.py:44-57),
and a final re-evaluation of the best parameters (paropt.py:112-121).

Uses Optuna's TPE when available; otherwise falls back to a built-in
random-search sampler over the same space (trial-level process isolation
and the metric contract are what matter).

Every child builds its native sources into the package's own
``gru4rec_tpu_torch/_build/`` (``ops/kernels/build.py``, keyed on a hash of
each source), which all children share by construction: a sweep compiles
the kernels once, in its first trial. ``-d`` is forwarded to every child;
the children run on the CUDA card unless ``-d cpu`` asks for the CPU.
``--mesh`` is forwarded too, and a mesh of more than one rank starts each
child under ``torch.distributed.run`` (:func:`generate_command`).

    python -m gru4rec_tpu_torch.cli.paropt train.tsv valid.tsv \\
        -fp loss=bpr-max,layers=224 -opf space.jsonl -nt 20 -m 20 -fm 1 5 20
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np


class Parameter:
    """One line of a JSONL parameter-space file (reference: paropt.py:59-88)."""

    def __init__(self, name, dtype, values, step=None, log=False):
        assert dtype in ("int", "float", "categorical")
        assert isinstance(values, list)
        assert len(values) == 2 or dtype == "categorical"
        self.name = name
        self.dtype = dtype
        self.values = values
        self.step = 1 if (step is None and dtype == "int") else step
        self.log = log

    @classmethod
    def fromjson(cls, json_string):
        obj = json.loads(json_string)
        return cls(obj["name"], obj["dtype"], obj["values"], obj.get("step"),
                   obj.get("log", False))

    def suggest_optuna(self, trial):
        if self.dtype == "int":
            return trial.suggest_int(self.name, int(self.values[0]), int(self.values[1]),
                                     step=self.step, log=self.log)
        if self.dtype == "float":
            return trial.suggest_float(self.name, float(self.values[0]), float(self.values[1]),
                                       step=self.step, log=self.log)
        return trial.suggest_categorical(self.name, self.values)

    def suggest_random(self, rng: np.random.RandomState):
        if self.dtype == "categorical":
            return self.values[rng.randint(len(self.values))]
        lo, hi = float(self.values[0]), float(self.values[1])
        if self.log:
            v = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        else:
            v = float(rng.uniform(lo, hi))
        if self.step:
            # snap to the grid, then clamp: a draw near hi can round to the
            # next grid point ABOVE the declared range
            v = min(lo + round((v - lo) / self.step) * self.step, hi)
        if self.dtype == "int":
            return int(round(v))
        return round(v, 10)

    def __str__(self):
        desc = f"PARAMETER {self.name} \t type={self.dtype}"
        if self.dtype in ("int", "float"):
            desc += " \t range=[{}..{}] (step={}) \t {} scale".format(
                self.values[0], self.values[1],
                self.step if self.step is not None else "N/A",
                "LOG" if self.log else "UNIFORM")
        else:
            desc += " \t options: [{}]".format(",".join(str(x) for x in self.values))
        return desc


def generate_command(args, optimized_param_str, measure, log_pm=True):
    cmd = [
        sys.executable, "-m", "gru4rec_tpu_torch.cli.run", args.path,
        "-t", args.test, "-g", args.gru4rec_model,
        "-ps", f"{args.fixed_parameters},{optimized_param_str}" if args.fixed_parameters else optimized_param_str,
        "-m", *[str(m) for m in (measure if isinstance(measure, list) else [measure])],
        "-pm", args.primary_metric, "-e", args.eval_type,
        "-ik", args.item_key, "-sk", args.session_key, "-tk", args.time_key,
    ]
    if getattr(args, "device", None):
        cmd += ["-d", args.device]
    mesh = getattr(args, "mesh", None)
    if mesh:
        cmd += ["--mesh", mesh]
    if log_pm:
        cmd.append("-lpm")
    ranks = mesh_ranks(mesh)
    if ranks > 1:  # one process per rank, started by torchrun
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(ranks)] + cmd[1:]
    return cmd


def mesh_ranks(spec) -> int:
    """The ranks an 'NDxNM' ``--mesh`` names; 1 for none, ``auto`` (the
    child factors its own launch) or a spec the child will refuse."""
    try:
        nd, nm = (int(p) for p in (spec or "").lower().split("x"))
    except ValueError:
        return 1
    return nd * nm


def trial_env(args):
    """os.environ plus the -tf NAME=value overrides, applied to EVERY child
    process (trials and the final best-params re-evaluation alike). Nothing
    else is exported: the children share the package's build directory of
    native libraries without being told (module doc)."""
    env = os.environ.copy()
    for pair in (getattr(args, "flags", "") or "").split(";"):
        if pair.strip():
            name, _, value = pair.partition("=")
            env[name.strip()] = value.strip()
    return env


def scrape_primary_metric(line):
    """The trial-stdout contract (reference paropt.py:52-56). Accepts any
    float repr(): plain, scientific WITHOUT a decimal point ('5e-05' —
    early-epoch recall on a huge catalog prints like that), inf/nan from a
    degenerate run. Returns None when the line is not the metric line."""
    m = re.match(
        r"PRIMARY METRIC:\s*([-+]?[\d.]+(?:[eE][-+]?\d+)?|[-+]?(?:inf|nan))",
        line)
    return float(m.group(1)) if m else None


def run_once(args, optimized_param_str):
    """Spawn one isolated trial; scrape PRIMARY METRIC from its stdout."""
    cmd = generate_command(args, optimized_param_str, args.measure)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=trial_env(args))
    val = None
    for line in proc.stdout:
        line = line.rstrip()
        print(line)
        scraped = scrape_primary_metric(line)
        if scraped is not None:
            val = scraped
    proc.wait()
    if val is None:
        raise RuntimeError("trial produced no PRIMARY METRIC line")
    return val


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Optimize GRU4Rec hyperparameters on a validation set.",
        epilog="Every trial runs `python -m gru4rec_tpu_torch.cli.run` in a "
               "subprocess. The trials share the package's build directory "
               "(gru4rec_tpu_torch/_build/): the first trial compiles the "
               "CUDA kernels and the schedule builder, and later trials load "
               "them. The trials run on the CUDA card unless -d cpu asks for "
               "the CPU.")
    parser.add_argument("path", metavar="PATH", type=str)
    parser.add_argument("test", metavar="TEST_PATH", type=str)
    parser.add_argument("-g", "--gru4rec_model", type=str, default="gru4rec_tpu_torch")
    parser.add_argument("-tf", "--flags", metavar="FLAGS", type=str, default="",
                        help="Environment settings for the trial subprocesses as "
                             "`NAME=value` pairs separated by `;` (the "
                             "equivalent of the reference's THEANO_FLAGS "
                             "passthrough, paropt.py:20,46 — e.g. "
                             "'GRU4REC_TPU_LOG_JSONL=trials.jsonl' or "
                             "'CUDA_VISIBLE_DEVICES=1').")
    parser.add_argument("-d", "--device", metavar="D", type=str, default=None,
                        help="Forwarded to every trial's run.py: the device "
                             "(e.g. cpu, cuda:1); default is the CUDA card.")
    parser.add_argument("--mesh", metavar="DATAxMODEL", type=str, default=None,
                        help="Forwarded to every trial's run.py ('NDxNM' or 'auto'); "
                             "a mesh of more than one rank starts each child as "
                             "`python -m torch.distributed.run --standalone "
                             "--nproc_per_node ND*NM`, one process per rank.")
    parser.add_argument("-fp", "--fixed_parameters", metavar="PARAM_STRING", type=str, default="")
    parser.add_argument("-opf", "--optuna_parameter_file", metavar="PATH", type=str, required=True)
    # const= so a BARE `-m` / `-nt` keeps the default instead of parsing to
    # None and crashing every trial (the reference shares nargs='?' without
    # const, paropt.py:23-24 — a bug there)
    parser.add_argument("-m", "--measure", metavar="AT", type=int, nargs="?",
                        default=20, const=20)
    parser.add_argument("-nt", "--ntrials", metavar="NT", type=int, nargs="?",
                        default=50, const=50)
    parser.add_argument("-fm", "--final_measure", metavar="AT", type=int, nargs="*", default=[20])
    parser.add_argument("-pm", "--primary_metric", choices=["recall", "mrr"], default="recall")
    parser.add_argument("-e", "--eval_type",
                        choices=["standard", "conservative", "median", "tiebreaking"],
                        default="standard")
    parser.add_argument("-ik", "--item_key", type=str, default="ItemId")
    parser.add_argument("-sk", "--session_key", type=str, default="SessionId")
    parser.add_argument("-tk", "--time_key", type=str, default="Time")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--storage", metavar="URL", type=str, default=None,
                        help="Optuna storage URL (e.g. sqlite:///study.db) for "
                             "resumable studies; combine with --study-name.")
    parser.add_argument("--study-name", metavar="NAME", type=str, default=None,
                        help="Optuna study name (with --storage, an existing "
                             "study is resumed).")
    args = parser.parse_args(argv)

    par_space = []
    with open(args.optuna_parameter_file, "rt") as f:
        print("-" * 80)
        print("PARAMETER SPACE")
        for line in f:
            if line.strip():
                par = Parameter.fromjson(line)
                print("\t" + str(par))
                par_space.append(par)
        print("-" * 80)

    # only the import itself is optional: a failure INSIDE the optuna path
    # (e.g. a missing sqlalchemy for --storage) must surface, not silently
    # degrade a resumable TPE study to seed-based random search
    try:
        import optuna
    except ImportError:
        optuna = None
    if optuna is not None:

        def objective(trial):
            pstr = ",".join(f"{p.name}={p.suggest_optuna(trial)}" for p in par_space)
            return run_once(args, pstr)

        # crashed runs resume from the same storage (SURVEY.md §5: paropt
        # trials as isolated processes, resumable Optuna storage); a stable
        # default study name — optuna otherwise auto-generates a fresh one
        # per invocation, which would silently defeat load_if_exists. The
        # default is derived from the dataset and search space, so two runs
        # pointed at one storage URL only merge when they optimize the SAME
        # problem (a fixed name would silently resume across datasets and
        # skip the new run's trials via the COMPLETE-count subtraction).
        study_name = args.study_name
        if study_name is None and args.storage:
            import hashlib

            sig = hashlib.sha1()
            # everything that defines the OBJECTIVE must enter the name:
            # train + validation data, search space, fixed params, and the
            # metric being maximized (kind, cutoff, tie mode). Omitting any
            # of these would let a later sweep with, say, a different
            # validation set or -pm silently resume the old study, skip its
            # own trials via the COMPLETE-count subtraction, and report a
            # best optimized for a different objective.
            sig.update(os.path.abspath(args.path).encode())
            sig.update(b"\0" + os.path.abspath(args.test).encode())
            sig.update(b"\0")
            with open(args.optuna_parameter_file, "rb") as sf:
                sig.update(sf.read())
            sig.update(b"\0" + args.fixed_parameters.encode())
            sig.update(f"\0{args.primary_metric}\0{args.measure}"
                       f"\0{args.eval_type}".encode())
            study_name = f"gru4rec_paropt_{sig.hexdigest()[:12]}"
            print(f"Using derived study name: {study_name}")
        study = optuna.create_study(
            direction="maximize", storage=args.storage,
            study_name=study_name, load_if_exists=args.storage is not None,
        )
        done = len([t for t in study.trials
                    if t.state == optuna.trial.TrialState.COMPLETE])
        # a diverged/crashed trial (run.py exits without a PRIMARY METRIC
        # line — routine when the search samples a too-high learning rate)
        # is recorded as FAILED and the study continues
        study.optimize(objective, n_trials=max(0, args.ntrials - done),
                       catch=(RuntimeError,))
        try:
            best_params = study.best_params
        except ValueError:
            raise RuntimeError("every trial failed; nothing to report")
    else:
        print("(optuna not installed: using built-in random search)")
        rng = np.random.RandomState(args.seed)
        best_val, best_params = -np.inf, None
        for t in range(args.ntrials):
            params = {p.name: p.suggest_random(rng) for p in par_space}
            pstr = ",".join(f"{k}={v}" for k, v in params.items())
            print(f"--- trial {t + 1}/{args.ntrials}: {pstr}")
            try:
                val = run_once(args, pstr)
            except RuntimeError as e:
                print(f"trial failed ({e}); continuing")
                continue
            if val > best_val:
                best_val, best_params = val, params
        if best_params is None:
            raise RuntimeError("every trial failed; nothing to report")
        print(f"Best value: {best_val}")

    print(f"Best parameters: {best_params}")
    print(f"Running final eval @{args.final_measure}:")
    pstr = ",".join(f"{k}={v}" for k, v in best_params.items())
    cmd = generate_command(args, pstr, list(args.final_measure), log_pm=False)
    subprocess.run(cmd, env=trial_env(args))


if __name__ == "__main__":
    main()
