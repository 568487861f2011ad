"""The port's hyperparameter search, ``python -m gru4rec_tpu_torch.cli.paropt``.

* a random search without optuna, as subprocesses on the CPU (``-d cpu``):
  two trials and the final run, ``-tf`` reaching every child (one JSONL
  ``epoch`` event each), after ``tests/test_cli_and_baselines.py``;
* a trial that diverges (exit 2, no metric line) is skipped and the sweep
  goes on; ``--mesh 2x1`` starts each child as two ranks under
  ``torch.distributed.run`` and scrapes rank 0's metric;
* the Optuna branch under the fake ``optuna`` of ``tests/test_paropt_tpe.py``:
  failed trials caught, the best parameters, the final command; a resumed
  storage; the derived study name;
* ``trial_env`` exports the ``-tf`` overrides and nothing of JAX;
* ``generate_command`` names the port's CLI and forwards ``-d`` and
  ``--mesh``, under ``torch.distributed.run`` for a mesh of several ranks.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest

from gru4rec_tpu.cli import paropt as jparopt
from gru4rec_tpu_torch.cli import paropt
from test_paropt_tpe import SPACE, make_fake_optuna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = ("loss=bpr-max,final_act=elu-1,layers=16,batch_size=8,n_sample=16,"
         "n_epochs=1,chunk_size=64,item_pad_multiple=32")


def markov_df(n_sessions, n_items=20, seed=0):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(2, 7)):
            rows.append((s, f"it{i}", t))
            t += 1
            i = (3 * i + 1) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


@pytest.fixture(scope="module")
def tsv_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    train_p, test_p = str(d / "train.tsv"), str(d / "test.tsv")
    markov_df(120).to_csv(train_p, sep="\t", index=False)
    markov_df(30, seed=9).to_csv(test_p, sep="\t", index=False)
    return train_p, test_p


def sweep(tsv_files, tmp_path, space, *extra):
    train_p, test_p = tsv_files
    space_p = tmp_path / "space.jsonl"
    space_p.write_text(space)
    log = tmp_path / "trials.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "gru4rec_tpu_torch.cli.paropt", train_p, test_p,
         "-fp", FIXED, "-opf", str(space_p), "-m", "5", "-fm", "1", "5", "-d", "cpu",
         # the sink is only ever read from the environment, so epoch events
         # in the log prove that -tf reached the children
         "-tf", f"GRU4REC_TPU_LOG_JSONL={log};GRU4REC_TPU_NAN_DUMP=", *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    events = [json.loads(ln) for ln in open(log)] if log.exists() else []
    return res, events


def metrics(out):
    return [paropt.scrape_primary_metric(ln) for ln in out.splitlines()
            if paropt.scrape_primary_metric(ln) is not None]


def test_random_search_end_to_end(tsv_files, tmp_path):
    res, events = sweep(
        tsv_files, tmp_path,
        '{"name": "learning_rate", "dtype": "float", "values": [0.05, 0.2], "log": true}\n'
        '{"name": "momentum", "dtype": "categorical", "values": [0.0, 0.3]}\n',
        "-nt", "2")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "(optuna not installed: using built-in random search)" in res.stdout
    vals = metrics(res.stdout)
    assert len(vals) == 2 and all(0.0 <= v <= 1.0 for v in vals)
    assert float(res.stdout.split("Best value: ")[1].split()[0]) == max(vals)
    final = res.stdout.split("Running final eval @[1, 5]:")[1]
    assert "Recall@1:" in final and "Recall@5:" in final
    assert [e["event"] for e in events] == ["epoch"] * 3


def test_diverged_trial_is_skipped(tsv_files, tmp_path):
    """Seed 0 draws the huge learning rate first: that child exits 2 with no
    metric line, and the sweep goes on to the next trial."""
    res, events = sweep(
        tsv_files, tmp_path,
        '{"name": "learning_rate", "dtype": "categorical", "values": [1e30, 0.1]}\n',
        "-nt", "2")
    assert res.returncode == 0, res.stdout + res.stderr
    first = res.stdout.split("--- trial 2/2")[0]
    assert "learning_rate=1e+30" in first and "training diverged" in first
    assert "trial failed (trial produced no PRIMARY METRIC line); continuing" in first
    assert len(metrics(res.stdout)) == 1
    assert "Best parameters: {'learning_rate': 0.1}" in res.stdout
    assert [e["event"] for e in events] == ["nan_abort", "epoch", "epoch"]


def test_mesh_reaches_the_children(tsv_files, tmp_path):
    res, events = sweep(
        tsv_files, tmp_path,
        '{"name": "learning_rate", "dtype": "categorical", "values": [0.1]}\n',
        "-nt", "1", "--mesh", "2x1")
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("Device mesh: 2 data x 1 model (2 ranks)") == 4  # 2 runs x 2 ranks
    vals = metrics(res.stdout)  # rank 0's alone
    assert len(vals) == 1 and 0.0 <= vals[0] <= 1.0
    assert "Best parameters: {'learning_rate': 0.1}" in res.stdout
    final = res.stdout.split("Running final eval @[1, 5]:")[1]
    assert final.count("Recall@1:") == 1 and final.count("Recall@5:") == 1
    # both ranks log each epoch, as every JAX process does
    assert [e["event"] for e in events] == ["epoch"] * 4


@pytest.fixture
def harness(monkeypatch, tmp_path):
    """The fake optuna; ``run_once`` returns the learning rate, and a rate
    above 0.3 is a diverged trial."""
    fake = make_fake_optuna()
    monkeypatch.setitem(sys.modules, "optuna", fake)
    trial_calls, final_cmds = [], []

    def fake_run_once(args, pstr):
        trial_calls.append(pstr)
        lr = float(dict(kv.split("=", 1) for kv in pstr.split(","))["learning_rate"])
        if lr > 0.3:
            raise RuntimeError("trial produced no PRIMARY METRIC line")
        return lr

    monkeypatch.setattr(paropt, "run_once", fake_run_once)
    monkeypatch.setattr(paropt.subprocess, "run",
                        lambda cmd, env=None: final_cmds.append((cmd, env)))
    space = tmp_path / "space.jsonl"
    space.write_text(SPACE)
    return types.SimpleNamespace(fake=fake, trial_calls=trial_calls,
                                 final_cmds=final_cmds, space=str(space))


def test_tpe_branch_catch_best_and_final_eval(harness, capsys):
    paropt.main(["train.tsv", "test.tsv", "-opf", harness.space, "-nt", "8",
                 "-fm", "1", "20", "-d", "cpu"])
    out = capsys.readouterr().out
    assert len(harness.trial_calls) == 8
    lrs = [float(dict(kv.split("=", 1) for kv in c.split(","))["learning_rate"])
           for c in harness.trial_calls]
    survived = [v for v in lrs if v <= 0.3]
    assert survived and len(survived) < len(lrs)
    assert f"'learning_rate': {max(survived)}" in out.split("Best parameters:")[1]
    (cmd, env), = harness.final_cmds
    assert cmd[1:3] == ["-m", "gru4rec_tpu_torch.cli.run"] and "-lpm" not in cmd
    i = cmd.index("-m", 3)
    assert cmd[i + 1:i + 3] == ["1", "20"]
    assert cmd[cmd.index("-d") + 1] == "cpu"
    assert not any(k.startswith("JAX_") and k not in os.environ for k in env)


def test_tpe_storage_resume_skips_completed_trials(harness, capsys):
    argv = ["train.tsv", "test.tsv", "-opf", harness.space, "-nt", "5",
            "--storage", "sqlite:///study.db"]
    paropt.main(argv)
    assert "Using derived study name: gru4rec_paropt_" in capsys.readouterr().out
    assert len(harness.trial_calls) == 5
    n_failed = sum(t.state == "FAIL" for s in harness.fake._registry.values()
                   for t in s.trials)
    paropt.main(argv)  # only the failed trials' deficit runs again
    assert len(harness.trial_calls) == 5 + n_failed
    assert len(harness.final_cmds) == 2


def test_derived_study_name_equals_the_jax_paropts(harness, capsys, monkeypatch):
    """The same objective gives the same name in both packages; another
    validation set, metric, cutoff or tie mode gives another."""
    monkeypatch.setattr(jparopt, "run_once", paropt.run_once)  # the fake

    def name_for(module, argv):
        module.main(argv + ["--storage", "sqlite:///s.db", "-nt", "1"])
        return capsys.readouterr().out.split("Using derived study name: ")[1].split()[0]

    base = ["train.tsv", "test.tsv", "-opf", harness.space]
    n0 = name_for(paropt, base)
    assert name_for(paropt, base) == n0 == name_for(jparopt, base)
    for other in (["train.tsv", "OTHER.tsv", "-opf", harness.space], base + ["-pm", "mrr"],
                  base + ["-m", "5"], base + ["-e", "median"]):
        assert name_for(paropt, other) != n0


def test_trial_env_exports_the_overrides_and_nothing_of_jax(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    env = paropt.trial_env(types.SimpleNamespace(flags=""))
    assert env == dict(os.environ)
    env = paropt.trial_env(types.SimpleNamespace(flags="FOO=1; BAR = x=y ;"))
    assert env == {**os.environ, "FOO": "1", "BAR": "x=y"}


def test_generate_command_names_the_port_and_forwards_device_and_mesh():
    args = types.SimpleNamespace(
        path="tr.tsv", test="te.tsv", gru4rec_model="gru4rec_tpu_torch",
        fixed_parameters="layers=16", primary_metric="recall", eval_type="standard",
        item_key="ItemId", session_key="SessionId", time_key="Time",
        device=None, mesh=None)
    cmd = paropt.generate_command(args, "learning_rate=0.1", 20)
    assert cmd[:4] == [sys.executable, "-m", "gru4rec_tpu_torch.cli.run", "tr.tsv"]
    assert cmd[cmd.index("-ps") + 1] == "layers=16,learning_rate=0.1"
    assert "-d" not in cmd and "--mesh" not in cmd and cmd[-1] == "-lpm"
    args.device, args.mesh = "cpu", "2x4"
    cmd = paropt.generate_command(args, "learning_rate=0.1", [1, 20], log_pm=False)
    # eight ranks: one process each, started by torchrun
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "8"]
    assert cmd[:len(launch)] == launch
    cmd = [sys.executable] + cmd[len(launch):]
    assert cmd[cmd.index("-d") + 1] == "cpu" and cmd[cmd.index("--mesh") + 1] == "2x4"
    assert cmd[cmd.index("-m", 3) + 1:cmd.index("-m", 3) + 3] == ["1", "20"]
    assert "-lpm" not in cmd
    # the rest of the command is the JAX paropt's, child module aside
    jcmd = jparopt.generate_command(args, "learning_rate=0.1", [1, 20], log_pm=False)
    assert [c for c in cmd if c not in ("-d", "cpu")] == \
        [c.replace("gru4rec_tpu.cli.run", "gru4rec_tpu_torch.cli.run") for c in jcmd]
    for one_rank in ("1x1", "auto"):
        args.mesh = one_rank
        assert paropt.generate_command(args, "learning_rate=0.1", 20)[:3] == \
            [sys.executable, "-m", "gru4rec_tpu_torch.cli.run"]


def test_parameter_and_scrape_equal_the_jax_paropts():
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    for line in SPACE.splitlines():
        p_t, p_j = paropt.Parameter.fromjson(line), jparopt.Parameter.fromjson(line)
        assert str(p_t) == str(p_j)
        assert [p_t.suggest_random(rng_t) for _ in range(20)] == \
            [p_j.suggest_random(rng_j) for _ in range(20)]
    for line in ("PRIMARY METRIC: 0.25", "PRIMARY METRIC: 5e-05", "PRIMARY METRIC: nan",
                 "Recall@20: 0.3"):
        t, j = paropt.scrape_primary_metric(line), jparopt.scrape_primary_metric(line)
        assert t == j or (np.isnan(t) and np.isnan(j))
