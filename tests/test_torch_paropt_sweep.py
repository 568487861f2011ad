"""``scripts/run_paropt_sweep_torch.py`` against the JAX package's
``scripts/run_paropt_sweep.py``, on the CPU.

* the summary line's keys, in order, and the sweep's constants (space,
  fixed parameters, catalog and split sizes) read from the JAX script's
  source with ``ast``; the synthetic frames equal the JAX script's;
* the trial-line parser on a canned paropt log: trials, epochs, metrics,
  wall times, a failed trial, and the final re-run of the best parameters,
  whose epochs are not read as the last trial's;
* the cold copy of the package: an empty ``_build/`` that the children
  import through ``PYTHONPATH`` (the checkout's own build is not touched);
* a two-trial sweep on the CPU at a narrow size (the module's constants
  patched in-process; the 400,000-event sweep runs on the card), through
  ``python -m gru4rec_tpu_torch.cli.paropt -d cpu``: exit 0, two trial
  lines with a metric and two epochs each, the summary, and paropt's final
  run of the best parameters at the best trial's Recall@20.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "run_paropt_sweep.py")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep = _load("run_paropt_sweep_torch",
              os.path.join(REPO, "scripts", "run_paropt_sweep_torch.py"))


def _jax_source():
    with open(JAX_SCRIPT) as f:
        return ast.parse(f.read())


def _jax_summary_keys():
    """The keys of the JAX script's summary dict (the one whose "metric" is
    "paropt_sweep"), in order."""
    for node in ast.walk(_jax_source()):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                and isinstance(v, ast.Constant) and v.value == "paropt_sweep"
                for k, v in zip(node.keys, node.values)):
            return [k.value for k in node.keys]
    raise AssertionError("no summary dict in the JAX script")


def test_summary_keys_and_constants_are_the_jax_scripts():
    keys = list(sweep.summary([{"trial": 1, "epoch1_s": 9.0}], 0, 1.0, "log").keys())
    assert keys == _jax_summary_keys()
    consts = {t.id: ast.literal_eval(node.value) for node in _jax_source().body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id.isupper()}
    for name in ("N_ITEMS", "TRAIN_EVENTS", "TEST_EVENTS", "MEAN_SESSION_LEN", "SPACE",
                 "FIXED"):
        assert getattr(sweep, name) == consts[name], name


def test_synthetic_frames_are_the_jax_scripts():
    jax_sweep = _load("run_paropt_sweep_jax", JAX_SCRIPT)
    for seed in (0, 1):
        pd.testing.assert_frame_equal(sweep.synth(5000, seed), jax_sweep.synth(5000, seed))


CANNED = """\
--------------------------------------------------------------------------------
PARAMETER SPACE
--------------------------------------------------------------------------------
(optuna not installed: using built-in random search)
--- trial 1/3: learning_rate=0.0412,momentum=0.2,bpreg=1.25
Epoch1 --> loss: 0.512000 \t(61.37s) \t[33.10 mb/s | 2650 e/s]
Epoch2 --> loss: 0.401000 \t(3.02s) \t[680.00 mb/s | 54000 e/s]
Epoch3 --> loss: 0.377000 \t(2.98s) \t[690.00 mb/s | 55000 e/s]
Recall@20: 0.301234 MRR@20: 0.101234
PRIMARY METRIC: 0.30123456789
--- trial 2/3: learning_rate=0.15,momentum=0.4,bpreg=0.5
Traceback (most recent call last):
RuntimeError: trial produced no PRIMARY METRIC line
trial failed (trial produced no PRIMARY METRIC line); continuing
--- trial 3/3: learning_rate=0.03,momentum=0.0,bpreg=2.0
Epoch1 --> loss: 0.600000 \t(3.51s) \t[600.00 mb/s | 50000 e/s]
Epoch2 --> loss: 0.500000 \t(3.01s) \t[680.00 mb/s | 54000 e/s]
Epoch3 --> loss: 0.450000 \t(2.99s) \t[690.00 mb/s | 55000 e/s]
PRIMARY METRIC: 2.5e-05
Best value: 0.30123456789
Best parameters: {'learning_rate': 0.0412, 'momentum': 0.2, 'bpreg': 1.25}
Running final eval @[20]:
Epoch1 --> loss: 0.512000 \t(3.40s) \t[600.00 mb/s | 50000 e/s]
Epoch2 --> loss: 0.401000 \t(3.02s) \t[680.00 mb/s | 54000 e/s]
Epoch3 --> loss: 0.377000 \t(2.98s) \t[690.00 mb/s | 55000 e/s]
Recall@20: 0.301235 MRR@20: 0.101234
"""


def test_trial_parser_on_a_canned_log():
    ticks = iter(range(0, 1000, 10))
    parser = sweep.TrialParser(clock=lambda: float(next(ticks)))
    for line in CANNED.splitlines(keepends=True):
        parser.feed(line)
    rows = parser.trials()
    assert rows == [
        {"trial": 1, "params": "learning_rate=0.0412,momentum=0.2,bpreg=1.25",
         "epoch1_s": 61.37, "epoch2_s": 3.02, "epoch3_s": 2.98, "metric": 0.30123456789,
         "wall_s": 10.0},
        {"trial": 2, "params": "learning_rate=0.15,momentum=0.4,bpreg=0.5"},
        # the final run's epochs (3.40 s) are not this trial's
        {"trial": 3, "params": "learning_rate=0.03,momentum=0.0,bpreg=2.0",
         "epoch1_s": 3.51, "epoch2_s": 3.01, "epoch3_s": 2.99, "metric": 2.5e-05,
         "wall_s": 10.0}]
    out = sweep.summary(rows, 0, 123.456, "sweep.log")
    assert out == {"metric": "paropt_sweep", "n_trials": 3, "rc": 0, "total_wall_s": 123.5,
                   "trial1_epoch1_s": 61.37, "warm_epoch1_s_median": 3.51,
                   "cache_shared": True, "log": "sweep.log"}
    assert not sweep.summary(rows[:1], 0, 1.0, "x")["cache_shared"]
    assert sweep.summary([], 1, 1.0, "x")["trial1_epoch1_s"] is None


def test_cold_package_has_an_empty_build_dir(tmp_path):
    root = sweep.cold_package(str(tmp_path))
    pkg = os.path.join(root, "gru4rec_tpu_torch")
    assert os.listdir(os.path.join(pkg, "_build")) == []
    assert os.path.exists(os.path.join(pkg, "csrc", "sparse_update.cu"))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run(
        [sys.executable, "-c", "from gru4rec_tpu_torch.ops.kernels import build; "
         "print(build.BUILD_DIR)"], capture_output=True, text=True, cwd=str(tmp_path),
        env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert os.path.realpath(res.stdout.strip()) == os.path.realpath(os.path.join(pkg, "_build"))


def test_two_trial_sweep_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The script end to end at a narrow size: N_ITEMS 300, 4,000 training
    and 800 test events, GRU-16 with 32 negatives, 2 epochs."""
    monkeypatch.setattr(sweep, "N_ITEMS", 300)
    monkeypatch.setattr(sweep, "TRAIN_EVENTS", 4000)
    monkeypatch.setattr(sweep, "TEST_EVENTS", 800)
    monkeypatch.setattr(sweep, "FIXED", sweep.FIXED.replace("layers=224", "layers=16")
                        .replace("n_sample=2048", "n_sample=32")
                        .replace("n_epochs=3", "n_epochs=2")
                        .replace("chunk_size=512", "chunk_size=32"))
    monkeypatch.delenv("GRU4REC_TPU_LOG_JSONL", raising=False)
    rc = sweep.main(["2", str(tmp_path), "-d", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 0, open(tmp_path / "sweep.log").read()[-3000:]
    trials, summ = lines[:-1], lines[-1]
    assert [t["trial"] for t in trials] == [1, 2]
    for t in trials:
        assert set(t) == {"trial", "params", "epoch1_s", "epoch2_s", "metric", "wall_s"}
        assert 0.0 <= t["metric"] <= 1.0
    assert summ["n_trials"] == 2 and summ["rc"] == 0
    assert summ["trial1_epoch1_s"] == trials[0]["epoch1_s"]
    assert np.isclose(summ["warm_epoch1_s_median"], round(trials[1]["epoch1_s"], 2))
    # the checkout's package was not run: the copy's build directory was
    assert os.path.isdir(tmp_path / "pkg" / "gru4rec_tpu_torch" / "_build")
    # paropt's final run repeats the best trial: the same Recall@20
    log = open(summ["log"]).read().split("Running final eval @[20]:")[-1]
    final = [ln.split()[1] for ln in log.splitlines() if ln.startswith("Recall@20:")]
    assert final == [f"{max(t['metric'] for t in trials):.6f}"]
