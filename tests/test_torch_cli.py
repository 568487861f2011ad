"""The port's CLI, ``python -m gru4rec_tpu_torch.cli.run``, on the CPU.

* a subprocess with ``-d cpu`` trains, saves and evaluates, printing
  ``PRIMARY METRIC:``; ``-l`` on its archive prints the same metric;
* exit code 1 on a mode error, 2 on a NaN run;
* the JAX package's ``cli.run.main`` trains and saves (``final_act=linear``,
  where the JAX evaluator's logits are the activated scores, F1), and the
  port's ``-l`` on that archive prints the same metric within 1e-6;
* ``--mesh 1x1 -d cpu`` prints the ``PRIMARY METRIC:`` of the same run
  without a mesh; ``--mesh 2x2`` without ``torchrun`` exits with an error
  that gives the ``torchrun`` command (tests/test_torch_paropt.py runs a
  2-rank mesh under it).
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gru4rec_tpu.cli import run as jrun  # noqa: E402
from gru4rec_tpu_torch.cli import run as trun  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = ("loss=cross-entropy,final_act=softmax,layers=24,batch_size=8,n_sample=16,"
      "n_epochs=2,chunk_size=64,item_pad_multiple=32,learning_rate=0.15")


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
    return train_p, test_p, d


def primary_metric(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("PRIMARY METRIC:")]
    assert len(lines) == 1, out
    return float(lines[0].split(":")[1])


def test_cli_subprocess_train_save_load(tsv_files, capsys):
    train_p, test_p, d = tsv_files
    model_p = str(d / "port.npz")
    res = subprocess.run(
        [sys.executable, "-m", "gru4rec_tpu_torch.cli.run", train_p, "-ps", PS,
         "-t", test_p, "-m", "1", "5", "-pm", "mrr", "-lpm", "-s", model_p, "-d", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "GRU4REC_TPU_NAN_DUMP": ""})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Recall@1:" in res.stdout and "Recall@5:" in res.stdout
    trained = primary_metric(res.stdout)
    assert 0.0 <= trained <= 1.0
    assert trun.main([model_p, "-l", "-t", test_p, "-m", "1", "5", "-pm", "mrr",
                      "-lpm", "-d", "cpu"]) == 0
    assert primary_metric(capsys.readouterr().out) == trained


def test_cli_mode_error_and_nan_exit_codes(tsv_files, capsys, monkeypatch):
    train_p, test_p, _ = tsv_files
    assert trun.main([train_p, "-t", test_p, "-d", "cpu"]) == 1
    assert trun.main([train_p, "-l", "-ps", PS, "-d", "cpu"]) == 1
    assert "Exactly one of" in capsys.readouterr().out
    monkeypatch.setenv("GRU4REC_TPU_NAN_DUMP", "")
    assert trun.main([train_p, "-ps", PS + ",n_epochs=1,learning_rate=nan",
                      "-t", test_p, "-lpm", "-d", "cpu"]) == 2
    out = capsys.readouterr().out
    assert "training diverged" in out and "PRIMARY METRIC" not in out


def test_port_cli_loads_jax_cli_archive(tsv_files, capsys):
    train_p, test_p, d = tsv_files
    model_p = str(d / "jax.npz")
    ps = PS.replace("final_act=softmax", "final_act=linear").replace(
        "loss=cross-entropy", "loss=bpr-max") + ",compute_dtype=float32"
    assert jrun.main([train_p, "-ps", ps, "-s", model_p, "-t", test_p, "-m", "5",
                      "-pm", "mrr", "-lpm", "-d", "cpu"]) == 0
    want = primary_metric(capsys.readouterr().out)
    assert trun.main([model_p, "-l", "-t", test_p, "-m", "5", "-pm", "mrr", "-lpm",
                      "-d", "cpu"]) == 0
    got = primary_metric(capsys.readouterr().out)
    assert abs(got - want) <= 1e-6, (got, want)


def test_cli_mesh_fails(tsv_files, capsys, monkeypatch):
    train_p, test_p, _ = tsv_files
    args = [train_p, "-ps", PS, "-t", test_p, "-m", "5", "-lpm", "-d", "cpu"]
    monkeypatch.setenv("GRU4REC_TPU_NAN_DUMP", "")
    assert trun.main(args) == 0
    want = primary_metric(capsys.readouterr().out)
    assert trun.main(args + ["--mesh", "1x1"]) == 0
    out = capsys.readouterr().out
    assert "Device mesh: 1 data x 1 model (1 ranks)" in out
    assert primary_metric(out) == want
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="torch.distributed.run --nproc_per_node 4"):
        trun.main(args + ["--mesh", "2x2"])
