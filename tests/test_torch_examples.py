"""The port's published-results harnesses (``gru4rec_tpu_torch/examples/``)
against the JAX package's ``examples/``, on the CPU with small TSVs.

* ``EXPECTED`` and ``CONFIGS`` equal the JAX modules' tables; the paramfile
  copies are byte-equal to ``paramfiles/*.py`` and load to the same config
  in both packages;
* ``reproduce_published`` and ``rsc15.run_rsc15`` exit 0 on a pass and 1 on
  a fail, and write reports with the JAX harness's keys on the same TSVs
  and the same patched ``tiny`` entry; ``--cutoffs 1 20`` orders the
  metrics as JAX does; a bare ``--cutoffs`` and out-of-range ``--configs``
  are rejected; ``--mesh 1x1`` runs in one process;
* ``rsc15.preprocess`` writes the JAX example's four TSVs byte for byte;
* the quickstart runs on the CPU at cut sizes.

The JAX harnesses are loaded as the JAX package's tests load them
(``importlib`` on the file).
"""

import datetime as dt
import filecmp
import importlib.util
import json
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gru4rec_tpu  # noqa: E402
from gru4rec_tpu_torch import GRU4RecConfig  # noqa: E402
from gru4rec_tpu_torch.examples import quickstart_synthetic, reproduce_published  # noqa: E402
from gru4rec_tpu_torch.examples.rsc15 import preprocess, run_rsc15  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMFILES = sorted(f for f in os.listdir(os.path.join(REPO, "paramfiles"))
                    if f.endswith("_best.py"))
TINY_PARAMFILE = (
    "from collections import OrderedDict\n"
    "gru4rec_params = OrderedDict([('loss', 'bpr-max'),"
    "('constrained_embedding', True), ('layers', [24]),"
    "('n_epochs', 2), ('batch_size', 16), ('n_sample', 32),"
    "('learning_rate', 0.1)])\n")
ONES = {1: 1.0, 5: 1.0, 10: 1.0, 20: 1.0}


def _load(*parts):
    path = os.path.join(REPO, "examples", *parts)
    spec = importlib.util.spec_from_file_location("jax_" + parts[-1][:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_published():
    return _load("reproduce_published.py")


@pytest.fixture(scope="module")
def jax_rsc15():
    return _load("rsc15", "run_rsc15.py")


@pytest.fixture(scope="module")
def tsvs(tmp_path_factory):
    """The JAX harness tests' markov TSVs (50 items, next = 7i + 3)."""
    d = tmp_path_factory.mktemp("published")

    def sessions(n, seed):
        r = np.random.RandomState(seed)
        rows, t = [], 0
        for s in range(n):
            i = r.randint(50)
            for _ in range(r.randint(3, 8)):
                rows.append((s, f"i{i}", t))
                t += 1
                i = (7 * i + 3) % 50
        return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])

    train, test = d / "train.txt", d / "test.txt"
    sessions(300, 1).to_csv(train, sep="\t", index=False)
    sessions(50, 9).to_csv(test, sep="\t", index=False)
    return str(train), str(test)


def _patch_tiny(mod, config_cls, monkeypatch, path, mrr=ONES):
    """A 'tiny' dataset entry backed by a real (tiny) paramfile, in either
    package's harness."""
    orig = mod.load_config

    def load(paramfile):
        if paramfile == "tiny_best":
            return config_cls.from_parameter_file(str(path))
        return orig(paramfile)

    monkeypatch.setattr(mod, "load_config", load)
    monkeypatch.setitem(mod.EXPECTED, "tiny", {
        "paramfile": "tiny_best", "recall": dict(ONES), "mrr": dict(mrr)})


@pytest.fixture
def tiny_paramfile(tmp_path):
    path = tmp_path / "tiny_best.py"
    path.write_text(TINY_PARAMFILE)
    return path


def _tiny_configs(expected):
    return [("tiny", dict(
        loss="bpr-max", final_act="elu-1", hidden_act="tanh", layers=[24],
        adapt="adagrad", n_epochs=2, batch_size=16, n_sample=32,
        learning_rate=0.1, constrained_embedding=True), expected)]


def test_tables_equal_the_jax_harnesses(jax_published, jax_rsc15):
    assert reproduce_published.EXPECTED == jax_published.EXPECTED
    assert reproduce_published.CUTOFFS == jax_published.CUTOFFS
    assert run_rsc15.CONFIGS == jax_rsc15.CONFIGS


@pytest.mark.parametrize("name", PARAMFILES)
def test_paramfile_copies_are_byte_equal_and_load_alike(name, jax_published):
    copy = os.path.join(reproduce_published.PARAMFILES, name)
    assert filecmp.cmp(copy, os.path.join(REPO, "paramfiles", name), shallow=False)
    paramfile = name[:-3]
    assert reproduce_published.load_config(paramfile).to_dict() == \
        jax_published.load_config(paramfile).to_dict()


def test_every_published_dataset_has_its_paramfile_copy():
    assert sorted(e["paramfile"] + ".py"
                  for e in reproduce_published.EXPECTED.values()) == PARAMFILES
    assert sorted(f for f in os.listdir(reproduce_published.PARAMFILES)
                  if f.endswith(".py")) == PARAMFILES


def _report_keys(rep):
    return sorted(rep), [sorted(m) for m in rep["metrics"]], \
        [m["metric"] for m in rep["metrics"]]


def test_published_pass_and_report_keys_match_jax(jax_published, tsvs, tiny_paramfile,
                                                   tmp_path, monkeypatch):
    train, test = tsvs
    _patch_tiny(reproduce_published, GRU4RecConfig, monkeypatch,
                tiny_paramfile)
    _patch_tiny(jax_published, gru4rec_tpu.GRU4RecConfig, monkeypatch, tiny_paramfile)
    out_t, out_j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert reproduce_published.main(["tiny", train, test, "--tol", "0.2", "--out", out_t,
                                     "-d", "cpu"]) == 0
    assert jax_published.main(["tiny", train, test, "--tol", "0.2", "--out", out_j]) == 0
    rep_t, rep_j = json.load(open(out_t)), json.load(open(out_j))
    assert _report_keys(rep_t) == _report_keys(rep_j)
    assert rep_t["pass"] is True and len(rep_t["metrics"]) == 8
    for m in rep_t["metrics"]:
        assert m["pass"] is True and m["rel_err"] <= 0.2


def test_published_fail_exit_status(tsvs, tiny_paramfile, tmp_path, monkeypatch, capsys):
    train, test = tsvs
    _patch_tiny(reproduce_published, GRU4RecConfig, monkeypatch,
                tiny_paramfile, mrr={1: 0.01, 5: 0.01, 10: 0.01, 20: 0.01})
    out = str(tmp_path / "rep.json")
    assert reproduce_published.main(["tiny", train, test, "--tol", "0.05", "--out", out,
                                     "-d", "cpu"]) == 1
    assert "PARITY FAIL" in capsys.readouterr().out
    rep = json.load(open(out))
    assert rep["pass"] is False
    assert any(not m["pass"] for m in rep["metrics"])


@pytest.mark.parametrize("mesh", [None, "1x1"])
def test_published_cutoff_subset(mesh, tsvs, tiny_paramfile, tmp_path, monkeypatch):
    """``--cutoffs 1 20`` gives JAX's metric order, on one device and on a
    1x1 mesh in this process."""
    train, test = tsvs
    _patch_tiny(reproduce_published, GRU4RecConfig, monkeypatch,
                tiny_paramfile)
    out = str(tmp_path / "rep.json")
    args = ["tiny", train, test, "--tol", "0.2", "--out", out, "--cutoffs", "1", "20",
            "-d", "cpu"]
    assert reproduce_published.main(args + (["--mesh", mesh] if mesh else [])) == 0
    rep = json.load(open(out))
    assert [m["metric"] for m in rep["metrics"]] == [
        "recall@1", "recall@20", "mrr@1", "mrr@20"]


@pytest.mark.parametrize("argv", [["--cutoffs"], ["--cutoffs", "3"], ["--mesh", "2x2"]])
def test_published_rejects_bad_arguments(argv, tsvs):
    """A bare ``--cutoffs`` and an unpublished cutoff are argument errors; a
    mesh of four ranks outside torchrun exits before training."""
    train, test = tsvs
    with pytest.raises(SystemExit) as exc:
        reproduce_published.main(["retailrocket", train, test, "-d", "cpu"] + argv)
    assert exc.value.code != 0


def test_rsc15_pass_and_report_keys_match_jax(jax_rsc15, tsvs, tmp_path, monkeypatch):
    train, test = tsvs
    expected = {"recall@20": 1.0, "mrr@20": 1.0}
    monkeypatch.setattr(run_rsc15, "CONFIGS", _tiny_configs(expected))
    monkeypatch.setattr(jax_rsc15, "CONFIGS", _tiny_configs(expected))
    out_t, out_j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert run_rsc15.main([train, test, "--tol", "0.2", "--out", out_t, "-d", "cpu"]) == 0
    assert jax_rsc15.main([train, test, "--tol", "0.2", "--out", out_j]) == 0
    rep_t, rep_j = json.load(open(out_t)), json.load(open(out_j))
    assert sorted(rep_t) == sorted(rep_j)
    assert [sorted(e) for e in rep_t["results"]] == [sorted(e) for e in rep_j["results"]]
    (entry,) = rep_t["results"]
    assert entry["pass"] is True and entry["fit_seconds"] > 0
    assert set(entry["rel_err"]) == set(expected)
    assert 0 <= entry["measured"]["recall@20"] <= 1


def test_rsc15_fail_exit_status_and_subset(tsvs, tmp_path, monkeypatch):
    train, test = tsvs
    cfgs = _tiny_configs({"recall@20": 0.123, "mrr@20": 0.9})
    cfgs.append(("never-run", {"invalid": True}, {}))  # would crash if run
    monkeypatch.setattr(run_rsc15, "CONFIGS", cfgs)
    out = str(tmp_path / "rep.json")
    assert run_rsc15.main([train, test, "--tol", "0.01", "--configs", "0", "--out", out,
                           "-d", "cpu"]) == 1
    rep = json.load(open(out))
    assert rep["pass"] is False
    assert [e["config"] for e in rep["results"]] == ["tiny"]


@pytest.mark.parametrize("configs", [["3"], ["-1"], ["0", "7"]])
def test_rsc15_rejects_out_of_range_configs(configs, tsvs):
    train, test = tsvs
    with pytest.raises(SystemExit) as exc:
        run_rsc15.main([train, test, "-d", "cpu", "--configs"] + configs)
    assert exc.value.code != 0


def test_preprocess_writes_the_jax_examples_tsvs(tmp_path):
    """The raw-click generator of ``tests/test_preprocess.py``."""
    rng = np.random.RandomState(4)
    base = dt.datetime(2014, 4, 1)
    rows = []
    for s in range(400):
        day = rng.randint(10) if rng.rand() > 0.2 else 9
        t0 = base + dt.timedelta(days=int(day), seconds=int(rng.randint(80000)))
        for e in range(rng.randint(1, 7)):
            ts = t0 + dt.timedelta(seconds=e)
            rows.append((s, ts.strftime("%Y-%m-%dT%H:%M:%S.%fZ")[:23] + "Z",
                         int(rng.zipf(1.4) % 60)))
    raw = tmp_path / "yoochoose-clicks.dat"
    pd.DataFrame(rows).to_csv(raw, header=False, index=False)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    preprocess.main(str(raw), str(tmp_path / "port"))
    _load("rsc15", "preprocess.py").main(str(raw), str(tmp_path / "jax"))
    names = ["rsc15_train_full.txt", "rsc15_test.txt", "rsc15_train_tr.txt",
             "rsc15_train_valid.txt"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(names)
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / n, tmp_path / "jax" / n, shallow=False), n
        assert len(pd.read_csv(tmp_path / "port" / n, sep="\t")) > 0, n


def test_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(quickstart_synthetic, "N_TRAIN_SESSIONS", 300)
    monkeypatch.setattr(quickstart_synthetic, "N_TEST_SESSIONS", 40)
    monkeypatch.setattr(quickstart_synthetic, "CONFIG",
                        {**quickstart_synthetic.CONFIG, "layers": [32], "n_sample": 64,
                         "n_epochs": 2})
    assert quickstart_synthetic.main(["-d", "cpu"]) == 0
    out = capsys.readouterr().out
    for c in (1, 5, 20):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"Recall@{c}:"))
        recall, mrr = float(line.split()[1]), float(line.split()[3])
        assert 0.0 <= mrr <= recall <= 1.0
    assert "top-3 next items for two live sessions:" in out
    table = out.split("top-3 next items for two live sessions:")[1].split()
    assert table[:2] == ["0", "1"] and sum(t.startswith("item_") for t in table) == 6
