"""The port's benchmark harnesses (``gru4rec_tpu_torch/bench.py``,
``gru4rec_tpu_torch/bench_scaling.py``) against the JAX package's
``bench.py`` and ``bench_scaling.py``, on the CPU:

* the synthetic frames equal the JAX harnesses' bit for bit (every column
  and dtype);
* the flagship configuration and the per-width configurations equal the
  JAX harnesses' on every field (the per-width literals read from
  ``bench_scaling.py``'s source with ``ast``);
* the result lines have the keys of the ``json.dumps`` dicts in the JAX
  harnesses' ``main``, in their order, read from their source with ``ast``,
  and the same constant values;
* both packages ``fit`` the flagship configuration (float32 compute and
  state) on a cut of the bench's frame for 2 epochs: equal steps and events
  per epoch, losses within rtol 1e-4 (``tests/test_torch_slice.py``'s
  tolerance for ``fit``), the port fed the JAX package's negative draws;
* the epoch-1 child's function builds the schedule builder into the build
  directory it is given, and nowhere else;
* ``python -m gru4rec_tpu_torch.bench_scaling --device cpu --ranks 2`` at a
  small size prints the width-1 and width-2 rows (gloo ranks under
  ``torch.distributed.run``), and the width-2 mesh ``fit`` counts the global
  events of a single-device ``fit`` at batch 160.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gru4rec_tpu  # noqa: E402
from gru4rec_tpu.ops.sampling import draw_negatives as jax_draw_negatives  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch import bench as tbench  # noqa: E402
from gru4rec_tpu_torch import bench_scaling as tscaling  # noqa: E402
from gru4rec_tpu_torch.data import _native_scheduler  # noqa: E402
from gru4rec_tpu_torch.ops.kernels import build  # noqa: E402
from gru4rec_tpu_torch.ops.sampling import build_alias_table  # noqa: E402
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(REPO, "bench.py")
JAX_SCALING = os.path.join(REPO, "bench_scaling.py")
CUT_SESSIONS = 400     # the fit comparison's cut of the bench frame
SCALING_EVENTS = 3000  # the gloo scaling run's frame
SCALING_EPOCHS = 2
SCALING_TIMEOUT = 600  # seconds for the whole scaling run


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load(JAX_BENCH, "jax_bench_harness")
jscaling = _load(JAX_SCALING, "jax_bench_scaling_harness")


def _function(path, name):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name]
    return fn


def _dumped_dict(path):
    """The one dict literal that ``main`` of ``path`` passes to ``json.dumps``."""
    dicts = [n.args[0] for n in ast.walk(_function(path, "main"))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "dumps" and n.args and isinstance(n.args[0], ast.Dict)]
    (d,) = dicts
    return d


def _keys(d):
    return [k.value for k in d.keys]


def _constants(d):
    return {k.value: v.value for k, v in zip(d.keys, d.values) if isinstance(v, ast.Constant)}


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_data_equals_the_jax_bench(seed):
    got, want = tbench.synth_data(seed), jbench.synth_data(seed)
    assert list(got.dtypes) == list(want.dtypes) == [np.int64] * 3
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (tbench.N_ITEMS, tbench.N_EVENTS_TARGET, tbench.MEAN_SESSION_LEN,
            tbench.BASELINE_EVENTS_PER_S) == (jbench.N_ITEMS, jbench.N_EVENTS_TARGET,
                                              jbench.MEAN_SESSION_LEN,
                                              jbench.BASELINE_EVENTS_PER_S)


def test_scaling_synth_data_equals_the_jax_bench_scaling():
    got, want = tscaling.synth_data(20_000), jscaling.synth_data(20_000)
    assert list(got.dtypes) == list(want.dtypes)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (tscaling.N_ITEMS, tscaling.PER_DEVICE_BATCH) == (jscaling.N_ITEMS,
                                                             jscaling.PER_DEVICE_BATCH)


def test_flagship_cfg_equals_the_jax_bench():
    got, want = tbench._flagship_cfg().to_dict(), jbench._flagship_cfg().to_dict()
    assert set(got) == set(want), set(got) ^ set(want)
    assert got == want


def _scaling_literals(d):
    """``bench_scaling.py::main``'s ``GRU4RecConfig(...)`` keywords at width
    ``d`` (``B`` there is ``PER_DEVICE_BATCH * d``)."""
    (call,) = [n for n in ast.walk(_function(JAX_SCALING, "main"))
               if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "GRU4RecConfig"]
    return {kw.arg: (jscaling.PER_DEVICE_BATCH * d if isinstance(kw.value, ast.Name)
                     and kw.value.id == "B" else ast.literal_eval(kw.value))
            for kw in call.keywords}


@pytest.mark.parametrize("d", [1, 2])
def test_width_cfg_equals_the_jax_bench_scaling(d):
    literals = _scaling_literals(d)
    assert literals["batch_size"] == 80 * d and literals["chunk_size"] == 256
    assert literals["n_epochs"] == tscaling.N_EPOCHS == 3
    want = gru4rec_tpu.GRU4RecConfig(**literals).to_dict()
    got = tscaling.width_cfg(d).to_dict()
    assert set(got) == set(want), set(got) ^ set(want)
    assert got == want


def test_result_lines_have_the_jax_harnesses_keys():
    want = _dumped_dict(JAX_BENCH)
    line = tbench.headline(81_400.0, 7.0, [7.0, 7.5], 60.0, "NVIDIA H100 80GB HBM3")
    assert list(line) == _keys(want) == [
        "metric", "value", "unit", "vs_baseline", "baseline_hw", "bench_hw",
        "epoch1_warm_s", "epoch1_warm_runs_s", "epoch1_cold_s"]
    for k, v in _constants(want).items():
        assert line[k] == v, k
    assert line["vs_baseline"] == 1.0 and line["epoch1_warm_runs_s"] == [7.0, 7.5]
    want = _dumped_dict(JAX_SCALING)
    row = tscaling.row(2, 1234.56)
    assert list(row) == _keys(want) == ["devices", "batch", "value", "unit"]
    assert row == {"devices": 2, "batch": 160, "value": 1234.6, "unit": "events/s"}
    assert {k: row[k] for k in _constants(want)} == _constants(want)


def test_flagship_fit_matches_the_jax_bench(monkeypatch):
    """Both packages' flagship ``fit`` (float32 compute and state) on a cut of
    the bench frame, 2 epochs; the port draws JAX's negatives: JAX draws one
    block per chunk padded to ``chunk_size`` steps, at the step count of the
    padded chunks before it."""
    data = tbench.synth_data()
    data = data[data["SessionId"] < CUT_SESSIONS].copy()
    f32 = dict(compute_dtype="float32", opt_state_dtype="float32")
    m_j = gru4rec_tpu.GRU4Rec(dataclasses.replace(jbench._flagship_cfg(), **f32))
    m_j.fit(data, n_epochs=2)
    cfg = dataclasses.replace(tbench._flagship_cfg(), **f32)
    pop = data.groupby("ItemId").size().reindex(m_j.itemidmap.index.values).values
    packed = build_alias_table(pop, cfg.sample_alpha)
    k1 = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 1)
    C, calls = cfg.chunk_size, []

    def injected(gen, samp1, n_steps, n_sample, n_items, alpha, sampler):
        assert n_steps <= C and np.array_equal(samp1.numpy(), packed)
        neg = jax_draw_negatives(jax.random.fold_in(k1, len(calls) * C), jnp.asarray(packed),
                                 C, n_sample, n_items, alpha, sampler)
        calls.append(n_steps)
        return torch.from_numpy(np.array(neg[:n_steps]))

    monkeypatch.setattr(tstep, "draw_negatives", injected)
    m_t = gru4rec_tpu_torch.GRU4Rec(cfg, device="cpu")
    m_t.fit(data, n_epochs=2)
    assert sum(calls) == sum(e["steps"] for e in m_t.epoch_stats)
    assert [(e["steps"], e["events"]) for e in m_t.epoch_stats] == \
        [(e["steps"], e["events"]) for e in m_j.epoch_stats]
    np.testing.assert_allclose([e["loss"] for e in m_t.epoch_stats],
                               [e["loss"] for e in m_j.epoch_stats], rtol=1e-4)
    assert tbench.warm_events_per_s(m_t.epoch_stats) > 0


def test_epoch1_builds_into_the_given_directory_only(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the schedule builder falls back to numpy")
    monkeypatch.delenv("GRU4REC_TPU_NO_NATIVE", raising=False)
    # a fresh process's state: nothing loaded yet (restored after the test)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(_native_scheduler, "_fn", None)
    outs = []
    command = build._command

    def recorded(name, out):
        outs.append((name, out))
        return command(name, out)

    monkeypatch.setattr(build, "_command", recorded)
    data = tbench.synth_data()
    data = data[data["SessionId"] < 200]
    _native_scheduler.reset_calls()
    seconds = tbench.epoch1(str(tmp_path), data, device="cpu")
    assert seconds > 0 and _native_scheduler.calls == 1
    assert [n for n, _ in outs] == ["scheduler"]
    assert all(os.path.dirname(o) == str(tmp_path) for _, o in outs)
    (lib,) = os.listdir(tmp_path)
    assert re.fullmatch(r"scheduler-[0-9a-f]{16}\.so", lib)


def test_scaling_runs_widths_1_and_2_on_gloo_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "GRU4REC_TPU_NAN_DUMP": ""}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    # output to files, not pipes: the ranks wait on each other in
    # collectives, so a full pipe would stall them all
    with open(tmp_path / "out", "w") as out, open(tmp_path / "err", "w") as err:
        p = subprocess.Popen(
            [sys.executable, "-m", "gru4rec_tpu_torch.bench_scaling", "--device", "cpu",
             "--ranks", "2", "--events", str(SCALING_EVENTS), "--epochs",
             str(SCALING_EPOCHS)], env=env, stdout=out, stderr=err, cwd=REPO)
        try:
            rc = p.wait(timeout=SCALING_TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    log = (tmp_path / "err").read_text()
    assert rc == 0, log[-5000:]
    rows = [json.loads(ln) for ln in (tmp_path / "out").read_text().splitlines()]
    assert [(r["devices"], r["batch"], r["unit"]) for r in rows] == \
        [(1, 80, "events/s"), (2, 160, "events/s")], rows
    assert all(r["value"] > 0 for r in rows)
    fits = {f["devices"]: f for f in (json.loads(ln)["fit"] for ln in log.splitlines()
                                       if ln.startswith('{"fit"'))}
    assert sorted(fits) == [1, 2]
    # the mesh fit's stats on rank 0 count every rank's events
    single = gru4rec_tpu_torch.GRU4Rec(tscaling.width_cfg(2), device="cpu")
    single.fit(tscaling.synth_data(SCALING_EVENTS), n_epochs=SCALING_EPOCHS)
    assert [(e["steps"], e["events"]) for e in fits[2]["epochs"]] == \
        [(e["steps"], e["events"]) for e in single.epoch_stats]
    assert fits[1]["epochs"][0]["events"] == single.epoch_stats[0]["events"]
    assert all(n == 0 for f in fits.values() for n in f["launches"].values())
