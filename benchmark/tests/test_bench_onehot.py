"""The one-hot training cell (``rsc15.train.onehot``, kind ``fit_onehot``)
at a tiny size on the CPU (``tiny_onehot.py``): its configuration is the
paramfile it names; its job agrees with the reference, the sampler check
included; its sampler faults fail their limit; whole runs with the timed
path broken underneath come out not correct; and a traced run records
what the K4 readers need."""

import os
import time

import pytest
import torch

from benchmark import control, spec
from benchmark import run as brun
from benchmark.jobs import common
from benchmark.tests.tiny_onehot import tiny_cell

CELL = "rsc15.train.onehot"


def _run(cell, seed=11, trace=False):
    r = common.Run(seed=seed, seconds=0.5, trace=trace, device=torch.device("cpu"),
                   t_start=time.perf_counter())
    return brun.result(cell, r, brun.execute(cell, r), "cpu")


def test_config_is_the_paramfile():
    from gru4rec_tpu_torch import GRU4RecConfig

    config = spec.cell(CELL).config
    published = GRU4RecConfig.from_parameter_file(
        os.path.join(spec.ROOT, "param_samples", "rsc15_bpr-max.py"))
    for k, v in config["params"].items():
        assert getattr(published, k) == v, k
    for k, v in config["program"].items():
        assert getattr(GRU4RecConfig(), k) == v, k  # the defaults the paramfile leaves


def test_job_agrees_with_the_reference():
    line = _run(tiny_cell(n_sample=1024))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        assert c["value"] <= (0.03 if name == "sampler_gap" else 1e-5), (name, c)


def test_sampler_faults_fail_their_limit():
    cell = tiny_cell(n_sample=1024)
    r = common.Run(seed=5, seconds=0.5, trace=False, device=torch.device("cpu"))
    read = {name: n["sampler_gap"] for name, n in control.sampler_variants(cell, r)}
    # sample_alpha 0: the uniform draw is the stated one, and no fault
    assert read["sampler_uniform"] == read["sampler"]
    faults = [read[f] for f in ("sampler_alpha_low", "sampler_alpha_high")]
    assert min(faults) > cell.limits["sampler_gap"], read
    assert max(read["sampler"], read["sampler_control"]) < cell.limits["sampler_gap"], read


def _half_loss(get_loss):
    def make(*a, **kw):
        fn = get_loss(*a, **kw)

        def half(yhat, M, row_valid, col_valid, *rest):
            kept = row_valid.clone()
            kept[len(kept) // 2:] = False
            return 2.0 * fn(yhat, M, kept, col_valid, *rest)

        return half

    return make


@pytest.mark.parametrize("fault", ["unchanged", "input_table", "half", "token", "sampler"])
def test_training_run_with_a_fault_is_not_correct(fault, monkeypatch):
    import gru4rec_tpu_torch.models.gru4rec as program
    import gru4rec_tpu_torch.train.step as step
    from gru4rec_tpu_torch.train.optimizers import Optimizer

    if fault in ("unchanged", "input_table"):
        if fault == "unchanged":
            monkeypatch.setattr(Optimizer, "apply_dense", lambda self, p, g, st: (p, st))
        update = Optimizer.apply_sparse

        def sparse(self, table, idx, g, st, sr_seed=None):
            if fault == "unchanged" or table.shape[1] % 128:  # Wx0 left as it was
                return table, st
            return update(self, table, idx, g, st, sr_seed)

        monkeypatch.setattr(Optimizer, "apply_sparse", sparse)
    elif fault == "half":
        monkeypatch.setattr(step, "get_loss", _half_loss(step.get_loss))
    elif fault == "sampler":
        draw = step.draw_negatives
        monkeypatch.setattr(step, "draw_negatives", lambda *a, **kw: draw(*a, **kw) // 2)
    else:
        build = program.build_schedule

        def shifted(*a, **kw):
            s = build(*a, **kw)
            s.out_idx = (s.out_idx + 1) % 300
            return s

        monkeypatch.setattr(program, "build_schedule", shifted)
    line = _run(tiny_cell(n_sample=1024))
    assert line["correct"] is False, line["checks"]


def test_traced_run_records_the_k4_inputs():
    """A chunk of 64 steps, so that the window has a second chunk to trace:
    the CPU runs no kernel, so no K4 reading, but the job's record of the
    traced steps is whole."""
    from benchmark.jobs import fit_onehot

    cell = tiny_cell()
    cell.config["program"]["chunk_size"] = 64
    cell.traffic["traced_steps"] = 16
    r = common.Run(seed=3, seconds=0.5, trace=True, device=torch.device("cpu"),
                   t_start=time.perf_counter())
    out = fit_onehot.run(cell, r)
    k4 = out["layer"]["k4"]
    assert out["layer"]["steps"] == len(k4["valid"]) == len(k4["distinct_rows"]) == 16
    assert k4["positions"] == 8 and k4["d"] == 48 and k4["adapt"] == "adagrad"
    assert k4["state"] == {"acc": [48, 4], "velocity": [48, 2]}
    assert all(0 < u <= v <= 8 for u, v in zip(k4["distinct_rows"], k4["valid"]))
    line = brun.result(cell, r, out, "cpu")
    assert line["metrics"] == {} and "breakdown" in line
