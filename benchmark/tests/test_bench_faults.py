"""``correct`` comes out false where it must.

The control (the reference in float8 in the program's place) and the
planted faults of ``benchmark/control.py``, at a tiny size, each fail one
of the cell's limits. And whole runs of each cell on the CPU, with the
timed path broken underneath, come out not correct: a step that leaves
its state unchanged, half of the batch left out (the mean over the rest),
an answer altered where it is produced (a target, a rank, a served item,
the negatives' distribution), and a lane state not carried."""

import time

import pytest
import torch

from benchmark import control
from benchmark import run as brun
from benchmark.jobs import common
from benchmark.tests.tiny import tiny_cell


def _run(cell, seed=11):
    r = common.Run(seed=seed, seconds=0.5, trace=False, device=torch.device("cpu"),
                   t_start=time.perf_counter())
    return brun.result(cell, r, brun.execute(cell, r), "cpu")


def _fails(cell, numbers):
    return any(v > cell.limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("workload", ["retailrocket.train", "rees46.train", "rees46.eval",
                                      "retailrocket.serve"])
def test_control_and_planted_faults_fail_a_limit(workload):
    cell = tiny_cell(workload)
    r = common.Run(seed=5, seconds=0.5, trace=False, device=torch.device("cpu"))
    kind = cell.traffic["kind"]
    variants = {"fit": lambda: control.train_variants(cell, r),
                "evaluate": lambda: control.eval_variants(cell, r),
                "serve": lambda: control.serve_variants(cell, r, 40)}[kind]()
    seen = set()
    for name, numbers in variants:
        seen.add(name)
        assert _fails(cell, numbers), (name, numbers, cell.limits)
    assert {"control", "half", "token"} <= seen


def _half_loss(get_loss):
    def make(*a, **kw):
        fn = get_loss(*a, **kw)

        def half(yhat, M, row_valid, col_valid, *rest):
            kept = row_valid.clone()
            kept[len(kept) // 2:] = False
            return 2.0 * fn(yhat, M, kept, col_valid, *rest)

        return half

    return make


@pytest.mark.parametrize("workload", ["retailrocket.train", "rees46.train"])
def test_sampler_faults_fail_their_limit(workload):
    cell = tiny_cell(workload)
    r = common.Run(seed=5, seconds=0.5, trace=False, device=torch.device("cpu"))
    read = {name: n["sampler_gap"] for name, n in control.sampler_variants(cell, r)}
    faults = [read[f] for f in ("sampler_uniform", "sampler_alpha_low", "sampler_alpha_high")]
    assert min(faults) > cell.limits["sampler_gap"], read
    assert read["sampler"] < min(faults) and read["sampler_control"] < min(faults), read


@pytest.mark.parametrize("fault", ["unchanged", "half", "token", "sampler"])
@pytest.mark.parametrize("workload", ["retailrocket.train", "rees46.train"])
def test_training_run_with_a_fault_is_not_correct(workload, fault, monkeypatch):
    import gru4rec_tpu_torch.models.gru4rec as program
    import gru4rec_tpu_torch.train.step as step
    from gru4rec_tpu_torch.train.optimizers import Optimizer

    if fault == "unchanged":
        monkeypatch.setattr(Optimizer, "apply_dense", lambda self, p, g, st: (p, st))
        monkeypatch.setattr(Optimizer, "apply_sparse",
                            lambda self, table, idx, g, st, sr_seed=None: (table, st))
    elif fault == "half":
        monkeypatch.setattr(step, "get_loss", _half_loss(step.get_loss))
    elif fault == "sampler":
        table = program.build_alias_table
        monkeypatch.setattr(program, "build_alias_table", lambda pop, alpha: table(pop, 0.0))
    else:
        build = program.build_schedule

        def shifted(*a, **kw):
            s = build(*a, **kw)
            s.out_idx = (s.out_idx + 1) % 300
            return s

        monkeypatch.setattr(program, "build_schedule", shifted)
    line = _run(tiny_cell(workload))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["half", "token"])
def test_evaluation_run_with_a_fault_is_not_correct(fault, monkeypatch):
    import gru4rec_tpu_torch.eval.evaluation as evaluation

    ranks = evaluation.compute_ranks

    def broken(others, target, mode):
        r = ranks(others, target, mode)
        if fault == "half":
            return torch.where(torch.arange(len(r)) >= len(r) // 2, float("inf"), r)
        return r + 1

    monkeypatch.setattr(evaluation, "compute_ranks", broken)
    line = _run(tiny_cell("rees46.eval"))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["state", "half", "token"])
def test_serving_run_with_a_fault_is_not_correct(fault, monkeypatch):
    import numpy as np

    from gru4rec_tpu_torch import GRU4Rec

    if fault == "state":
        build = GRU4Rec._build_predict_fn

        def stale(self, subset):
            step = build(self, subset)
            return lambda params, H, in_idx, *a: (list(H), step(params, H, in_idx, *a)[1])

        monkeypatch.setattr(GRU4Rec, "_build_predict_fn", stale)
    else:
        topk = GRU4Rec.predict_topk

        def broken(self, *a, **kw):
            items, scores = topk(self, *a, **kw)
            if fault == "half":
                items, scores = items.copy(), scores.copy()
                items[len(items) // 2:], scores[len(items) // 2:] = 0, 0.0
            else:
                items = np.asarray([(i + 1) % self.n_items for i in items.ravel()],
                                   dtype=object).reshape(items.shape)
            return items, scores

        monkeypatch.setattr(GRU4Rec, "predict_topk", broken)
    line = _run(tiny_cell("retailrocket.serve"))
    assert line["correct"] is False, line["checks"]
