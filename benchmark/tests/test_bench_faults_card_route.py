"""``correct`` comes out false where a fault is planted in the evaluation
step's card route: full-catalog ranking through the ranking kernel
(``ops/kernels/score_rank.py::score_rank_cuda``), whose counts
``evaluation.ranks_from_counts`` turns into ranks. ``test_bench_faults.py``
plants its evaluation faults in ``evaluation.compute_ranks``, which only
the CPU's full-catalog route calls.

On the CPU the route is forced (``evaluation._on_card`` patched, the
kernel's wrapper replaced by its plain version); on the card (``cuda``)
it is the route the cell times, kernel included."""

import time

import pytest
import torch

from benchmark import run as brun
from benchmark.jobs import common
from benchmark.tests.tiny import tiny_cell


def _run(cell, device, seed=11):
    r = common.Run(seed=seed, seconds=0.5, trace=False, device=device,
                   t_start=time.perf_counter())
    return brun.result(cell, r, brun.execute(cell, r), device.type)


def _plant(monkeypatch, fault):
    """Every ``evaluate`` call's ranks broken where the card route makes
    them; ``engaged`` counts the calls that reached it."""
    import gru4rec_tpu_torch.eval.evaluation as evaluation

    ranks = evaluation.ranks_from_counts
    engaged = []

    def broken(gt, second, mode):
        engaged.append(mode)
        r = ranks(gt, second, mode)
        if fault == "half":
            return torch.where(torch.arange(len(r), device=r.device) >= len(r) // 2,
                               float("inf"), r)
        if fault == "token":
            return r + 1
        return r

    monkeypatch.setattr(evaluation, "ranks_from_counts", broken)
    return engaged


def _force_route(monkeypatch):
    import gru4rec_tpu_torch.eval.evaluation as evaluation
    from gru4rec_tpu_torch.ops.kernels import score_rank

    monkeypatch.setattr(evaluation, "_on_card", lambda t: True)
    monkeypatch.setattr(score_rank, "score_rank_cuda", score_rank.score_rank_plain)


@pytest.mark.parametrize("fault", ["none", "half", "token"])
def test_card_route_with_a_fault_is_not_correct(fault, monkeypatch):
    _force_route(monkeypatch)
    engaged = _plant(monkeypatch, fault)
    line = _run(tiny_cell("rees46.eval"), torch.device("cpu"))
    assert engaged
    assert line["correct"] is (fault == "none"), line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["none", "half", "token"])
def test_card_route_with_a_fault_is_not_correct_on_the_card(fault, card, monkeypatch):
    engaged = _plant(monkeypatch, fault)
    line = _run(tiny_cell("rees46.eval"), card)
    assert engaged
    assert line["correct"] is (fault == "none"), line["checks"]
