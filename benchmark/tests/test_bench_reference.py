"""The plain reference held to the program on the CPU at tiny sizes: both
configurations' training steps (losses, gradients, the row-sparse K1 update
and the dense updates), evaluation and top-k, each through the cell's own
job, and the losses and the sampled-row update alone."""

import time

import numpy as np
import pytest
import torch

from benchmark import run as brun
from benchmark.jobs import common
from benchmark.reference import gru4rec as ref
from benchmark.tests.tiny import tiny_cell

CELLS = ["retailrocket.train", "rees46.train", "rees46.eval", "retailrocket.serve"]


def run_tiny(cell, seed=2**31 + 7, trace=False):
    r = common.Run(seed=seed, seconds=0.5, trace=trace, device=torch.device("cpu"),
                   t_start=time.perf_counter())
    return brun.result(cell, r, brun.execute(cell, r), "cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_job_agrees_with_the_reference(workload):
    line = run_tiny(tiny_cell(workload))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        # sampler_gap holds a draw against a distribution, not the program
        # against the reference: its noise at this size is a few percent
        assert c["value"] <= (0.03 if name == "sampler_gap" else 1e-5), (name, c)
    assert list(line)[-1] == "checks"


def test_evaluation_times_every_call():
    line = run_tiny(tiny_cell("rees46.eval"))
    n, *quantiles = line["info"]["call_s"]
    assert n == line["attempted"] == line["info"]["calls"] > 1
    assert 0 < quantiles[0] <= quantiles[1] <= quantiles[2] <= quantiles[3] <= quantiles[4]


@pytest.mark.parametrize("config", ["retailrocket", "rees46"])
def test_losses_are_the_programs(config):
    from gru4rec_tpu_torch.ops.activations import get_activation
    from gru4rec_tpu_torch.ops.losses import get_loss

    cfg = tiny_cell(f"{config}.train").config["params"]
    g = torch.Generator().manual_seed(3)
    scores = torch.randn((6, 6 + 10), generator=g)
    rows, cols = torch.ones(6, dtype=torch.bool), torch.ones(16, dtype=torch.bool)
    act = get_activation(cfg["final_act"])
    y = act(scores, cols)
    want = get_loss(cfg["loss"], 10, 0.0, cfg["bpreg"])(y, 6.0, rows, cols)
    got = ref.final_activation(cfg["final_act"], scores)
    got = ref.bpr_max(got, cfg["bpreg"]) if cfg["loss"] == "bpr-max" else ref.cross_entropy(got)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("config", ["retailrocket", "rees46"])
def test_row_update_is_the_programs(config):
    from gru4rec_tpu_torch.train.optimizers import SENTINEL, make_optimizer

    cell = tiny_cell(f"{config}.train")
    c = {**cell.config["params"], **cell.config["program"]}
    from benchmark.jobs.common import program_config

    opt = make_optimizer(program_config(cell, 1))
    g = torch.Generator().manual_seed(4)
    table = torch.randn((40, 8), generator=g)
    st = opt.init_state(table, sparse=True)
    for k in st:
        st[k].copy_((torch.rand(st[k].shape, generator=g) * 0.1).to(st[k].dtype))
    idx = torch.tensor([3, 7, 3, 11, SENTINEL, 7, 3], dtype=torch.int32)
    rows_g = torch.randn((7, 8), generator=g)
    params = {"Wy": table.clone(), **{k: torch.zeros(1) for k in ref.DENSE}}
    trainer = ref.Trainer(c, params, np.ones(40), ref.round_bf16, torch.device("cpu"))
    trainer.acc["Wy"].copy_(st["acc"])
    if "velocity" in st:
        trainer.vel["Wy"].copy_(st["velocity"])
    opt.apply_sparse_plain(table, idx, rows_g, st)
    rows = torch.tensor([3, 7, 11])
    dense = torch.zeros((40, 8))
    for i, r in zip(idx.tolist(), rows_g):
        if i != SENTINEL:
            dense[i] += r
    trainer._adagrad_rows(rows, dense[rows])
    torch.testing.assert_close(trainer.P["Wy"], table, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(trainer.acc["Wy"], st["acc"], rtol=1e-6, atol=1e-7)
    if "velocity" in st:
        assert trainer.vel["Wy"].dtype == st["velocity"].dtype == torch.bfloat16
        torch.testing.assert_close(trainer.vel["Wy"].float(), st["velocity"].float())


def test_trace_run_reads_every_per_layer_metric_it_can_on_the_cpu():
    cell = tiny_cell("retailrocket.serve")
    cell.traffic.update(traced_after=2, traced_calls=5)
    line = run_tiny(cell, trace=True)
    assert set(line["metrics"]) == {"serve.host_ms", "idle_share.serve"}
    assert line["device"]["window_s"] > 0 and "breakdown" in line
