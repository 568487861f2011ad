"""The one-hot configuration of the benchmark (``rsc15``: GRU4Rec's original
one-hot input, two row-sparse item tables) held to its plain reference on
the CPU, at a tiny size (300 items, GRU-16, batch 8, 64 negatives):

* the program's training steps, run eagerly through the ``fit_onehot``
  job's own path (``benchmark/jobs/fit_onehot.py``: ``GRU4Rec.fit`` on the
  benchmark's weights, the first steps one per chunk call), agree with
  ``benchmark/reference/gru4rec_onehot.py`` within the cell's limits on
  seeded random weights;
* the reference in float8, half of the batch left out and every target one
  item on (``benchmark/control_onehot.py``) each fall outside a limit;
* the reference's row update of the 48-wide input table is the program's
  plain K4 update;
* the benchmark's one-hot weights have the program's layout and padding;
* the reference, the weights and the byte count load nothing of the
  program and nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from benchmark import control_onehot, spec  # noqa: E402
from benchmark import run as brun  # noqa: E402
from benchmark.jobs import common  # noqa: E402
from benchmark.reference import gru4rec as ref  # noqa: E402
from benchmark.reference import gru4rec_onehot as ref_onehot  # noqa: E402
from benchmark.tests.tiny_onehot import SIZE, tiny_cell  # noqa: E402
from benchmark.yardstick import weights, weights_onehot  # noqa: E402

CPU = torch.device("cpu")
SEEDS = [5, 2**31 + 7, 2**33 + 1]
COMPARED = ("loss_gap", "grad_gap", "change_gap")


def _run(cell, seed):
    r = common.Run(seed=seed, seconds=0.5, trace=False, device=CPU,
                   t_start=time.perf_counter())
    return brun.result(cell, r, brun.execute(cell, r), "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_program_steps_agree_with_the_reference(seed):
    cell = tiny_cell()
    line = _run(cell, seed)
    assert line["failed"] == 0 and line["attempted"] > 0
    for name in COMPARED:
        c = line["checks"][name]
        # the same bfloat16 roundings in the same order on the CPU: the
        # program and the reference differ by float32 summation order alone
        assert c["value"] <= min(1e-5, c["limit"]), (name, c)
    # 64 negatives a step are too few for the sampler's 16 bins to read the
    # sampler rather than its noise (benchmark/tests/test_bench_onehot.py
    # reads it at 1,024); the draw lies in the catalog
    assert np.isfinite(line["checks"]["sampler_gap"]["value"])
    launches = line["info"]["launches_by_mode"]
    assert set(launches) == {"sparse_update", "mixed_mm"}  # the CPU counts no launch


@pytest.mark.parametrize("seed", SEEDS)
def test_control_and_faults_fall_outside_a_limit(seed):
    cell = tiny_cell()
    r = common.Run(seed=seed, seconds=0.5, trace=False, device=CPU)
    seen = set()
    for name, numbers in control_onehot.train_variants(cell, r):
        seen.add(name)
        assert any(numbers[k] > cell.limits[k] for k in COMPARED), (name, numbers)
    assert seen == {"control", "half", "token"}


def test_row_update_of_the_input_table_is_the_programs():
    from gru4rec_tpu_torch.ops.kernels import sparse_update
    from gru4rec_tpu_torch.train.optimizers import SENTINEL, make_optimizer

    cell = tiny_cell()
    cfg = {**cell.config["params"], **cell.config["program"]}
    opt = make_optimizer(common.program_config(cell, 1))
    h = SIZE["layers"][0]
    d = 3 * h  # Wx0's width: no multiple of 128, the K4 mode on the card
    assert sparse_update.mode_of(opt.adapt, d, False) == "K4"
    g = torch.Generator().manual_seed(4)
    table = torch.randn((40, d), generator=g)
    st = opt.init_state(table, sparse=True)
    assert st["acc"].dtype == torch.float32 and st["velocity"].dtype == torch.bfloat16
    for k in st:
        st[k].copy_((torch.rand(st[k].shape, generator=g) * 0.1).to(st[k].dtype))
    idx = torch.tensor([3, 7, 3, 11, SENTINEL, 7, 3], dtype=torch.int32)
    rows_g = torch.randn((7, d), generator=g)
    params = {"Wx": table.clone(), "Wy": torch.zeros((40, 8)), "Wh": torch.zeros((h, h)),
              "Wrz": torch.zeros((h, 2 * h)), "Bh": torch.zeros(3 * h)}
    trainer = ref_onehot.Trainer(cfg, params, np.ones(40), ref.round_bf16, CPU)
    trainer.acc["Wx"].copy_(st["acc"])
    trainer.vel["Wx"].copy_(st["velocity"])
    opt.apply_sparse_plain(table, idx, rows_g, st)
    rows = torch.tensor([3, 7, 11])
    dense = torch.zeros((40, d))
    for i, r in zip(idx.tolist(), rows_g):
        if i != SENTINEL:
            dense[i] += r
    trainer._adagrad_table("Wx", rows, dense[rows])
    torch.testing.assert_close(trainer.P["Wx"], table, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(trainer.acc["Wx"], st["acc"], rtol=1e-6, atol=1e-7)
    assert trainer.vel["Wx"].dtype == torch.bfloat16
    torch.testing.assert_close(trainer.vel["Wx"].float(), st["velocity"].float())


@pytest.mark.parametrize("n_items", [SIZE["n_items"], spec.cell("rsc15.train.onehot")
                                     .config["n_items"]])
def test_weights_have_the_programs_layout(n_items):
    from gru4rec_tpu_torch.models import gru

    cell = tiny_cell()
    cell.config["n_items"] = n_items
    cfg = common.program_config(cell, 3)
    assert gru.input_mode(cfg) == "onehot"
    want = gru.init_params_numpy(cfg, n_items)
    got = weights_onehot.make_params(cell.config, 11, CPU)
    assert set(got) == set(want)
    for k, v in want.items():
        mats = v if isinstance(v, list) else [v]
        gots = got[k] if isinstance(got[k], list) else [got[k]]
        assert [tuple(m.shape) for m in mats] == [tuple(m.shape) for m in gots], k
        assert all(m.dtype == torch.float32 for m in gots), k
    h = SIZE["layers"][0]
    Wx, Wy = got["Wx"][0], got["Wy"]
    # Glorot's width of a (n_items, h) block, padded rows zero
    width = np.sqrt(6.0 / (n_items + h))
    assert 0.9 * width < float(Wx[:n_items].abs().max()) <= width
    assert not Wx[n_items:].any() and not Wy[n_items:].any() and not Wy[:, h + 1:].any()
    assert not got["Bh"][0].any()
    bias = Wy[:n_items, h]
    assert float(bias[0]) == 0.0 and bool((bias[1:] < 0).all()) and bool((bias.diff() <= 0).all())
    again = weights.flat(weights_onehot.make_params(cell.config, 11, CPU))
    assert all(torch.equal(v, again[k]) for k, v in weights.flat(got).items())


def test_weights_refuse_another_input_mode():
    cell = tiny_cell()
    cell.config["params"]["constrained_embedding"] = True
    with pytest.raises(NotImplementedError):
        weights_onehot.make_params(cell.config, 1, CPU)


def test_the_reference_loads_nothing_of_the_program_or_jax():
    probe = ("import json, sys\n"
             "import benchmark.reference.gru4rec_onehot, benchmark.yardstick.weights_onehot\n"
             "import benchmark.yardstick.row_bytes\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    names = set(json.loads(out.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "gru4rec_tpu", "gru4rec_tpu_torch"}
