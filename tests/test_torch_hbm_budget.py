"""``scripts/measure_hbm_budget_torch.py`` against the JAX package's
``scripts/measure_hbm_budget.py``, on the CPU.

* ``table``'s bytes: for each (adapt, opt_state_dtype) at two small
  catalogs, the port's parameter and optimizer-state bytes per item (the
  slope) equal the JAX script's ``state_bytes`` slope, and so do the fixed
  bytes: on one device neither package appends scratch rows to a table
  (JAX's per-shard scratch rows exist only in its mesh layout), and the
  optimizer state has the JAX layouts (``train/optimizers.py``);
* the probe's state (zeros in the real layout, grown from a decoy catalog)
  has the shapes and dtypes of a real initialisation, and its uniform alias
  table equals ``build_alias_table`` of a uniform popularity;
* ``table`` without a card prints one row per combination with the fixed
  buffers of a captured step "not measured".
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEMS = (1_024, 3_072)  # multiples of item_pad_multiple: exact slopes
COMBOS = [(a, d) for a in ("adagrad", "adam") for d in ("float32", "bfloat16", "bfloat16_sr")]


def _load(name):
    """``scripts/<name>`` as a module. Both packages are imported from this
    checkout first, and ``sys.path`` is restored after the script's own
    insertion, so every module the script reaches is this tree's."""
    import gru4rec_tpu.train.step  # noqa: F401
    import gru4rec_tpu_torch.train.step  # noqa: F401

    spec = importlib.util.spec_from_file_location(
        name.replace(".py", "_under_test"), os.path.join(REPO, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load("measure_hbm_budget_torch.py"), _load("measure_hbm_budget.py")


@pytest.mark.parametrize("adapt,osd", COMBOS)
def test_state_bytes_equal_the_jax_scripts(scripts, adapt, osd):
    port, jax_script = scripts
    (pa, oa), (pb, ob) = (port.state_bytes(n, adapt, osd) for n in ITEMS)
    (ja, ka), (jb, kb) = (jax_script.state_bytes(n, adapt, osd) for n in ITEMS)
    span = ITEMS[1] - ITEMS[0]
    assert (pb - pa) / span == (jb - ja) / span  # parameter bytes per item
    assert (ob - oa) / span == (kb - ka) / span  # optimizer-state bytes per item
    assert (pa, oa) == (ja, ka)  # fixed bytes too: no scratch rows on one device
    s = port.slopes(adapt, osd, ITEMS)
    assert s["param_bytes_per_item"] == (pb - pa) / span
    assert s["opt_bytes_per_item"] == (ob - oa) / span
    assert s["run_bytes_per_item"] == 12.0  # alias table (n, 2) int32 + logp0 float32


@pytest.mark.parametrize("adapt,osd", [COMBOS[0], COMBOS[2], COMBOS[5]])
def test_probe_state_has_the_real_layout(scripts, adapt, osd):
    port, _ = scripts
    from gru4rec_tpu_torch.train.step import init_train_state
    from gru4rec_tpu_torch.utils.cuda_graph import leaves

    n = 1_000
    cfg = port.make_cfg(n, adapt, osd)
    real = init_train_state(cfg, n, "cpu")
    probe = port.zeros_state(cfg, n, torch.device("cpu"))
    for tree in ("params", "opt_state", "H"):
        got, want = leaves(getattr(probe, tree)), leaves(getattr(real, tree))
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want], tree
        assert all(not t.any() for t in got)
    assert port.tree_bytes(probe.params) == port.tree_bytes(real.params)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_uniform_alias_table_is_build_alias_table(scripts, alpha):
    port, _ = scripts
    from gru4rec_tpu_torch.ops.sampling import build_alias_table

    for n in (1, 7, 500):
        assert np.array_equal(port.uniform_alias_table(n),
                              build_alias_table(np.ones(n, np.int64), alpha))


def test_table_without_a_card_reports_the_fixed_buffers_not_measured(scripts, monkeypatch,
                                                                        capsys):
    port, _ = scripts
    monkeypatch.setattr(port, "smi_line", lambda: None)
    monkeypatch.setattr(port, "card_memory_bytes", lambda: None)
    monkeypatch.setattr(port, "TABLE_ITEMS", ITEMS)
    rows = port.table()
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == json.loads(json.dumps(rows))
    assert [(r["adapt"], r["opt_state_dtype"]) for r in rows] == COMBOS
    for r in rows:
        assert r["graph_pool_bytes"] == r["capture_workspace_bytes"] == "not measured"
        assert "predicted_max_items" not in r and r["card"] is None
    # the memory case of bfloat16_sr: fewer bytes per item than float32 state
    per_item = {(r["adapt"], r["opt_state_dtype"]): r["total_bytes_per_item"] for r in rows}
    for adapt in ("adagrad", "adam"):
        assert per_item[(adapt, "bfloat16_sr")] < per_item[(adapt, "float32")]
