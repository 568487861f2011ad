"""``fit``'s options in the port, against the JAX package where both run.

* F4: the JAX package's keyword call (``eval_data``, ``eval_every``,
  ``eval_cutoff``, ``eval_batch_size``, ``eval_mode``, ``eval_metric``,
  ``early_stop_patience``, ``keep_best``) runs and fills ``valid_stats``;
* each ``valid_stats`` entry equals ``evaluate`` on that epoch's parameters;
* early stopping after ``early_stop_patience`` evaluations without a gain,
  and ``keep_best`` restores a true snapshot of the best epoch (the updates
  run in place, so a reference would follow the later epochs);
* F5: a NaN run aborts within two chunks of the first NaN chunk, and its
  dump loads in the port's ``load_train_checkpoint`` and in the JAX
  package's ``loadmodel``;
* the JSONL events carry the JAX package's names and fields;
* ``profile_dir`` writes a trace.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gru4rec_tpu  # noqa: E402
import gru4rec_tpu.utils.logging as jlog  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
import gru4rec_tpu_torch.models.gru4rec as tmodel  # noqa: E402
import gru4rec_tpu_torch.utils.logging as tlog  # noqa: E402
from gru4rec_tpu_torch.io.checkpoint import load_train_checkpoint  # noqa: E402

N_ITEMS = 30


def markov(n_sessions, n_items=N_ITEMS, seed=0):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def cfg_kwargs(**kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                momentum=0.2, chunk_size=16, n_epochs=3, item_pad_multiple=8, seed=3)
    args.update(kw)
    return args


def port_model(**kw):
    return gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs(**kw)),
                                     device="cpu")


def params_equal(a, b):
    return all(torch.equal(x, y) for k in a
               for x, y in zip(*(p[k] if isinstance(p[k], list) else [p[k]]
                                 for p in (a, b))))


TRAIN, VALID = markov(60), markov(20, seed=5)


def test_jax_keyword_call_runs():
    """F4: the JAX package's full keyword set is accepted."""
    m = port_model()
    m.fit(TRAIN, eval_data=VALID, eval_every=1, eval_cutoff=10, eval_batch_size=16,
          eval_mode="standard", eval_metric="mrr", early_stop_patience=2,
          keep_best=True)
    assert not m.error_during_train
    assert [v["epoch"] for v in m.valid_stats][0] == 1 and len(m.valid_stats) >= 2
    assert all(0 <= v["recall"] <= 1 and 0 <= v["mrr"] <= v["recall"]
               for v in m.valid_stats)


def test_valid_stats_equal_evaluate_per_epoch():
    m = port_model()
    m.fit(TRAIN, eval_data=VALID, eval_every=1, eval_cutoff=5, eval_batch_size=16,
          eval_mode="conservative", keep_best=False)
    assert [v["epoch"] for v in m.valid_stats] == [1, 2, 3]
    for v in m.valid_stats:
        ref = port_model().fit(TRAIN, n_epochs=v["epoch"])
        rec, mrr = gru4rec_tpu_torch.evaluate(ref, VALID, cut_off=[5], batch_size=16,
                                              mode="conservative")
        assert (v["recall"], v["mrr"]) == (rec[0], mrr[0]), v
    # eval_every=2 evaluates epochs 2 only (of 3)
    m2 = port_model().fit(TRAIN, eval_data=VALID, eval_every=2, keep_best=False)
    assert [v["epoch"] for v in m2.valid_stats] == [2]


@pytest.mark.parametrize("keep_best", [True, False])
def test_early_stopping_and_keep_best(keep_best, monkeypatch):
    """Scripted validation scores: best at epoch 2, then two epochs without
    a gain stop the run at epoch 4 (of 6)."""
    script = iter([0.5, 0.9, 0.3, 0.2, 0.95, 0.99])
    seen = []

    def scripted(model, *a, **k):
        seen.append(model.params)
        r = next(script)
        return [r], [r / 2]

    monkeypatch.setattr(tmodel, "evaluate", scripted)
    m = port_model(n_epochs=6)
    m.fit(TRAIN, eval_data=VALID, early_stop_patience=2, keep_best=keep_best)
    assert [v["recall"] for v in m.valid_stats] == [0.5, 0.9, 0.3, 0.2]
    assert len(m.epoch_stats) == 4
    # the evaluator saw the live parameters; the model's own outside the call
    assert all(p is seen[0] for p in seen)
    at2 = port_model().fit(TRAIN, n_epochs=2)
    at4 = port_model().fit(TRAIN, n_epochs=4)
    assert not params_equal(at2.params, at4.params)
    assert params_equal(m.params, (at2 if keep_best else at4).params)
    assert m._train_state.params is m.params
    # the optimizer state stays at the last epoch either way
    assert all(torch.equal(a, b) for a, b in zip(
        m._train_state.opt_state["sparse"]["Wy"].values(),
        at4._train_state.opt_state["sparse"]["Wy"].values()))


def counting_chunk_fn(monkeypatch):
    calls = []
    real = tmodel.make_chunk_fn

    def counting(cfg, n_items):
        fn = real(cfg, n_items)

        def wrapped(*a, **k):
            calls.append(1)
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(tmodel, "make_chunk_fn", counting)
    return calls


def nan_cfg():
    return dict(loss="cross-entropy", final_act="softmax", layers=[16], batch_size=8,
                n_sample=8, learning_rate=float("nan"), n_epochs=1, chunk_size=8,
                item_pad_multiple=32)


def test_nan_abort_within_two_chunks(tmp_path, monkeypatch):
    """F5: the first update makes the weights NaN, so chunk 0's loss sum is
    NaN; the lagged check reads it after dispatching chunk 2 and stops
    there, long before the end of the epoch."""
    calls = counting_chunk_fn(monkeypatch)
    ck = str(tmp_path / "ck.npz")
    data = markov(300)
    m = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**nan_cfg()),
                                  device="cpu")
    m.fit(data, checkpoint_path=ck)
    assert m.error_during_train
    assert len(calls) == 3, f"abort not fail-fast: {len(calls)} chunks dispatched"
    with pytest.raises(Exception, match="unusable"):
        m.predict_next_batch([0], ["item_1"], batch=1)
    # the dump: the live state, three chunks of 8 steps in
    dump = ck + ".nan.npz"
    state, epoch = load_train_checkpoint(dump, port_model())
    assert epoch == 0 and state.step == 24 and torch.isnan(state.params["Wy"]).any()
    m_j = gru4rec_tpu.GRU4Rec.loadmodel(dump)
    assert m_j.n_items == m.n_items and np.isnan(np.asarray(m_j.params["Wy"])).any()
    assert m_j._train_state is not None


def test_nan_abort_at_epoch_end_and_dump_path(tmp_path, monkeypatch):
    """A chunk too few for the lagged check: the end-of-epoch check aborts;
    the dump goes to $GRU4REC_TPU_NAN_DUMP, and nowhere when it is empty."""
    calls = counting_chunk_fn(monkeypatch)
    dump = str(tmp_path / "dump.npz")
    monkeypatch.setenv("GRU4REC_TPU_NAN_DUMP", dump)
    cfg = gru4rec_tpu_torch.GRU4RecConfig(**{**nan_cfg(), "chunk_size": 512})
    m = gru4rec_tpu_torch.GRU4Rec(cfg, device="cpu").fit(markov(60))
    assert m.error_during_train and len(calls) == 1 and os.path.exists(dump)
    monkeypatch.setenv("GRU4REC_TPU_NAN_DUMP", "")
    os.remove(dump)
    gru4rec_tpu_torch.GRU4Rec(cfg, device="cpu").fit(markov(60))
    assert not os.listdir(tmp_path)


def events_of(pkg, logmod, path, monkeypatch, **fit_kw):
    monkeypatch.setattr(logmod, "_default", logmod.EventLogger(path))
    kw = dict(device="cpu") if pkg is gru4rec_tpu_torch else {}
    cfg = fit_kw.pop("cfg")
    pkg.GRU4Rec(pkg.GRU4RecConfig(**cfg), **kw).fit(TRAIN, **fit_kw)
    logmod._default.close()
    with open(path) as f:
        return [json.loads(line) for line in f]


PACE = {"host_s", "device_s", "behind"}


def test_jsonl_events_carry_jax_fields(tmp_path, monkeypatch):
    monkeypatch.setenv("GRU4REC_TPU_NAN_DUMP", "")
    runs = [dict(cfg=cfg_kwargs(n_epochs=2), eval_data=VALID),
            dict(cfg={**nan_cfg(), "chunk_size": 4})]
    for r, run in enumerate(runs):
        got = events_of(gru4rec_tpu_torch, tlog, str(tmp_path / f"t{r}.jsonl"),
                        monkeypatch, **dict(run))
        want = events_of(gru4rec_tpu, jlog, str(tmp_path / f"j{r}.jsonl"),
                         monkeypatch, **dict(run))
        assert [e["event"] for e in got] == [e["event"] for e in want]
        # the port's epoch events add its pace counters (utils/profiling.py)
        assert [set(e) - (PACE if e["event"] == "epoch" else set()) for e in got] == \
            [set(e) for e in want]
        assert all(PACE <= set(e) for e in got if e["event"] == "epoch")
        assert [e["epoch"] for e in got] == [e["epoch"] for e in want]
    assert [e["event"] for e in got] == ["nan_abort"] and got[0]["chunk"] == 0


def test_profile_dir_writes_trace(tmp_path):
    prof = str(tmp_path / "prof")
    port_model(n_epochs=2).fit(TRAIN, profile_dir=prof)
    files = os.listdir(prof)
    assert files == ["trace_epoch2.json"]
    with open(os.path.join(prof, files[0])) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
