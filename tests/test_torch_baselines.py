"""The port's baselines and legacy evaluators against the JAX package's.

* each baseline fitted on the same frame in both packages gives the same
  ``predict_next`` and ``predict_session`` scores (both are numpy: exact);
* ``evaluate_sessions`` gives the JAX numbers exactly for every baseline,
  with and without ``items``, through the session path and the per-event
  path;
* ``evaluate_sessions_batch`` on a port model carrying a JAX model's
  weights (``io/convert.py``) against the JAX function on the JAX model:
  recall and MRR within 1e-6 in ``standard``, ``conservative`` and
  ``median``, with and without ``items`` (a linear final activation on the
  markov chain, so the scores are distinct);
* ``tiebreaking`` by distribution only (F3): on a model whose scores all
  tie, both packages' ranks are uniform over the catalog;
* the port's ``evaluate_sessions_batch`` within 0.03 of its ``evaluate``;
* the ``KeyError`` paths, and ``evaluate_gpu`` as the alias of ``evaluate``.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import gru4rec_tpu  # noqa: E402
import gru4rec_tpu.baselines as jbase  # noqa: E402
import gru4rec_tpu.eval as jeval  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
import gru4rec_tpu_torch.baselines as tbase  # noqa: E402
import gru4rec_tpu_torch.eval as teval  # noqa: E402
from gru4rec_tpu_torch.io.convert import params_from_jax  # noqa: E402

N_ITEMS = 20
BASELINES = {
    "RandomPred": {},
    "Pop": {"top_n": 12},
    "SessionPop": {"top_n": 12},
    "ItemKNN": {"n_sims": 10},
    "BPR": {"n_factors": 8, "n_iterations": 2, "learning_rate": 0.05},
}


def markov_df(n_sessions, n_items=N_ITEMS, seed=0):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(2, 7)):
            rows.append((s, f"it{i}", t))
            t += 1
            i = (3 * i + 1) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


TRAIN, TEST = markov_df(120), markov_df(25, seed=8)
ITEMS = TRAIN.ItemId.unique()[:7]


def pair(name):
    """The baseline ``name``, fitted on TRAIN in each package."""
    out = []
    for pkg in (jbase, tbase):
        b = getattr(pkg, name)(**BASELINES[name])
        b.fit(TRAIN)
        out.append(b)
    return out


class HideSessionAPI:
    """Expose only predict_next, forcing evaluate_sessions' per-event path."""

    def __init__(self, inner):
        self._inner = inner

    def predict_next(self, *a):
        return self._inner.predict_next(*a)


def test_exports_match_the_jax_package():
    assert tbase.__all__ == jbase.__all__
    assert teval.__all__ == jeval.__all__
    assert teval.evaluate_gpu is teval.evaluate


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_scores_equal_jax(name):
    j, t = pair(name)
    cols = TRAIN.ItemId.unique()
    for sid, sess in TEST.groupby("SessionId").ItemId:
        sess = sess.values
        if len(sess) < 2:
            continue
        np.testing.assert_array_equal(t.predict_session(sid, sess, cols),
                                      j.predict_session(sid, sess, cols))
        for item in sess[:-1]:
            want = j.predict_next(sid, item, cols)
            got = t.predict_next(sid, item, cols)
            assert list(got.index) == list(want.index)
            np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("per_event", [False, True], ids=["session", "per_event"])
@pytest.mark.parametrize("subset", [False, True], ids=["catalog", "items"])
@pytest.mark.parametrize("name", list(BASELINES))
def test_evaluate_sessions_equals_jax(name, subset, per_event):
    j, t = pair(name)
    if per_event:
        j, t = HideSessionAPI(j), HideSessionAPI(t)
    items = ITEMS if subset else None
    want = jeval.evaluate_sessions(j, TEST, TRAIN, items=items, cut_off=5,
                                   rng=np.random.RandomState(7))
    got = teval.evaluate_sessions(t, TEST, TRAIN, items=items, cut_off=5,
                                  rng=np.random.RandomState(7))
    assert got == want
    assert 0.0 <= got[1] <= got[0] <= 1.0


def cfg_kwargs(**kw):
    args = dict(loss="bpr-max", final_act="linear", layers=[16], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                chunk_size=16, n_epochs=2, item_pad_multiple=8, learning_rate=0.1,
                constrained_embedding=True, seed=3)
    args.update(kw)
    return args


def twin(m_j):
    """A port model holding ``m_j``'s weights and catalog."""
    m_t = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs()),
                                    device="cpu")
    m_t.params = params_from_jax(jax.tree_util.tree_map(np.asarray, m_j.params),
                                 device="cpu")
    m_t.itemidmap, m_t.n_items = m_j.itemidmap, m_j.n_items
    return m_t


@pytest.fixture(scope="module")
def fitted():
    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg_kwargs()))
    m_j.fit(TRAIN)
    return m_j, twin(m_j)


@pytest.mark.parametrize("subset", [False, True], ids=["catalog", "items"])
@pytest.mark.parametrize("mode", ["standard", "conservative", "median"])
def test_evaluate_sessions_batch_equals_jax(fitted, mode, subset):
    m_j, m_t = fitted
    items = ITEMS if subset else None
    want = jeval.evaluate_sessions_batch(m_j, TEST, items=items, cut_off=5,
                                         batch_size=8, mode=mode)
    got = teval.evaluate_sessions_batch(m_t, TEST, items=items, cut_off=5,
                                        batch_size=8, mode=mode)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0.0 < got[1] <= got[0] <= 1.0


def test_tiebreaking_by_distribution(fitted):
    """With every score tied (zero output weights), ``standard`` ranks each
    target first, ``conservative`` last, and ``tiebreaking`` uniformly at
    random: recall@5 near 5 / n in both packages, not event by event."""
    m_j, _ = fitted
    m_z = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg_kwargs()))
    m_z.itemidmap, m_z.n_items = m_j.itemidmap, m_j.n_items
    params = jax.tree_util.tree_map(np.array, m_j.params)
    params["Wy"][:] = 0.0  # the bias is Wy's last column
    m_z.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    m_t = twin(m_z)
    test = markov_df(150, seed=4)
    n = m_j.n_items
    for ev, m in ((jeval, m_z), (teval, m_t)):
        assert ev.evaluate_sessions_batch(m, test, cut_off=5, batch_size=8) == (1.0, 1.0)
        assert ev.evaluate_sessions_batch(m, test, cut_off=5, batch_size=8,
                                          mode="conservative") == (0.0, 0.0)
    n_events = sum(len(s) - 1 for _, s in test.groupby("SessionId"))
    sigma = np.sqrt(5 / n * (1 - 5 / n) / n_events)
    rec = [ev.evaluate_sessions_batch(m, test, cut_off=5, batch_size=8,
                                      mode="tiebreaking")[0]
           for ev, m in ((jeval, m_z), (teval, m_t))]
    for r in rec:
        assert abs(r - 5 / n) < 4 * sigma, (rec, 5 / n, sigma)
    assert abs(rec[0] - rec[1]) < 6 * sigma


def test_evaluate_sessions_batch_close_to_evaluate(fitted):
    """The two walks refill lanes in another order: the same metrics within
    0.03 (the tolerance of tests/test_checkpoint_resume.py)."""
    _, m_t = fitted
    rec, mrr = teval.evaluate(m_t, TEST, cut_off=[5], batch_size=8)
    r, m = teval.evaluate_sessions_batch(m_t, TEST, cut_off=5, batch_size=8)
    assert abs(r - rec[0]) <= 0.03 and abs(m - mrr[0]) <= 0.03


def test_key_errors(fitted):
    _, m_t = fitted
    with pytest.raises(KeyError, match="not in the training vocabulary"):
        teval.evaluate_sessions_batch(m_t, TEST, items=list(ITEMS) + ["unseen"],
                                      cut_off=5, batch_size=8)
    pop = tbase.Pop()
    pop.fit(TRAIN)
    test = TEST.copy()
    test.loc[test.index[1], "ItemId"] = "unseen-item"
    with pytest.raises(KeyError, match="not present in the training vocabulary"):
        teval.evaluate_sessions(pop, test, TRAIN, cut_off=5)
