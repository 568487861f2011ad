"""The port's serving path against the JAX package's, on the CPU.

The same weights (a JAX fit, or the JAX initialisation with random biases,
carried across by ``io/convert.py``) serve the same request stream in both
packages, compute_dtype float32:

* ``predict_next_batch``, full catalog and an item subset, in the three
  input modes, across session changes: scores within rtol 1e-5 / atol 1e-6;
* ``predict_topk``: scores within the same tolerance and the ids where the
  scores are distinct (``torch.topk`` and ``lax.top_k`` may order ties
  differently);
* a change of lane width resets every lane, in both packages alike;
* ``cast_for_serving("bfloat16")`` against the JAX package's cast: rtol 1e-2;
* the markov chain's successor is the argmax of a trained port model;
* ``fit`` leaves the lane state as the JAX package's does: the next predict
  call starts from fresh lanes.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import gru4rec_tpu  # noqa: E402
from gru4rec_tpu.data.loader import build_itemidmap  # noqa: E402
from gru4rec_tpu.models import gru as jgru  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.io.convert import params_from_jax  # noqa: E402

N_ITEMS = 30
TOL = dict(rtol=1e-5, atol=1e-6)
MODES = {"constrained": {"constrained_embedding": True},
         "embedding": {"embedding": 12}, "onehot": {}}


def markov(n_sessions, n_items=N_ITEMS, seed=0):
    """Learnable click stream: next = (7*i+3) % n_items."""
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def cfg_kwargs(mode="constrained", **kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                chunk_size=16, n_epochs=1, item_pad_multiple=8, seed=3, **MODES[mode])
    args.update(kw)
    return args


def pair_from_jax(m_j, mode):
    """A port model holding ``m_j``'s weights and catalog."""
    m_t = gru4rec_tpu_torch.GRU4Rec(
        gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs(mode)), device="cpu")
    m_t.params = params_from_jax(jax.tree_util.tree_map(np.asarray, m_j.params),
                                 device="cpu")
    m_t.itemidmap, m_t.n_items = m_j.itemidmap, m_j.n_items
    return m_t


@pytest.fixture(scope="module")
def fitted():
    """A JAX fit in the constrained mode, and its port twin."""
    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg_kwargs()))
    m_j.fit(markov(60))
    return m_j, pair_from_jax(m_j, "constrained")


def initialised(mode):
    """The JAX initialisation with random biases (so that every term of the
    step is live), in both packages."""
    cfg = gru4rec_tpu.GRU4RecConfig(**cfg_kwargs(mode))
    m_j = gru4rec_tpu.GRU4Rec(cfg)
    m_j.itemidmap = build_itemidmap(markov(60), "ItemId")
    m_j.n_items = len(m_j.itemidmap)
    params = jax.tree_util.tree_map(np.array, jgru.init_params(cfg, m_j.n_items))
    rng = np.random.RandomState(1)
    params["Bh"] = [rng.randn(*b.shape).astype(np.float32) * 0.3 for b in params["Bh"]]
    params["Wy"][: m_j.n_items, cfg.layers[-1]] = rng.randn(m_j.n_items) * 0.3
    m_j.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    return m_j, pair_from_jax(m_j, mode)


def requests(n_calls=4, batch=4, seed=0):
    """(session ids, input items) per call; sessions change along the way."""
    rng = np.random.RandomState(seed)
    sess = np.arange(batch)
    out = []
    for c in range(n_calls):
        if c:
            sess = np.where(rng.rand(batch) < 0.4, sess + 100 * c, sess)
        out.append((sess.copy(), [f"item_{i}" for i in rng.randint(N_ITEMS, size=batch)]))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_next_batch_matches_jax(mode, fitted):
    m_j, m_t = fitted if mode == "constrained" else initialised(mode)
    subset = [f"item_{i}" for i in range(0, N_ITEMS, 3)]
    for c, (sess, items) in enumerate(requests()):
        # the subset changes every other call; that must not reset lanes
        kw = {"predict_for_item_ids": subset} if c % 2 else {}
        want = m_j.predict_next_batch(sess, items, batch=4, **kw)
        got = m_t.predict_next_batch(sess, items, batch=4, **kw)
        assert list(got.index) == list(want.index) and got.shape == want.shape
        np.testing.assert_allclose(got.values, want.values, err_msg=f"call {c}", **TOL)


def test_predict_topk_matches_jax(fitted):
    m_j, m_t = fitted
    for c, (sess, items) in enumerate(requests(batch=6, seed=2)):
        ids_j, sc_j = m_j.predict_topk(sess, items, k=7, batch=6)
        ids_t, sc_t = m_t.predict_topk(sess, items, k=7, batch=6)
        assert ids_t.shape == (6, 7) and ids_t.dtype == object
        np.testing.assert_allclose(sc_t, sc_j, err_msg=f"call {c}", **TOL)
        gaps = np.diff(sc_j, axis=1)  # <= 0, best first
        distinct = np.ones_like(sc_j, dtype=bool)
        distinct[:, 1:] &= gaps < -1e-5
        distinct[:, :-1] &= gaps < -1e-5
        assert distinct.sum() > 0
        np.testing.assert_array_equal(ids_t[distinct], ids_j[distinct])
    # k is clamped to the catalog
    ids, sc = m_t.predict_topk([0], ["item_1"], k=10_000, batch=1)
    assert ids.shape == (1, N_ITEMS) and np.all(np.diff(sc, axis=1) <= 0)


def test_lane_width_change_resets_lanes(fitted):
    m_j, m_t = fitted
    (sess, items), (sess2, items2) = requests(n_calls=2, batch=4, seed=5)
    for m in (m_j, m_t):
        m.predict_next_batch(sess, items, batch=4)
        m.predict_next_batch(sess2, items2, batch=4)
    # the same session ids at another width: every lane starts fresh
    got = m_t.predict_next_batch(sess2[:3], items2[:3], batch=3)
    want = m_j.predict_next_batch(sess2[:3], items2[:3], batch=3)
    np.testing.assert_allclose(got.values, want.values, **TOL)
    fresh = pair_from_jax(m_j, "constrained").predict_next_batch(sess2[:3], items2[:3],
                                                                 batch=3)
    np.testing.assert_array_equal(got.values, fresh.values)
    # a session change resets only its lane: it scores as a fresh lane does
    cont = m_t.predict_next_batch([sess2[0], 777, sess2[2]], items2[:3], batch=3)
    one = pair_from_jax(m_j, "constrained")
    one_fresh = one.predict_next_batch([777], [items2[1]], batch=1)
    np.testing.assert_allclose(cont.values[:, 1], one_fresh.values[:, 0], **TOL)
    assert not np.allclose(cont.values[:, 0], fresh.values[:, 0], **TOL)


def test_cast_for_serving_matches_jax(fitted):
    m_j0, _ = fitted
    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg_kwargs()))
    m_j.params, m_j.itemidmap, m_j.n_items = m_j0.params, m_j0.itemidmap, m_j0.n_items
    m_t = pair_from_jax(m_j, "constrained")
    m_j.cast_for_serving("bfloat16")
    assert m_t.cast_for_serving("bfloat16") is m_t and m_t._train_state is None
    assert all(t.dtype == torch.bfloat16 for k in ("Wx", "Wh", "Wrz", "Bh")
               for t in m_t.params[k]) and m_t.params["Wy"].dtype == torch.bfloat16
    # the same bf16 weights in both packages
    np.testing.assert_array_equal(
        m_t.params["Wy"].float().numpy(), np.asarray(m_j.params["Wy"], np.float32))
    for c, (sess, items) in enumerate(requests(seed=7)):
        want = m_j.predict_next_batch(sess, items, batch=4)
        got = m_t.predict_next_batch(sess, items, batch=4)
        assert np.isfinite(got.values).all() and got.values.dtype == np.float32
        np.testing.assert_allclose(got.values, want.values, rtol=1e-2, atol=1e-3,
                                   err_msg=f"call {c}")
    # fit() refuses to retrain narrowed masters
    with pytest.raises(NotImplementedError, match="float32 master weights"):
        m_t.fit(markov(10), retrain=True)


def test_markov_argmax():
    m = gru4rec_tpu_torch.GRU4Rec(loss="bpr-max", layers=[32], batch_size=16,
                                  n_sample=32, n_epochs=3, chunk_size=32,
                                  constrained_embedding=True, device="cpu")
    m.fit(markov(300))
    items = np.arange(0, N_ITEMS, 2)
    ids = [f"item_{i}" for i in items]
    preds = m.predict_next_batch(np.arange(len(ids)), ids, batch=len(ids))
    succ = [f"item_{(7 * i + 3) % N_ITEMS}" for i in items]
    assert list(preds.idxmax(axis=0).values) == succ
    # the same fresh lanes through predict_topk
    top, _ = m.predict_topk(np.arange(len(ids)) + 1000, ids, k=3, batch=len(ids))
    assert list(top[:, 0]) == succ


def test_fit_leaves_lane_state_as_jax():
    cfg = cfg_kwargs()
    sess, items = requests(n_calls=1, batch=cfg["batch_size"])[0]
    data = markov(40)
    models = []
    for pkg, kw in ((gru4rec_tpu, {}), (gru4rec_tpu_torch, {"device": "cpu"})):
        m = pkg.GRU4Rec(pkg.GRU4RecConfig(**cfg), **kw)
        m.fit(data)
        # serve at the training width, then fit again
        m.predict_next_batch(sess, items, batch=cfg["batch_size"])
        m.fit(data)
        assert m._current_session is None and m._predict_batch is None
        assert [tuple(h.shape) for h in m.H] == [(cfg["batch_size"], 16)]
        models.append(m)
    m_j2, m_t2 = models
    # the same session ids at the training width start from fresh lanes,
    # not from the training hidden state that fit() left in self.H
    got = m_t2.predict_next_batch(sess, items, batch=cfg["batch_size"])
    fresh = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**cfg), device="cpu")
    fresh.params, fresh.itemidmap, fresh.n_items = m_t2.params, m_t2.itemidmap, m_t2.n_items
    want = fresh.predict_next_batch(sess, items, batch=cfg["batch_size"])
    np.testing.assert_array_equal(got.values, want.values)
    got_j = m_j2.predict_next_batch(sess, items, batch=cfg["batch_size"])
    fresh_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg))
    fresh_j.params, fresh_j.itemidmap, fresh_j.n_items = (m_j2.params, m_j2.itemidmap,
                                                          m_j2.n_items)
    np.testing.assert_allclose(
        got_j.values, fresh_j.predict_next_batch(sess, items, batch=cfg["batch_size"]).values,
        **TOL)
