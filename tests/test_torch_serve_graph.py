"""The serving lanes of ``gru4rec_tpu_torch/models/gru4rec.py``, changed in
place, and the captured serving calls.

On the CPU (eager, the graphs' plain version), against the JAX package on
the same weights: a sequence of ``predict_topk`` and ``predict_next_batch``
calls (full catalog and an item subset) with session changes, a change of k
and a change of batch gives JAX's scores call by call, while the lanes keep
their storage at a width; a NaN lane stays NaN through a session change in
both packages (the reset is a multiply by the keep mask).

On the card (``cuda``-marked, skipped here; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_serve_graph.py``):
the captured calls against eager serving (``_serve_graphs = None``) bit for
bit over that sequence and after ``cast_for_serving("bfloat16")``; a new
capture after a change of batch and after the cast.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.models import gru  # noqa: E402

N_ITEMS = 30
TOL = dict(rtol=1e-5, atol=1e-6)
SUBSET = [f"item_{i}" for i in range(0, N_ITEMS, 4)]


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


def cfg_kwargs(**kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[16, 12], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                chunk_size=16, n_epochs=1, item_pad_multiple=8, seed=3,
                constrained_embedding=True)
    args.update(kw)
    return args


def sequence(seed=0):
    """(call, batch, k, session ids, input items) per call: session changes
    along the way, a change of k, a change of batch and back, and
    full-catalog and subset scoring between top-k calls."""
    rng = np.random.RandomState(seed)
    plan = [("topk", 4, 5), ("topk", 4, 5), ("next", 4, None), ("topk", 4, 7),
            ("subset", 4, None), ("topk", 4, 7), ("topk", 6, 5), ("next", 6, None),
            ("topk", 6, 5), ("topk", 4, 5), ("next", 4, None), ("topk", 4, 5)]
    out, sess = [], {}
    for c, (call, batch, k) in enumerate(plan):
        s = sess.get(batch, np.arange(batch) + 1000 * batch)
        if c:
            s = np.where(rng.rand(batch) < 0.35, s + 100 * c, s)
        sess[batch] = s
        items = [f"item_{i}" for i in rng.randint(N_ITEMS, size=batch)]
        out.append((call, batch, k, s.copy(), items))
    return out


def serve(m, call, batch, k, sess, items):
    """One call's scores (and ids for top-k) as numpy arrays."""
    if call == "topk":
        ids, sc = m.predict_topk(sess, items, k=k, batch=batch)
        return np.asarray(ids, dtype=object), np.asarray(sc)
    kw = {"predict_for_item_ids": SUBSET} if call == "subset" else {}
    return None, m.predict_next_batch(sess, items, batch=batch, **kw).values


def lanes(m):
    return tuple(h.data_ptr() for h in m.H)


@pytest.fixture(scope="module")
def pair():
    """The JAX initialisation with random biases, in both packages."""
    import jax

    import gru4rec_tpu
    from gru4rec_tpu.data.loader import build_itemidmap
    from gru4rec_tpu.models import gru as jgru
    from gru4rec_tpu_torch.io.convert import params_from_jax

    cfg = gru4rec_tpu.GRU4RecConfig(**cfg_kwargs())
    m_j = gru4rec_tpu.GRU4Rec(cfg)
    m_j.itemidmap = build_itemidmap(markov(60), "ItemId")
    m_j.n_items = len(m_j.itemidmap)
    params = jax.tree_util.tree_map(np.array, jgru.init_params(cfg, m_j.n_items))
    rng = np.random.RandomState(1)
    params["Bh"] = [rng.randn(*b.shape).astype(np.float32) * 0.3 for b in params["Bh"]]
    params["Wy"][: m_j.n_items, cfg.layers[-1]] = rng.randn(m_j.n_items) * 0.3
    m_j.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    m_t = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs()),
                                    device="cpu")
    m_t.params = params_from_jax(params, device="cpu")
    m_t.itemidmap, m_t.n_items = m_j.itemidmap, m_j.n_items
    return m_j, m_t


@pytest.mark.parametrize("seed", [0, 1])
def test_serving_sequence_matches_jax_call_by_call(seed, pair):
    m_j, m_t = pair
    for m in pair:  # fresh lanes at the first call
        m._current_session = m._predict_batch = None
    width = ptrs = None
    for c, (call, batch, k, sess, items) in enumerate(sequence(seed)):
        ids_t, sc_t = serve(m_t, call, batch, k, sess, items)
        ids_j, sc_j = serve(m_j, call, batch, k, sess, items)
        np.testing.assert_allclose(sc_t, sc_j, err_msg=f"call {c}", **TOL)
        if call == "topk":
            gaps = np.diff(sc_j, axis=1)  # <= 0, best first
            distinct = np.ones_like(sc_j, dtype=bool)
            distinct[:, 1:] &= gaps < -1e-5
            distinct[:, :-1] &= gaps < -1e-5
            np.testing.assert_array_equal(ids_t[distinct], ids_j[distinct])
        for h_t, h_j in zip(m_t.H, m_j.H):
            np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), err_msg=f"call {c}",
                                       **TOL)
        # the lanes change in place while the width stays
        if batch == width:
            assert lanes(m_t) == ptrs, f"call {c}"
        width, ptrs = batch, lanes(m_t)


def test_nan_lane_stays_nan_through_a_session_change(pair):
    """The reset multiplies by the keep mask, in both packages: a NaN lane
    whose session changes stays NaN, the other lanes score as before."""
    import jax.numpy as jnp

    m_j, m_t = pair
    sess, items = np.arange(4), ["item_1", "item_2", "item_3", "item_4"]
    for m in (m_j, m_t):
        m._current_session = m._predict_batch = None
        m.predict_next_batch(sess, items, batch=4)
    m_t.H[0][2] = float("nan")
    m_j.H = (m_j.H[0].at[2].set(jnp.nan),) + tuple(m_j.H[1:])
    sess2 = sess.copy()
    sess2[2] = 99
    got = m_t.predict_next_batch(sess2, items, batch=4).values
    want = m_j.predict_next_batch(sess2, items, batch=4).values
    assert np.isnan(got[:, 2]).all() and np.isnan(want[:, 2]).all()
    keep = [0, 1, 3]
    np.testing.assert_allclose(got[:, keep], want[:, keep], **TOL)


# --------------------------------------------------------------------- #
# On the card.

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_pair():
    """Two port models on the card with the same seeded weights: one
    serving through captured calls, one eagerly."""
    from gru4rec_tpu_torch.data.loader import build_itemidmap

    models = []
    for graphs in ({}, None):
        m = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs()))
        m.itemidmap = build_itemidmap(markov(60), "ItemId")
        m.n_items = len(m.itemidmap)
        m.params = gru.init_params(m.config, m.n_items, m.device)
        gen = torch.Generator(device=m.device)
        gen.manual_seed(0)
        for b in m.params["Bh"]:
            b.copy_(torch.randn(b.shape, generator=gen, device=m.device) * 0.3)
        m._serve_graphs = graphs
        models.append(m)
    return models


def _same(a, b):
    return (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cast", [False, True])
def test_cuda_serving_graphs_match_eager(cast):
    _card()
    graphed, eager = card_pair()
    if cast:
        for m in (graphed, eager):
            m.cast_for_serving("bfloat16")
    # twice over: the second pass replays the graphs the first captured
    for c, (call, batch, k, sess, items) in enumerate(sequence(0) + sequence(1)):
        ids_g, sc_g = serve(graphed, call, batch, k, sess, items)
        ids_e, sc_e = serve(eager, call, batch, k, sess, items)
        assert _same(ids_g, ids_e) and np.array_equal(sc_g, sc_e), f"call {c}"
        for h_g, h_e in zip(graphed.H, eager.H):
            assert torch.equal(h_g, h_e), f"call {c}"
    # full-catalog calls in a row at one width: the captured call replays
    for sess, items in [(np.arange(4) + 7 * c, ["item_3"] * 4) for c in range(3)]:
        assert np.array_equal(serve(graphed, "next", 4, None, sess, items)[1],
                              serve(eager, "next", 4, None, sess, items)[1])
    assert eager._serve_graphs is None
    assert set(graphed._serve_graphs) == {("topk", 4, 5), ("topk", 4, 7), ("topk", 6, 5),
                                          ("next", 4), ("next", 6)}
    # a width change gives fresh lanes, so a graph is captured again at
    # the old width; the graphs of the last width replayed
    for key in (("topk", 4, 5), ("next", 4)):
        assert graphed._serve_graphs[key].replays > 0, key


@pytest.mark.cuda
def test_cuda_serving_recaptures_after_batch_change_and_cast():
    from gru4rec_tpu_torch.utils.cuda_graph import binding

    _card()
    graphed, eager = card_pair()
    sess, items = np.arange(4), ["item_1", "item_2", "item_3", "item_4"]

    def topk(b=4):
        got = graphed.predict_topk(sess[:b], items[:b], k=5, batch=b)
        want = eager.predict_topk(sess[:b], items[:b], k=5, batch=b)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        graph = graphed._serve_graphs.get(("topk", b, 5))
        # the graph is bound to the parameters and lanes the call used
        assert graph.bound == (graphed.n_items, binding(graphed.params, graphed.H))
        return graph

    first = [topk() for _ in range(3)][-1]
    assert first.graph is not None and first.warm == 1 and first.replays == 2
    lanes = list(graphed.H)
    topk(3)  # another width: fresh lanes
    topk()   # back at 4: fresh lanes again, new tensors
    assert not any(h is g for h, g in zip(graphed.H, lanes))
    graphed.cast_for_serving("bfloat16")
    eager.cast_for_serving("bfloat16")
    assert graphed._serve_graphs == {}
    cast = [topk() for _ in range(3)][-1]
    assert cast is not first and cast.graph is not None and cast.replays == 2
    assert graphed.params["Wy"].dtype == torch.bfloat16
