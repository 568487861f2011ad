"""``evaluate`` of ``gru4rec_tpu_torch/eval/evaluation.py``: the step that
writes its lanes in place, the schedule memo, and the captured step.

On the CPU (the eager loop, the graph's plain version), against the JAX
package's ``evaluate`` on the same weights:

* the in-place step keeps its lanes' storage and gives JAX's Recall and MRR
  in the three deterministic tie modes, full catalog and an item subset,
  JAX on activated scores (F1: ``rank_invariant`` patched to ``False`` and
  ``_CHUNK_FN_CACHE`` cleared before and after);
* ``tiebreaking`` by distribution only (F3): with every score tied, both
  packages draw Recall@5 near its expectation, full catalog and subset;
* the memo (``_sched_cache``): a hit returns the cached schedule and builds
  none; a changed length, first row or last row misses; a 3-epoch ``fit``
  that validates every epoch builds the validation schedule once, in the
  port as in JAX;
* the CPU captures nothing.

On the card (``cuda``-marked, skipped here; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_eval_graph.py``):
the graph against the eager loop bit for bit (Recall, MRR and the final
lanes) in every tie mode, full catalog and subset; a graph kept across
calls; no memory left behind by a standalone ``evaluate``.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.eval import evaluation as teval  # noqa: E402
from gru4rec_tpu_torch.models import gru  # noqa: E402
from gru4rec_tpu_torch.ops.ranking import TIE_MODES  # noqa: E402
from gru4rec_tpu_torch.utils.cuda_graph import WARMUP_STEPS  # noqa: E402

N_ITEMS = 30
CUTOFFS = [1, 5, 10]
SUBSET = [f"item_{i}" for i in range(0, N_ITEMS, 3)]
ITEM_CASES = ("full", "subset")


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
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                chunk_size=16, n_epochs=1, item_pad_multiple=8, seed=3,
                constrained_embedding=True)
    args.update(kw)
    return args


def twin(m_j):
    """A port model on the CPU holding ``m_j``'s weights and catalog."""
    import jax

    from gru4rec_tpu_torch.io.convert import params_from_jax

    m_t = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs()),
                                    device="cpu")
    m_t.params = params_from_jax(jax.tree_util.tree_map(np.asarray, m_j.params),
                                 device="cpu")
    m_t.itemidmap, m_t.n_items = m_j.itemidmap, m_j.n_items
    return m_t


@pytest.fixture(scope="module")
def fitted():
    """A JAX fit on the markov chain, and its port twin."""
    import gru4rec_tpu

    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg_kwargs()))
    m_j.fit(markov(60))
    return m_j, twin(m_j)


def jax_evaluate(model, test, monkeypatch, **kw):
    """JAX's single-device evaluate on activated scores (F1)."""
    from gru4rec_tpu.eval import evaluation as jeval

    monkeypatch.setattr(jeval, "rank_invariant", lambda name: False)
    jeval._CHUNK_FN_CACHE.clear()
    try:
        return jeval.evaluate(model, test, **kw)
    finally:
        jeval._CHUNK_FN_CACHE.clear()


def _recording_steps(monkeypatch):
    """Patches ``make_eval_step`` so that each step records the lanes it is
    given (the same tensors every step: it writes them in place)."""
    seen = []
    make = teval.make_eval_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def wrapped(params, H, *rest, **kw):
            seen.append(list(H))
            return step(params, H, *rest, **kw)

        return wrapped

    monkeypatch.setattr(teval, "make_eval_step", recording)
    return seen


@pytest.mark.parametrize("items", ITEM_CASES)
@pytest.mark.parametrize("mode", [m for m in TIE_MODES if m != "tiebreaking"])
def test_in_place_step_matches_jax(mode, items, fitted, monkeypatch):
    m_j, m_t = fitted
    test = markov(40, seed=5)
    kw = dict(cut_off=CUTOFFS, batch_size=8, mode=mode,
              items=SUBSET if items == "subset" else None)
    seen = _recording_steps(monkeypatch)
    rec_t, mrr_t = gru4rec_tpu_torch.evaluate(m_t, test, **kw)
    rec_j, mrr_j = jax_evaluate(m_j, test, monkeypatch, **kw)
    np.testing.assert_allclose(rec_t, rec_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mrr_t, mrr_j, rtol=0, atol=1e-6)
    assert 0.0 < rec_t[-1] <= 1.0
    # every step was given the one set of lanes, which it writes in place
    assert len(seen) > 1
    assert len({tuple(h.data_ptr() for h in H) for H in seen}) == 1


@pytest.mark.parametrize("items", ITEM_CASES)
def test_tiebreaking_by_distribution(items, fitted, monkeypatch):
    """Zero output weights tie every score: the dither ranks the target
    uniformly among its competitors, in both packages alike."""
    import jax

    import gru4rec_tpu

    m_j0, _ = fitted
    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg_kwargs()))
    m_j.itemidmap, m_j.n_items = m_j0.itemidmap, m_j0.n_items
    params = jax.tree_util.tree_map(np.array, m_j0.params)
    params["Wy"][:] = 0.0  # the bias is Wy's last column
    m_j.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    m_t = twin(m_j)
    test = markov(300, seed=6)
    kw = dict(cut_off=[5], batch_size=8, items=SUBSET if items == "subset" else None)
    for m, ev in ((m_t, gru4rec_tpu_torch.evaluate),
                  (m_j, lambda *a, **k: jax_evaluate(*a, monkeypatch, **k))):
        assert ev(m, test, mode="standard", **kw)[0] == [1.0]
        assert ev(m, test, mode="conservative", **kw)[0] == [0.0]
    rec = [gru4rec_tpu_torch.evaluate(m_t, test, mode="tiebreaking", **kw)[0][0],
           jax_evaluate(m_j, test, monkeypatch, mode="tiebreaking", **kw)[0][0]]
    n_events = int((test.groupby("SessionId").size() - 1).sum())
    # the target competes with every item (full), or with the subset and
    # itself (k / n_sub when it is in the subset, k / (n_sub + 1) if not)
    lo, hi = ((5 / N_ITEMS, 5 / N_ITEMS) if items == "full"
              else (5 / (len(SUBSET) + 1), 5 / len(SUBSET)))
    sigma = np.sqrt(hi * (1 - hi) / n_events)
    for r in rec:
        assert lo - 4 * sigma < r < hi + 4 * sigma, (rec, lo, hi, sigma)
    assert abs(rec[0] - rec[1]) < 6 * sigma, (rec, sigma)


def _counting_builds(monkeypatch, module):
    calls = []
    build = module.build_schedule

    def counted(*args, **kw):
        calls.append(build(*args, **kw))
        return calls[-1]

    monkeypatch.setattr(module, "build_schedule", counted)
    return calls


def test_schedule_memo_hits_and_misses(fitted, monkeypatch):
    _, m_t = fitted
    test = markov(40, seed=5)
    cache = {}
    builds = _counting_builds(monkeypatch, teval)

    def run(frame):
        return gru4rec_tpu_torch.evaluate(m_t, frame, cut_off=CUTOFFS, batch_size=8,
                                          _sched_cache=cache)

    want = run(test)
    assert len(builds) == 1 and len(cache) == 1
    ((frame, sched),) = cache.values()
    assert frame is test and sched is builds[0]  # the frame is pinned
    assert run(test) == want and len(builds) == 1  # a hit builds nothing
    # a hit returns the cached schedule itself
    assert teval._eval_schedule(m_t, test, 8, "SessionId", "ItemId", "Time", cache) is sched
    # another batch misses
    gru4rec_tpu_torch.evaluate(m_t, test, cut_off=CUTOFFS, batch_size=4, _sched_cache=cache)
    assert len(builds) == 2
    # a changed length, first row or last row of the same frame misses
    test.drop(test.index[5], inplace=True)
    run(test)
    assert len(builds) == 3
    test.loc[test.index[0], "ItemId"] = "item_1" if test["ItemId"].iloc[0] != "item_1" \
        else "item_2"
    run(test)
    assert len(builds) == 4
    test.loc[test.index[-1], "Time"] = test["Time"].iloc[-1] + 1
    run(test)
    assert len(builds) == 5
    run(test)
    assert len(builds) == 5


def test_fit_builds_the_validation_schedule_once(monkeypatch):
    """Three epochs validating every epoch: the evaluator of each package
    builds the validation schedule once (``fit``'s own training schedule
    is not counted)."""
    import gru4rec_tpu
    from gru4rec_tpu.eval import evaluation as jeval

    train, valid = markov(60), markov(30, seed=5)
    counts = {}
    for name, pkg, module, kw in (
            ("jax", gru4rec_tpu, jeval, {}),
            ("port", gru4rec_tpu_torch, teval, {"device": "cpu"})):
        builds = _counting_builds(monkeypatch, module)
        m = pkg.GRU4Rec(pkg.GRU4RecConfig(**cfg_kwargs(n_epochs=3)), **kw)
        m.fit(train, eval_data=valid, eval_batch_size=8)
        assert len(m.valid_stats) == 3
        counts[name] = len(builds)
    assert counts == {"jax": 1, "port": 1}


def test_cpu_captures_nothing(fitted):
    _, m_t = fitted
    graphs = {}
    gru4rec_tpu_torch.evaluate(m_t, markov(40, seed=5), cut_off=CUTOFFS, batch_size=8,
                               _graphs=graphs)
    assert graphs == {}


# --------------------------------------------------------------------- #
# On the card.

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_model(seed=0):
    """A port model on the card: the seeded initialisation with random
    biases, over the markov catalog."""
    from gru4rec_tpu_torch.data.loader import build_itemidmap

    m = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs()))
    m.itemidmap = build_itemidmap(markov(60), "ItemId")
    m.n_items = len(m.itemidmap)
    m.params = gru.init_params(m.config, m.n_items, m.device)
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    for b in m.params["Bh"]:
        b.copy_(torch.randn(b.shape, generator=gen, device=m.device) * 0.3)
    m.params["Wy"][: m.n_items, 16].copy_(
        torch.randn(m.n_items, generator=gen, device=m.device) * 0.3)
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("items", ITEM_CASES)
@pytest.mark.parametrize("mode", TIE_MODES)
def test_cuda_eval_graph_matches_eager_loop(mode, items, monkeypatch):
    _card()
    m = card_model()
    test = markov(200, seed=5)
    kw = dict(cut_off=CUTOFFS, batch_size=8, mode=mode,
              items=SUBSET if items == "subset" else None)
    seen = _recording_steps(monkeypatch)
    eager = gru4rec_tpu_torch.evaluate(m, test, _eager=True, **kw)
    H_eager = [h.clone() for h in seen[-1]]
    n_eager = len(seen)
    graphs = {}
    got = gru4rec_tpu_torch.evaluate(m, test, _graphs=graphs, **kw)
    torch.cuda.synchronize()
    (runner,) = graphs.values()
    assert runner.graph is not None and runner.warm == WARMUP_STEPS
    assert runner.warm + runner.replays == n_eager  # every step but the warm-up replayed
    assert got == eager
    for h, he in zip(runner.H, H_eager):
        assert torch.equal(h, he)


@pytest.mark.cuda
def test_cuda_eval_graph_kept_across_calls():
    _card()
    m = card_model()
    test = markov(200, seed=5)
    graphs = {}
    first = gru4rec_tpu_torch.evaluate(m, test, cut_off=CUTOFFS, batch_size=8,
                                       mode="tiebreaking", _graphs=graphs)
    (runner,) = graphs.values()
    steps = runner.warm + runner.replays
    again = gru4rec_tpu_torch.evaluate(m, test, cut_off=CUTOFFS, batch_size=8,
                                       mode="tiebreaking", _graphs=graphs)
    assert again == first and list(graphs.values()) == [runner]
    assert runner.warm == WARMUP_STEPS and runner.replays == 2 * steps - WARMUP_STEPS
    # another cutoff list is another evaluator; new parameters another binding
    gru4rec_tpu_torch.evaluate(m, test, cut_off=[20], batch_size=8, _graphs=graphs)
    m.params = gru.map_params(torch.clone, m.params)
    gru4rec_tpu_torch.evaluate(m, test, cut_off=CUTOFFS, batch_size=8,
                               mode="tiebreaking", _graphs=graphs)
    assert len(graphs) == 3


@pytest.mark.cuda
def test_cuda_standalone_evaluate_leaves_no_memory():
    """The first call sets up the capture stream's cuBLAS workspace, held
    for the process; a later call frees its graph and its pool."""
    import gc

    dev = _card()
    m = card_model()
    test = markov(200, seed=5)
    allocated = []
    for _ in range(3):
        gru4rec_tpu_torch.evaluate(m, test, cut_off=CUTOFFS, batch_size=8, mode="median")
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(dev))
    assert allocated[1] == allocated[2] == allocated[0], allocated
