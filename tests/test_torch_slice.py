"""The port's whole training slice against the JAX package's, on the CPU.

A small constrained-embedding model (layers [32], batch 8, 16 negatives,
60 items, adagrad + momentum 0.4, compute_dtype float32) trains on a
markov-chain click stream in both packages from the same initial weights,
with the port fed the JAX package's negative draws, under both
``opt_state_dtype`` values:

* ``make_chunk_fn`` step by step: per-step loss within rtol 1e-4; final
  parameters within atol 1e-5 (1e-3 under bfloat16 velocity, whose
  rounding lets free-running trajectories drift; every step started from
  the same state is held to 1e-5 there);
* ``GRU4Rec.fit`` then ``evaluate``: epoch losses within rtol 1e-4, final
  parameters within atol 1e-5, and Recall/MRR@[1,5,20] within 1e-6 of JAX
  ``evaluate`` on the same weights (the JAX evaluator forced onto its
  activated-score path, which the port always takes).

It also checks that no module of the port, nor ``chip_smoke.py``, imports
JAX, ``ml_dtypes`` or the JAX package, and that a ``mesh=`` of the wrong type,
or a mesh larger than the world, raises (``tests/test_torch_parallel.py``
drives the mesh itself).
"""

import ast
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gru4rec_tpu  # noqa: E402
from gru4rec_tpu.eval import evaluation as jeval  # noqa: E402
from gru4rec_tpu.ops.sampling import draw_negatives as jax_draw_negatives  # noqa: E402
from gru4rec_tpu.train import step as jstep  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap  # noqa: E402
from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order  # noqa: E402
from gru4rec_tpu_torch.data.tools import compute_offset  # noqa: E402
from gru4rec_tpu_torch.io.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from gru4rec_tpu_torch.models.gru import pad_items  # noqa: E402
from gru4rec_tpu_torch.ops.kernels import sparse_update  # noqa: E402
from gru4rec_tpu_torch.ops.sampling import build_alias_table  # noqa: E402
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS = 60
CUTOFFS = [1, 5, 20]


def markov(n_sessions, seed=0):
    """Learnable click stream: next = (7*i+3) % N_ITEMS."""
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(N_ITEMS)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % N_ITEMS
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def cfg_kwargs(opt_state_dtype, **kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[32], batch_size=8,
                n_sample=16, sample_alpha=0.4, constrained_embedding=True,
                adapt="adagrad", momentum=0.4, learning_rate=0.05,
                compute_dtype="float32", opt_state_dtype=opt_state_dtype,
                chunk_size=1, n_epochs=2, seed=7)
    args.update(kw)
    return args


def jax_negatives(seed, packed, n_sample):
    """The JAX chunk function's draw for a one-step chunk at global ``step``."""
    key = jax.random.PRNGKey(seed)

    def draw(step):
        k = jax.random.fold_in(jax.random.fold_in(key, 1), step)
        return np.array(jax_draw_negatives(k, jnp.asarray(packed), 1, n_sample,
                                            N_ITEMS, 0.4, "alias"))

    return draw


def assert_params_close(tparams, jparams, atol=1e-5):
    jp = jax.tree_util.tree_map(np.asarray, jparams)
    np.testing.assert_allclose(tparams["Wy"].numpy(), jp["Wy"], rtol=0, atol=atol,
                               err_msg="Wy")
    for k in ("Wx", "Wh", "Wrz", "Bh"):
        for i, (a, b) in enumerate(zip(tparams[k], jp[k])):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                                       err_msg=f"{k}[{i}]")


def _chunk_setup(opt_state_dtype):
    """Both packages' chunk functions and states from the same initial
    weights, the markov schedule, and the JAX draw of each step."""
    cfg_j = gru4rec_tpu.GRU4RecConfig(**cfg_kwargs(opt_state_dtype))
    cfg_t = gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs(opt_state_dtype))
    data = markov(150)
    itemidmap = build_itemidmap(data, "ItemId")
    data = apply_itemidmap(data, itemidmap, "ItemId")
    offsets = compute_offset(data, "SessionId")
    order = session_order(data, "SessionId", "Time", True, len(offsets) - 1)
    sched = build_schedule(data["ItemIdx"].values.astype(np.int32), offsets, order, 8)
    pop = data.groupby("ItemId").size().reindex(itemidmap.index.values).values
    packed = build_alias_table(pop, 0.4)
    logp0 = np.zeros(pad_items(N_ITEMS, cfg_t.item_pad_multiple), np.float32)
    jstate = jstep.init_train_state(cfg_j, N_ITEMS, jax.random.PRNGKey(cfg_j.seed))
    tstate = tstep.TrainState(None, None, [torch.zeros(8, 32)],
                              tstep.make_generator(cfg_t.seed, "cpu"))
    sync_from_jax(tstate, jstate)
    assert tstate.opt_state["sparse"]["Wy"]["velocity"].dtype == (
        torch.bfloat16 if opt_state_dtype == "bfloat16" else torch.float32)
    draw = jax_negatives(cfg_j.seed, packed, 16)
    jchunk = jstep.make_chunk_fn(cfg_j, N_ITEMS)
    tchunk = tstep.make_chunk_fn(cfg_t, N_ITEMS)
    samp_j, lp_j = jnp.asarray(packed), jnp.asarray(logp0)
    samp_t, lp_t = torch.from_numpy(packed), torch.from_numpy(logp0)

    def steps():
        """Yield after each step: (jstate, jax loss sum, port loss sum)."""
        nonlocal jstate
        for t in range(sched.n_steps):
            sl = [a[t:t + 1] for a in (sched.in_idx, sched.out_idx, sched.valid,
                                       sched.reset)]
            neg = draw(int(jstate.step))
            jstate, ls, _ = jchunk(jstate, *map(jnp.asarray, sl), samp_j, lp_j)
            ls_t, ec = tchunk(tstate, *sl, samp_t, lp_t, neg=torch.from_numpy(neg))
            assert ec == int(sl[2].sum())
            yield jstate, float(ls), float(ls_t)

    return tstate, steps


def sync_from_jax(tstate, jstate):
    tstate.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                    device="cpu")
    tstate.opt_state = opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.opt_state), device="cpu")
    tstate.H = [torch.from_numpy(np.array(h)) for h in jstate.H]


@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16"])
def test_chunk_fn_trajectory_matches_jax(opt_state_dtype):
    tstate, steps = _chunk_setup(opt_state_dtype)
    lj, lt = [], []
    for jstate, ls_j, ls_t in steps():
        lj.append(ls_j)
        lt.append(ls_t)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    # bfloat16 velocity: both packages round the same float32 value, but the
    # matmuls sum in another order, so now and then an entry on a rounding
    # boundary is stored one bf16 ulp apart (first at step 3 here) and the
    # two free-running trajectories drift apart at that scale. The step by
    # step test below holds every bf16 step to 1e-5.
    assert_params_close(tstate.params, jstate.params,
                        atol=1e-5 if opt_state_dtype == "float32" else 1e-3)


@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16"])
def test_chunk_fn_steps_match_jax_from_the_same_state(opt_state_dtype):
    """Each step starts from JAX's state: parameters within atol 1e-5 and
    float32 state within atol 1e-5 after every step, bfloat16 velocity
    within one bf16 ulp."""
    tstate, steps = _chunk_setup(opt_state_dtype)
    for jstate, ls_j, ls_t in steps():
        np.testing.assert_allclose(ls_t, ls_j, rtol=1e-4)
        assert_params_close(tstate.params, jstate.params)
        for name, st in jax.tree_util.tree_map(
                np.asarray, jstate.opt_state["sparse"]["Wy"]).items():
            got = tstate.opt_state["sparse"]["Wy"][name].float().numpy()
            want = st.astype(np.float32)
            if st.dtype.name == "bfloat16":
                # one ulp, with a floor for entries that cancel to ~1e-8 and
                # so carry the float32 rounding of their ~1e-2 terms
                tol = 2.0**-7 * np.maximum(np.abs(got), np.abs(want)) + 1e-8
                assert np.all(np.abs(got - want) <= tol), name
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        sync_from_jax(tstate, jstate)


@pytest.fixture(scope="module")
def jax_models():
    """JAX fit on the markov stream, once per opt_state_dtype."""
    train = markov(150)
    models = {}
    for sd in ("float32", "bfloat16"):
        m = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**cfg_kwargs(sd)))
        m.fit(train)
        models[sd] = m
    return train, models


def jax_evaluate(model, test, monkeypatch, **kw):
    monkeypatch.setattr(jeval, "rank_invariant", lambda name: False)
    jeval._CHUNK_FN_CACHE.clear()
    try:
        return jeval.evaluate(model, test, **kw)
    finally:
        jeval._CHUNK_FN_CACHE.clear()


@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16"])
def test_fit_then_evaluate_matches_jax(opt_state_dtype, jax_models, monkeypatch):
    train, models = jax_models
    m_j = models[opt_state_dtype]
    cfg = gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs(opt_state_dtype))
    packed = build_alias_table(
        train.groupby("ItemId").size().reindex(m_j.itemidmap.index.values).values, 0.4)
    draw = jax_negatives(cfg.seed, packed, cfg.n_sample)
    calls = []

    def injected(gen, samp1, n_steps, n_sample, n_items, alpha, sampler):
        assert n_steps == 1 and np.array_equal(samp1.numpy(), packed)
        calls.append(None)
        return torch.from_numpy(draw(len(calls) - 1))

    monkeypatch.setattr(tstep, "draw_negatives", injected)
    sparse_update.reset_launches()
    m_t = gru4rec_tpu_torch.GRU4Rec(cfg, device="cpu")
    m_t.fit(train)
    assert sum(sparse_update.launches_by_mode.values()) == 0  # CPU tensors take the plain version
    assert len(calls) == sum(e["steps"] for e in m_t.epoch_stats)
    assert (m_t.itemidmap.index == m_j.itemidmap.index).all()
    np.testing.assert_allclose([e["loss"] for e in m_t.epoch_stats],
                               [e["loss"] for e in m_j.epoch_stats], rtol=1e-4)
    assert [e["events"] for e in m_t.epoch_stats] == [e["events"] for e in m_j.epoch_stats]
    # bfloat16 velocity: see test_chunk_fn_trajectory_matches_jax
    assert_params_close(m_t.params, m_j.params,
                        atol=1e-5 if opt_state_dtype == "float32" else 1e-3)

    test = markov(40, seed=5)
    rec_own, mrr_own = gru4rec_tpu_torch.evaluate(m_t, test, cut_off=CUTOFFS,
                                                  batch_size=16)
    # on the same weights, every deterministic tie mode, full catalog and an
    # item subset
    m_t.params = params_from_jax(jax.tree_util.tree_map(np.asarray, m_j.params),
                                 device="cpu")
    subset = [f"item_{i}" for i in range(0, N_ITEMS, 2)]
    for kw in ({"mode": "standard"}, {"mode": "conservative"}, {"mode": "median"},
               {"mode": "standard", "items": subset}, {"mode": "median", "items": subset}):
        rec_j, mrr_j = jax_evaluate(m_j, test, monkeypatch, cut_off=CUTOFFS,
                                    batch_size=16, **kw)
        rec_t, mrr_t = gru4rec_tpu_torch.evaluate(m_t, test, cut_off=CUTOFFS,
                                                  batch_size=16, **kw)
        np.testing.assert_allclose(rec_t, rec_j, rtol=0, atol=1e-6, err_msg=str(kw))
        np.testing.assert_allclose(mrr_t, mrr_j, rtol=0, atol=1e-6, err_msg=str(kw))
        if kw == {"mode": "standard"}:
            # the port's own weights are within 1e-5 of JAX's: the same
            # metrics up to a near-tie flip of a few events
            np.testing.assert_allclose(rec_own, rec_j, atol=0.02)
            np.testing.assert_allclose(mrr_own, mrr_j, atol=0.02)
    # tiebreaking draws its dither from another generator: compare loosely
    rec_tb, _ = gru4rec_tpu_torch.evaluate(m_t, test, cut_off=CUTOFFS, batch_size=16,
                                           mode="tiebreaking")
    rec_tb_j, _ = jax_evaluate(m_j, test, monkeypatch, cut_off=CUTOFFS, batch_size=16,
                               mode="tiebreaking")
    np.testing.assert_allclose(rec_tb, rec_tb_j, atol=0.05)


def test_unported_options_raise():
    """``mesh=`` takes a ``parallel.Mesh`` only, and ``make_mesh`` a world of
    at least its size; this process is a world of one rank."""
    from gru4rec_tpu_torch.parallel import make_mesh

    cfg = gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs("float32"))
    m = gru4rec_tpu_torch.GRU4Rec(cfg, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        m.fit(markov(20), mesh=object())
    m.fit(markov(20), n_epochs=1)
    with pytest.raises(TypeError, match="Mesh"):
        m.predict_topk([0], ["item_1"], mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        gru4rec_tpu_torch.evaluate(m, markov(20), mesh=object())
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        make_mesh(2, 2, device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gru4rec_tpu_torch.GRU4Rec(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        gru4rec_tpu_torch.GRU4Rec(device="cuda")


def _imported_modules(path):
    """Every module ``path`` imports, by statement or by a call of
    ``__import__`` / ``importlib.import_module`` on a constant name (as the
    JAX package's ``bench.py`` reads its device kind)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                (getattr(node.func, "id", None) == "__import__"
                 or getattr(node.func, "attr", None) == "import_module"):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = os.path.join(REPO, "gru4rec_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    # the port's scripts too, but for the one that compares the packages
    scripts = os.path.join(REPO, "scripts")
    paths += [os.path.join(scripts, f) for f in sorted(os.listdir(scripts))
              if f.endswith("_torch.py") and f != "s1_seed_sweep_torch.py"]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    # the benchmark harnesses, which the JAX package keeps outside it
    for name in ("bench.py", "bench_scaling.py"):
        assert os.path.join(pkg, name) in paths, name
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "gru4rec_tpu"), (path, mod)
