"""The port's training slice against the JAX package's in the modes this
slice adds: ``opt_state_dtype="bfloat16_sr"`` and one-hot input, on the CPU.

* ``make_chunk_fn`` step by step, each step from JAX's state, with JAX's
  negatives and JAX's stochastic-rounding seeds injected
  (``seed_from_key(fold_in(step_key, SR_TABLE_SALT[table]))``): constrained
  adagrad and adam with ``bfloat16_sr``, and one-hot adagrad with float32
  state and ``layers=[32]`` (``Wx0`` is 96 wide, an unaligned width). Per
  step: loss rtol 1e-4; parameters atol 1e-5; SR bf16 state within one bf16
  ulp everywhere and bit-equal on at least 99% of the entries the step
  changed (the gradients are summed in another order, so a value on a
  rounding boundary may round the other way; a wrong hash disagrees on about
  half); velocity within one bf16 ulp; float32 state atol 1e-5.
* ``GRU4Rec.fit`` then ``evaluate``, free-running with the port's own SR
  seeds (JAX's negative draws injected), for the adam/embedding SR config of
  the JAX package's ``test_sr_accuracy_matches_f32_run``: Recall/MRR within
  0.02 of the JAX model's, the bound that test uses between float32 and SR
  state.
"""

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
from gru4rec_tpu.ops.sr import seed_from_key  # noqa: E402
from gru4rec_tpu.train import step as jstep  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap  # noqa: E402
from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order  # noqa: E402
from gru4rec_tpu_torch.data.tools import compute_offset  # noqa: E402
from gru4rec_tpu_torch.io.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from gru4rec_tpu_torch.models.gru import pad_items  # noqa: E402
from gru4rec_tpu_torch.ops.sampling import build_alias_table  # noqa: E402
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402

N_ITEMS = 60


def markov(n_sessions, n_items=N_ITEMS, seed=0, item="item_"):
    """Learnable click stream: next = (7*i+3) % n_items."""
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"{item}{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


CHUNK_CASES = {
    "constrained-adagrad-sr": dict(adapt="adagrad", opt_state_dtype="bfloat16_sr"),
    "constrained-adam-sr": dict(adapt="adam", opt_state_dtype="bfloat16_sr",
                                learning_rate=0.01),
    "onehot-adagrad": dict(constrained_embedding=False, embedding=0,
                           opt_state_dtype="float32"),
}


def cfg_kwargs(**kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[32], batch_size=8,
                n_sample=16, sample_alpha=0.4, constrained_embedding=True,
                adapt="adagrad", momentum=0.4, learning_rate=0.05,
                compute_dtype="float32", chunk_size=1, n_epochs=2, seed=7)
    args.update(kw)
    return args


def sync_from_jax(tstate, jstate):
    tstate.params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                    device="cpu")
    tstate.opt_state = opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.opt_state), device="cpu")
    tstate.H = [torch.from_numpy(np.array(h)) for h in jstate.H]


def jax_sr_seed(key, step, table):
    """The JAX chunk function's SR seed of ``table`` at global ``step``."""
    step_key = jax.random.fold_in(jax.random.fold_in(key, 0), step)
    return int(seed_from_key(jax.random.fold_in(step_key, jstep.SR_TABLE_SALT[table])))


def assert_params_close(tparams, jparams, atol=1e-5):
    jp = jax.tree_util.tree_map(np.asarray, jparams)
    np.testing.assert_allclose(tparams["Wy"].numpy(), jp["Wy"], rtol=0, atol=atol,
                               err_msg="Wy")
    for k in ("Wx", "Wh", "Wrz", "Bh"):
        for i, (a, b) in enumerate(zip(tparams[k], jp[k])):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                                       err_msg=f"{k}[{i}]")
    if "E" in jp:
        np.testing.assert_allclose(tparams["E"].numpy(), jp["E"], rtol=0, atol=atol)


def assert_sparse_state_close(got, want, before, sr_names):
    """``got``/``want``/``before``: {state name: tensor or array} of one
    table. SR slots: one bf16 ulp, bit-equal on >= 99% of the entries the
    step changed and on all others; other bf16: one ulp; float32: 1e-5."""
    for name, w in want.items():
        g = got[name]
        gf, wf = g.float().numpy(), w.astype(np.float32)
        if g.dtype == torch.bfloat16:
            tol = 2.0**-7 * np.maximum(np.abs(gf), np.abs(wf)) + 1e-8
            assert np.all(np.abs(gf - wf) <= tol), name
        else:
            np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-5, err_msg=name)
        if name in sr_names:
            gb, wb = g.view(torch.int16).numpy(), w.view(np.int16)
            bb = before[name].view(torch.int16).numpy()
            changed = (gb != bb) | (wb != bb)
            assert (gb == wb)[~changed].all(), name
            assert changed.any(), name
            share = float((gb == wb)[changed].mean())
            assert share >= 0.99, (name, share)


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_fn_steps_match_jax_from_the_same_state(case):
    kw = cfg_kwargs(**CHUNK_CASES[case])
    cfg_j = gru4rec_tpu.GRU4RecConfig(**kw)
    cfg_t = gru4rec_tpu_torch.GRU4RecConfig(**kw)
    mode = gru4rec_tpu_torch.models.gru.input_mode(cfg_t)
    assert mode == ("onehot" if case.startswith("onehot") else "constrained")
    data = markov(60)
    itemidmap = build_itemidmap(data, "ItemId")
    data = apply_itemidmap(data, itemidmap, "ItemId")
    offsets = compute_offset(data, "SessionId")
    order = session_order(data, "SessionId", "Time", True, len(offsets) - 1)
    sched = build_schedule(data["ItemIdx"].values.astype(np.int32), offsets, order, 8)
    pop = data.groupby("ItemId").size().reindex(itemidmap.index.values).values
    packed = build_alias_table(pop, 0.4)
    logp0 = np.zeros(pad_items(N_ITEMS, cfg_t.item_pad_multiple), np.float32)
    jstate = jstep.init_train_state(cfg_j, N_ITEMS, jax.random.PRNGKey(cfg_j.seed))
    tstate = tstep.TrainState(None, None, None, tstep.make_generator(cfg_t.seed, "cpu"))
    sync_from_jax(tstate, jstate)
    names = tstep.sparse_table_names(mode)
    sr_slot = {"adagrad": "acc", "adam": "acc2"}[cfg_t.adapt]
    sr_names = {sr_slot} if cfg_t.opt_state_dtype == "bfloat16_sr" else set()
    for name in names:
        st = tstate.opt_state["sparse"][name]
        if sr_names:
            assert st[sr_slot].dtype == torch.bfloat16
    if mode == "onehot":
        assert tstate.params["Wx"][0].shape == (logp0.shape[0], 96)
    jchunk = jstep.make_chunk_fn(cfg_j, N_ITEMS)
    tchunk = tstep.make_chunk_fn(cfg_t, N_ITEMS)
    samp_j, lp_j = jnp.asarray(packed), jnp.asarray(logp0)
    samp_t, lp_t = torch.from_numpy(packed), torch.from_numpy(logp0)
    key = jax.random.PRNGKey(cfg_j.seed)
    for t in range(sched.n_steps):
        sl = [a[t:t + 1] for a in (sched.in_idx, sched.out_idx, sched.valid, sched.reset)]
        step = int(jstate.step)
        nk = jax.random.fold_in(jax.random.fold_in(key, 1), step)
        neg = np.array(jax_draw_negatives(nk, samp_j, 1, 16, N_ITEMS, 0.4, "alias"))
        seeds = {n: np.array([jax_sr_seed(key, step, n)], np.int32) for n in names}
        before = {n: {k: v.clone() for k, v in tstate.opt_state["sparse"][n].items()}
                  for n in names}
        jstate, ls_j, _ = jchunk(jstate, *map(jnp.asarray, sl), samp_j, lp_j)
        ls_t, _ = tchunk(tstate, *sl, samp_t, lp_t, neg=torch.from_numpy(neg),
                         sr_seeds=seeds)
        np.testing.assert_allclose(float(ls_t), float(ls_j), rtol=1e-4)
        assert_params_close(tstate.params, jstate.params)
        jsparse = jax.tree_util.tree_map(np.asarray, jstate.opt_state["sparse"])
        for n in names:
            assert_sparse_state_close(tstate.opt_state["sparse"][n], jsparse[n],
                                      before[n], sr_names)
        sync_from_jax(tstate, jstate)
        assert tstate.step == step + 1 == int(jstate.step)


def _markov_frame(n_sessions=120, n_items=40, seed=0):
    """The JAX package's SR test data (tests/test_sr_state.py)."""
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 8)):
            rows.append((s, f"it{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def test_sr_fit_then_evaluate_matches_jax(monkeypatch):
    kw = dict(loss="cross-entropy", final_act="softmax", layers=[24], batch_size=12,
              n_sample=24, sample_alpha=0.5, learning_rate=0.08, adapt="adam",
              embedding=16, n_epochs=3, chunk_size=1, item_pad_multiple=16,
              opt_state_dtype="bfloat16_sr", dropout_p_hidden=0.0,
              dropout_p_embed=0.0, seed=42)
    train, test = _markov_frame(250, seed=1), _markov_frame(60, seed=9)
    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**kw))
    m_j.fit(train)

    packed = build_alias_table(
        train.groupby("ItemId").size().reindex(m_j.itemidmap.index.values).values, 0.5)
    key = jax.random.PRNGKey(kw["seed"])
    calls = []

    def injected(gen, samp1, n_steps, n_sample, n_items, alpha, sampler):
        assert n_steps == 1 and np.array_equal(samp1.numpy(), packed)
        nk = jax.random.fold_in(jax.random.fold_in(key, 1), len(calls))
        calls.append(None)
        return torch.from_numpy(np.array(jax_draw_negatives(
            nk, jnp.asarray(packed), 1, n_sample, n_items, alpha, "alias")))

    monkeypatch.setattr(tstep, "draw_negatives", injected)
    m_t = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**kw), device="cpu")
    m_t.fit(train)
    st = m_t._train_state.opt_state["sparse"]
    assert st["E"]["acc2"].dtype == st["Wy"]["acc2"].dtype == torch.bfloat16
    assert st["E"]["acc2"].shape[1] == 2 * 16 + 128
    losses = [e["loss"] for e in m_t.epoch_stats]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]

    monkeypatch.setattr(jeval, "rank_invariant", lambda name: False)
    jeval._CHUNK_FN_CACHE.clear()
    try:
        rec_j, mrr_j = jeval.evaluate(m_j, test, cut_off=[1, 10], batch_size=12)
    finally:
        jeval._CHUNK_FN_CACHE.clear()
    rec_t, mrr_t = gru4rec_tpu_torch.evaluate(m_t, test, cut_off=[1, 10], batch_size=12)
    np.testing.assert_allclose(rec_t, rec_j, atol=0.02)
    np.testing.assert_allclose(mrr_t, mrr_j, atol=0.02)
