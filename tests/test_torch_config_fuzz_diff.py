"""The JAX package's config-surface fuzz as a differential check of the
port, on the CPU: the same draws (``draw_config`` and ``sessions`` of
``tests/test_config_fuzz.py``, seed ``1000 + draw``), draws 0-23.

Each draw runs with ``dropout_p_* = 0`` (the packages draw different masks)
and ``compute_dtype="float32"``; every other field is the draw's:

* **schedules**: both packages' ``fit`` run with their chunk functions
  replaced by a stub that trains nothing, and the schedules they build
  (one per epoch under ``train_random_order``, else one for all) are
  recorded: equal arrays, the same item map, the same sampler table
  (alias or CDF) and ``logq`` table;
* **steps**: over those schedules, each package's ``make_chunk_fn`` one
  step at a time from the same state (``io/convert.py``), the port fed
  the JAX package's negatives of that step, drawn with the draw's
  ``sampler`` and ``sample_alpha``, and under ``bfloat16_sr`` its
  stochastic-rounding seeds: per-step loss within rtol 1e-4 (1e-7
  absolute where it has cancelled to ~1e-4), every parameter within atol
  1e-5 and every float32 state leaf within atol 1e-5 + rtol 1e-6 after
  every step; bfloat16 state within one bf16 ulp, and the stochastically
  rounded columns bit-equal on at least 99% of the entries the steps
  changed, pooled over the run (90% on each step), and on all others (the
  tolerances of ``tests/test_torch_slice.py`` and
  ``tests/test_torch_slice_sr.py``, with the float32 summation floor
  that a converged loss and an accumulator past 10 need: draws 18 and 12).
  ``dedup_impl`` is accepted and ignored by the port (``config.py``):
  JAX's "sort" and "matmul" paths both land within these float32
  summation tolerances of it;
* **evaluate** on the last step's weights within 1e-6 of JAX's
  ``evaluate`` (its activated-score path, ROADMAP F1);
* **checkpoints across packages**: the JAX model's ``savemodel`` archive,
  loaded by the port, scores the test sessions within 1e-6 of JAX;
* every activation's gradient at exact zeros and ties equals JAX's (fault
  F10: relu's derivative at 0, which draw 11 found).

The draws are split over this file (0-11) and
``tests/test_torch_config_fuzz_diff2.py`` (12-23), so that each file keeps
to its time on one test worker; the surface of the port alone is
``tests/test_torch_config_fuzz.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gru4rec_tpu  # noqa: E402
from gru4rec_tpu.eval import evaluation as jeval  # noqa: E402
from gru4rec_tpu.models import gru4rec as jmodel  # noqa: E402
from gru4rec_tpu.ops.sampling import draw_negatives as jax_draw_negatives  # noqa: E402
from gru4rec_tpu.ops.sr import seed_from_key  # noqa: E402
from gru4rec_tpu.train import step as jstep  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.io.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from gru4rec_tpu_torch.models import gru4rec as tmodel  # noqa: E402
from gru4rec_tpu_torch.models.gru import input_mode  # noqa: E402
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402
from test_config_fuzz import draw_config, sessions  # noqa: E402

DRAWS = range(12)
CUTOFFS = [1, 5]


def diff_kwargs(draw):
    """The draw's config as the differential runs it."""
    kw = draw_config(np.random.RandomState(1000 + draw))
    kw.update(dropout_p_hidden=0.0, dropout_p_embed=0.0, compute_dtype="float32")
    return kw


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def sync_from_jax(tstate, jstate):
    tstate.params = params_from_jax(_np(jstate.params), device="cpu")
    tstate.opt_state = opt_state_from_jax(_np(jstate.opt_state), device="cpu")
    tstate.H = [torch.from_numpy(np.array(h)) for h in jstate.H]


def sr_columns(name, leaf, cfg):
    """The columns of optimizer-state leaf ``name`` that are stored with
    stochastic rounding under ``bfloat16_sr``, or None: every column of a
    sparse adagrad ``acc``; of adam's merged ``acc2`` = [acc | meang | count
    block] the ``acc`` columns, and the ``meang`` columns too under a slow
    first moment (``train/optimizers.py``); ``meang`` is rounded to nearest
    otherwise, and the count limbs are exact."""
    parts = name.split("/")
    if parts[1] != "sparse" or leaf.dtype != torch.bfloat16:
        return None
    if parts[-1] == "acc" and cfg.adapt == "adagrad":
        return slice(None)
    if parts[-1] == "acc2" and cfg.adapt == "adam":
        d = (leaf.shape[1] - 128) // 2
        slow_v1 = (cfg.adapt_params or [0.9])[0] > 0.99
        return slice(0, 2 * d if slow_v1 else d)
    return None


def assert_state_close(tstate, jstate, before, cfg, where, sr_tally, worst):
    """Parameters within atol 1e-5; float32 optimizer state within atol
    1e-5 + rtol 1e-6 (accumulators grow past 10, where 1e-5 is under eight
    float32 ulps of a value summed in another order); bfloat16 state within
    one bf16 ulp. Under ``bfloat16_sr`` the stochastically rounded columns
    (:func:`sr_columns`) are bit-equal on every entry the step left alone,
    and on at least 90% of those it changed; ``sr_tally`` ([equal,
    changed]) pools the changed entries over the run, which the caller
    holds to 99% (a value on a rounding boundary may round the other way;
    a wrong dither disagrees on about half). The tables have 40 rows of
    width 7-36, so a step changes a few dozen such entries and one flip is
    2% of a step's."""
    jl = dict(_leaves(_np(jstate.params)))
    tl = dict(_leaves(tstate.params))
    assert set(tl) == set(jl), (where, set(tl) ^ set(jl))
    for k, want in jl.items():
        np.testing.assert_allclose(tl[k].numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=f"{where} params{k}")
        worst["params"] = max(worst["params"], float(np.abs(tl[k].numpy() - want).max()))
    jl = dict(_leaves(_np(jstate.opt_state)))
    tl = dict(_leaves(tstate.opt_state))
    assert set(tl) == set(jl), (where, set(tl) ^ set(jl))
    for k, want in jl.items():
        got = tl[k]
        gf, wf = got.float().numpy(), want.astype(np.float32)
        if got.dtype == torch.bfloat16:
            tol = 2.0**-7 * np.maximum(np.abs(gf), np.abs(wf)) + 1e-8
            assert np.all(np.abs(gf - wf) <= tol), f"{where} opt{k}"
            cols = (sr_columns(k, got, cfg) if cfg.opt_state_dtype == "bfloat16_sr"
                    else None)
            if cols is not None:
                gb = got.view(torch.int16).numpy()[..., cols]
                wb = want.view(np.int16)[..., cols]
                bb = before[k].view(torch.int16).numpy()[..., cols]
                changed = (gb != bb) | (wb != bb)
                assert (gb == wb)[~changed].all(), f"{where} opt{k}"
                if changed.any():
                    share = float((gb == wb)[changed].mean())
                    assert share >= 0.9, (where, k, share)
                    sr_tally[0] += int((gb == wb)[changed].sum())
                    sr_tally[1] += int(changed.sum())
        else:
            np.testing.assert_allclose(gf, wf, rtol=1e-6, atol=1e-5,
                                       err_msg=f"{where} opt{k}")
            worst["state"] = max(worst["state"], float(np.abs(gf - wf).max()))


def fit_schedules(pkg, model_mod, kw, data, monkeypatch, **model_kw):
    """``pkg.GRU4Rec(kw).fit(data)`` with the chunk function replaced by a
    stub that trains nothing: the model (item map, catalog) and what fit
    built for training, ``{"schedules": [...], "samp1": ..., "logp0": ...}``."""
    built = {"schedules": []}
    build = model_mod.build_schedule

    def recorded(*a, **k):
        built["schedules"].append(build(*a, **k))
        return built["schedules"][-1]

    def stub_chunk_fn(cfg, n_items, *a, **k):
        def chunk_fn(state, in_c, out_c, valid_c, reset_c, samp1, logp0, **_):
            built["samp1"], built["logp0"] = np.asarray(samp1), np.asarray(logp0)
            if pkg is gru4rec_tpu:
                return state, jnp.zeros(()), jnp.sum(valid_c).astype(jnp.float32)
            return torch.zeros(()), int(np.asarray(valid_c).sum())
        return chunk_fn

    with monkeypatch.context() as mp:
        mp.setattr(model_mod, "build_schedule", recorded)
        mp.setattr(model_mod, "make_chunk_fn", stub_chunk_fn)
        m = pkg.GRU4Rec(pkg.GRU4RecConfig(**kw), **model_kw)
        m.fit(data)
    return m, built


def jax_evaluate(model, test, monkeypatch, **kw):
    """JAX ``evaluate`` on its activated-score path (F1)."""
    with monkeypatch.context() as mp:
        mp.setattr(jeval, "rank_invariant", lambda name: False)
        jeval._CHUNK_FN_CACHE.clear()
        try:
            return jeval.evaluate(model, test, **kw)
        finally:
            jeval._CHUNK_FN_CACHE.clear()


def jax_sr_seed(key, step, table):
    """The JAX chunk function's SR seed of ``table`` at global ``step``."""
    step_key = jax.random.fold_in(jax.random.fold_in(key, 0), step)
    return int(seed_from_key(jax.random.fold_in(step_key, jstep.SR_TABLE_SALT[table])))


def run_draw(draw, monkeypatch, tmp_path):
    """Every check of the module docstring on one draw; returns what was
    compared."""
    kw = diff_kwargs(draw)
    data, test = sessions(120, seed=draw), sessions(25, seed=100 + draw)

    # schedules, item maps and sampler tables, as each package's fit builds them
    m_j, built_j = fit_schedules(gru4rec_tpu, jmodel, kw, data, monkeypatch)
    m_t, built_t = fit_schedules(gru4rec_tpu_torch, tmodel, kw, data, monkeypatch,
                                 device="cpu")
    assert (m_t.itemidmap.index == m_j.itemidmap.index).all()
    n_sched = kw["n_epochs"] if kw["train_random_order"] else 1
    assert len(built_j["schedules"]) == len(built_t["schedules"]) == n_sched
    for sj, st in zip(built_j["schedules"], built_t["schedules"]):
        assert sj.n_steps == st.n_steps
        for a in ("in_idx", "out_idx", "valid", "reset"):
            np.testing.assert_array_equal(getattr(st, a), getattr(sj, a), err_msg=a)
    np.testing.assert_array_equal(built_t["samp1"], built_j["samp1"])
    np.testing.assert_array_equal(built_t["logp0"], built_j["logp0"])

    cfg_j = gru4rec_tpu.GRU4RecConfig(**kw)
    cfg_t = gru4rec_tpu_torch.GRU4RecConfig(**kw)
    n_items = m_j.n_items
    key = jax.random.PRNGKey(cfg_j.seed)  # the chunk function donates the state's
    jstate = jstep.init_train_state(cfg_j, n_items, jax.random.PRNGKey(cfg_j.seed))
    tstate = tstep.TrainState(None, None, None, tstep.make_generator(cfg_t.seed, "cpu"))
    sync_from_jax(tstate, jstate)
    names = tstep.sparse_table_names(input_mode(cfg_t))
    sr = cfg_t.opt_state_dtype == "bfloat16_sr"
    jchunk = jstep.make_chunk_fn(cfg_j, n_items)
    tchunk = tstep.make_chunk_fn(cfg_t, n_items)
    samp_j, lp_j = jnp.asarray(built_j["samp1"]), jnp.asarray(built_j["logp0"])
    samp_t, lp_t = torch.from_numpy(built_t["samp1"]), torch.from_numpy(built_t["logp0"])
    n_sample = cfg_j.n_sample
    steps, max_loss_rel, sr_tally = 0, 0.0, [0, 0]
    worst = {"params": 0.0, "state": 0.0}  # largest float32 differences
    for epoch in range(cfg_j.n_epochs):
        sched = built_j["schedules"][epoch if kw["train_random_order"] else 0]
        jstate = jstate._replace(H=tuple(jnp.zeros_like(h) for h in jstate.H))
        sync_from_jax(tstate, jstate)
        for t in range(sched.n_steps):
            sl = [a[t:t + 1] for a in (sched.in_idx, sched.out_idx, sched.valid,
                                       sched.reset)]
            step = int(jstate.step)
            neg = None
            if n_sample:
                nk = jax.random.fold_in(jax.random.fold_in(key, 1), step)
                neg = torch.from_numpy(np.array(jax_draw_negatives(
                    nk, samp_j, 1, n_sample, n_items, cfg_j.sample_alpha,
                    cfg_j.sampler)))
            seeds = ({n: np.array([jax_sr_seed(key, step, n)], np.int32) for n in names}
                     if sr else None)
            before = {k: v.clone() for k, v in _leaves(tstate.opt_state)}
            jstate, ls_j, _ = jchunk(jstate, *map(jnp.asarray, sl), samp_j, lp_j)
            ls_t, ec = tchunk(tstate, *sl, samp_t, lp_t, neg=neg, sr_seeds=seeds)
            assert ec == int(sl[2].sum())
            where = f"draw {draw} epoch {epoch} step {t}"
            # rtol 1e-4; a loss that has cancelled to ~1e-4 (a converged
            # cross-entropy) carries ~1e-8 of float32 rounding: 1e-7 absolute
            np.testing.assert_allclose(float(ls_t), float(ls_j), rtol=1e-4, atol=1e-7,
                                       err_msg=where)
            if float(ls_j):
                max_loss_rel = max(max_loss_rel,
                                   abs(float(ls_t) / float(ls_j) - 1.0))
            assert_state_close(tstate, jstate, before, cfg_t, where, sr_tally, worst)
            sync_from_jax(tstate, jstate)
            steps += 1

    if cfg_t.opt_state_dtype == "bfloat16_sr" and cfg_t.adapt in ("adagrad", "adam"):
        assert sr_tally[1] > 0 and sr_tally[0] >= 0.99 * sr_tally[1], sr_tally

    # evaluate on the same weights
    m_j.params = jstate.params
    m_t.params = params_from_jax(_np(jstate.params), device="cpu")
    rec_j, mrr_j = jax_evaluate(m_j, test, monkeypatch, cut_off=CUTOFFS, batch_size=8)
    rec_t, mrr_t = gru4rec_tpu_torch.evaluate(m_t, test, cut_off=CUTOFFS, batch_size=8)
    np.testing.assert_allclose(rec_t, rec_j, rtol=0, atol=1e-6, err_msg=str(kw))
    np.testing.assert_allclose(mrr_t, mrr_j, rtol=0, atol=1e-6, err_msg=str(kw))

    # the JAX archive, loaded by the port
    path = str(tmp_path / "jax.npz")
    m_j.savemodel(path)
    m_l = gru4rec_tpu_torch.GRU4Rec.loadmodel(path, device="cpu")
    rec_l, mrr_l = gru4rec_tpu_torch.evaluate(m_l, test, cut_off=CUTOFFS, batch_size=8)
    np.testing.assert_allclose(rec_l, rec_j, rtol=0, atol=1e-6, err_msg=str(kw))
    np.testing.assert_allclose(mrr_l, mrr_j, rtol=0, atol=1e-6, err_msg=str(kw))
    return {"steps": steps, "max_loss_rel": max_loss_rel, "sr_tally": sr_tally,
            **worst, "recall": rec_j}


@pytest.mark.parametrize("draw", DRAWS)
def test_draw_steps_evaluate_and_archive_match_jax(draw, monkeypatch, tmp_path):
    out = run_draw(draw, monkeypatch, tmp_path)
    assert out["steps"] > 50, out


@pytest.mark.parametrize("name", ["linear", "tanh", "relu", "sigmoid", "softmax",
                                  "softmax_logit", "leaky-0.1", "elu-0.5", "elu-1",
                                  "selu-1.05-1.67"])
def test_activation_gradients_at_ties_match_jax(name):
    """F10: each activation's gradient on inputs with exact zeros and ties
    equals JAX's. relu was ``clamp(x, min=0)``, whose derivative at 0 is 1
    where ``jnp.maximum(x, 0)``'s is 0.5; draw 11 (relu hidden layers) then
    updated a bias from a zero pre-activation at twice JAX's gradient."""
    from gru4rec_tpu.ops.activations import get_activation as jax_activation
    from gru4rec_tpu_torch.ops.activations import get_activation

    rng = np.random.RandomState(0)
    x = rng.randn(6, 10).astype(np.float32)
    x[:, :3] = 0.0
    x[1, 5] = x[1, 6] = 1.5  # a tie within a row
    w = rng.randn(6, 10).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax_activation(name)(v) * w))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (get_activation(name)(xt) * torch.from_numpy(w)).sum().backward()
    # float32 rounding of the derivative formulas; a tie rule differs by 0.5
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)
