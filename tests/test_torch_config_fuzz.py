"""The JAX package's config-surface fuzz through the port alone, on the CPU.

The same draws as ``tests/test_config_fuzz.py`` (its ``draw_config`` and
``sessions``, seed ``1000 + draw``), draws 0-23: that test's 10 and 14 more
from the same generator. Each draw as drawn (dropout, ``compute_dtype``
bfloat16, every state dtype) goes through the user surface of the port:
``fit`` gives no ``error_during_train`` and a finite loss; ``evaluate`` at
@1 and @5 lies in [0, 1] and clears the JAX test's bar (Recall@5 > 0.2, or
> 0.05 under plain SGD); ``savemodel`` -> ``loadmodel`` -> ``evaluate``
gives the same recall within 1e-6; the row-sparse updates are those the
card's ``fuzz`` phase of ``chip_smoke.py`` expects, by kernel mode.

Draw 7 passes here though it fails in the JAX package: the JAX evaluator
ranks its pre-activation logits there, the port the activated scores
(ROADMAP F1). The differential check of the same draws against JAX is
``tests/test_torch_config_fuzz_diff.py``.

Four draws miss the bar at their own seed in the port (ROADMAP S2): 0, 5,
11 and 14. The differential holds each of them to JAX step by step, so the
miss comes from what the packages draw differently (dropout masks,
negatives, stochastic-rounding seeds), and seeds 0-9 of both packages
(``scripts/s1_seed_sweep_torch.py --fuzz-draw D --threads 1``) show the
same distribution (Welch p 0.73, 0.75, 0.80, 0.43). Their case holds the
port over seeds 0-9 instead. Draw 0: its mean Recall@5 clears the bar, as
the JAX package's does. Draws 5, 11 and 14 depart from the JAX test's bar,
because the JAX package misses it on its own seed means (0.157, 0.130 and
0.149 against 0.2, hazard F11), and no bar above chance (~0.125) is
cleared by the JAX package there either. There the port's mean is held to
the JAX package's, less two standard errors of the difference of the
means (below chance on draw 11, so that alone does not show training);
on draws 5 and 11, where the JAX package's training loss falls from epoch
1 to epoch 2 at every seed, the port's must fall at every seed too. On
draw 14 it falls at only 6 of 10 seeds in the JAX package, so neither
recall nor loss tells training from none at this budget: that draw's
training is held by the differential test alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch import GRU4Rec, GRU4RecConfig  # noqa: E402
from test_config_fuzz import draw_config, sessions  # noqa: E402


def surface(draw, tmp_path, monkeypatch):
    """Fit, evaluate and round-trip draw ``draw``; returns its config and
    Recall@1/5. The row-sparse updates are counted by the kernel mode they
    would launch on the card (``sparse_update.mode_of``): those that
    ``chip_smoke.py``'s ``fuzz`` phase expects of the config, once per
    step."""
    import chip_smoke
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    kw = draw_config(np.random.RandomState(1000 + draw))
    data, test = sessions(120, seed=draw), sessions(25, seed=100 + draw)
    modes = {}
    fused = sparse_update.fused_update

    def counted(opt, table, idx, g, st, sr_seed=None):
        mode = sparse_update.mode_of(opt.adapt, table.shape[1], opt.sr_active(st))
        modes[mode] = modes.get(mode, 0) + 1
        return fused(opt, table, idx, g, st, sr_seed=sr_seed)

    monkeypatch.setattr(sparse_update, "fused_update", counted)
    m = GRU4Rec(GRU4RecConfig(**kw), device="cpu")
    m.fit(data)
    assert not m.error_during_train, kw
    steps = sum(e["steps"] for e in m.epoch_stats)
    per_step = chip_smoke.fuzz_launches_per_step(m.config, chip_smoke.fuzz_tables(m))
    assert modes == {k: n * steps for k, n in per_step.items()}, (kw, modes, per_step)
    assert np.isfinite(m.epoch_stats[-1]["loss"]), kw
    rec, mrr = gru4rec_tpu_torch.evaluate(m, test, cut_off=[1, 5], batch_size=8)
    for v in rec + mrr:
        assert 0.0 <= v <= 1.0, (kw, rec, mrr)
    path = str(tmp_path / f"m{draw}.npz")
    m.savemodel(path)
    m2 = GRU4Rec.loadmodel(path, device="cpu")
    rec2, _ = gru4rec_tpu_torch.evaluate(m2, test, cut_off=[1, 5], batch_size=8)
    np.testing.assert_allclose(rec2, rec, atol=1e-6, err_msg=str(kw))
    return kw, rec


def bar(kw):
    """The JAX test's bar on Recall@5: random recall@5 on the 40-item
    catalog is ~0.125; plain SGD at this budget clears only a weaker bar."""
    return 0.05 if kw["adapt"] is None else 0.2


# Recall@5 of the JAX package at seeds 0-9 on the draws of S2 (its
# activated-score path, F1), from ``JAX_PLATFORMS=cpu python
# scripts/s1_seed_sweep_torch.py --fuzz-draw D --threads 1``
S2_JAX_RECALL5 = {
    0: [0.1, 0.16, 0.24, 0.19, 0.14, 0.28, 0.13, 0.1, 0.29, 0.23],
    5: [0.1744186046511628, 0.11627906976744186, 0.10465116279069768,
        0.29069767441860467, 0.2558139534883721, 0.12790697674418605,
        0.16279069767441862, 0.10465116279069768, 0.09302325581395349,
        0.13953488372093023],
    11: [0.11392405063291139, 0.10126582278481013, 0.12658227848101267,
         0.12658227848101267, 0.11392405063291139, 0.13924050632911392,
         0.16455696202531644, 0.16455696202531644, 0.13924050632911392,
         0.11392405063291139],
    14: [0.14583333333333334, 0.19791666666666666, 0.0625, 0.16666666666666666,
         0.22916666666666666, 0.09375, 0.14583333333333334, 0.14583333333333334,
         0.17708333333333334, 0.125],
}
# The F11 draws on which the JAX package's training loss falls from epoch 1
# to epoch 2 at each of seeds 0-9 (the same script's ``jax_epoch_losses``)
S2_JAX_LOSS_FALLS = (5, 11)


def port_seeds(draw):
    """The port's Recall@5 and epoch losses on draw ``draw`` at seeds 0-9
    (the script's runs, on the port's side)."""
    kw = draw_config(np.random.RandomState(1000 + draw))
    data, test = sessions(120, seed=draw), sessions(25, seed=100 + draw)
    recalls, losses = [], []
    for seed in range(10):
        m = GRU4Rec(GRU4RecConfig(**dict(kw, seed=seed)), device="cpu")
        m.fit(data)
        recalls.append(gru4rec_tpu_torch.evaluate(m, test, cut_off=[5], batch_size=8)[0][0])
        losses.append([e["loss"] for e in m.epoch_stats])
    return recalls, losses


@pytest.mark.parametrize("draw", range(24))
def test_random_config_full_surface(draw, tmp_path, monkeypatch):
    kw, rec = surface(draw, tmp_path, monkeypatch)
    if draw not in S2_JAX_RECALL5:
        assert rec[1] > bar(kw), (kw, rec)
        return
    recalls, losses = port_seeds(draw)
    port, jax_ = np.array(recalls), np.array(S2_JAX_RECALL5[draw])
    if jax_.mean() > bar(kw):
        assert port.mean() > bar(kw), (kw, port)
        return
    # F11: the JAX package misses its own bar on this draw's mean
    se = np.sqrt(port.var(ddof=1) / 10 + jax_.var(ddof=1) / 10)
    assert port.mean() >= jax_.mean() - 2 * se, (kw, port, jax_)
    if draw in S2_JAX_LOSS_FALLS:
        assert all(ls[-1] < ls[0] for ls in losses), (kw, losses)


def test_chip_smoke_draws_are_the_jax_tests():
    """``chip_smoke.py``'s ``fuzz`` phase draws from its own copy of the
    generator (it imports nothing of the JAX package): the same configs
    and sessions, and its width-128 runs change the widths only."""
    import chip_smoke

    runs = chip_smoke.fuzz_runs()
    assert len(runs) == 32
    for draw in range(24):
        want = draw_config(np.random.RandomState(1000 + draw))
        assert chip_smoke.fuzz_draw_config(np.random.RandomState(1000 + draw)) == want
        assert runs[draw] == (draw, "drawn", want)
        for seed in (draw, 100 + draw):
            assert chip_smoke.fuzz_sessions(25, seed).equals(sessions(25, seed))
    for draw, width, kw in runs[24:]:
        want = draw_config(np.random.RandomState(1000 + draw))
        assert width == 128 and kw["layers"] == [128] * len(want["layers"])
        assert kw.get("embedding") == (128 if "embedding" in want else None)
        assert {k: v for k, v in kw.items() if k not in ("layers", "embedding")} == \
            {k: v for k, v in want.items() if k not in ("layers", "embedding")}
    assert [r[0] for r in runs[24:]] == list(range(8))


@pytest.mark.parametrize("draw", [17, 18, 20, 23])
def test_chip_smoke_adam_direction_is_the_step(draw):
    """The card-against-CPU check of ``chip_smoke.py``'s ``fuzz`` phase
    allows each adam entry lr times the difference of the directions the
    two devices' moments give: on the CPU, the direction it reads from the
    state (``_adam_moments``, ``_adam_direction``) is the step the port took
    on every entry a step touched, for every adam draw (without momentum and
    L2, so the step is lr times the direction)."""
    import chip_smoke
    from gru4rec_tpu_torch.ops.sampling import draw_negatives
    from gru4rec_tpu_torch.train import step as tstep
    from gru4rec_tpu_torch.train.optimizers import make_optimizer

    kw = dict(draw_config(np.random.RandomState(1000 + draw)), momentum=0.0, lmbd=0.0,
              dropout_p_hidden=0.0, dropout_p_embed=0.0, compute_dtype="float32")
    assert kw["adapt"] == "adam"
    cfg = GRU4RecConfig(**kw)
    model, built = chip_smoke._fit_built(cfg, sessions(120, seed=draw))
    n, sched = model.n_items, built["schedules"][0]
    neg = draw_negatives(tstep.make_generator(cfg.seed, "cpu"), built["samp1"], 3,
                         cfg.n_sample, n, cfg.sample_alpha, cfg.sampler)
    state, fn = tstep.init_train_state(cfg, n, "cpu"), tstep.make_chunk_fn(cfg, n)
    opt = make_optimizer(cfg)
    for t in range(3):
        p0 = {k: v.double().clone() for k, v in chip_smoke._leaves(state.params)}
        before = chip_smoke._adam_moments(cfg, state)
        fn(state, *[a[t:t + 1] for a in (sched.in_idx, sched.out_idx, sched.valid,
                                          sched.reset)],
           built["samp1"], built["logp0"], neg=neg[t:t + 1])
        after = chip_smoke._adam_moments(cfg, state)
        assert set(after) <= set(p0) and "/Wy" in after
        for k, (m, v, c, _, exact) in after.items():
            if not exact:  # stochastically rounded: the stored moments are not the step's
                continue
            touched = torch.as_tensor(c) > torch.as_tensor(before[k][2])
            f = torch.where(touched, chip_smoke._adam_direction(opt, m, v, c), 0.0)
            p = dict(chip_smoke._leaves(state.params))[k].double()
            np.testing.assert_allclose(p, p0[k] - cfg.learning_rate * f, rtol=0, atol=1e-7,
                                       err_msg=f"draw {draw} step {t} {k}")
