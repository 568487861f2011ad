"""The port's row-sparse update in its other kernel modes, against JAX.

Every step runs in both packages from the same state (JAX's, carried
across), over three steps with duplicated and sentinel indices.

* K2 / K3, stochastic-rounding state (``opt_state_dtype="bfloat16_sr"``):
  the port's plain version (``Optimizer.apply_sparse`` on CPU tensors) is
  held against JAX ``Optimizer.apply_sparse`` with the same SR seed, on the
  XLA path, the Pallas kernel ``_fused_update_v3`` (v3, K2) and
  ``fused_update_v4`` (v4, compact gradients, K3), both in interpret mode,
  for adagrad and adam x momentum {0, 0.5} x L2 {0, 1e-4}, plus adam with a
  slow first moment (v1 = 0.995, stochastically rounded on its own buffer
  columns), at width 128; and at width 12 against the XLA path (v3 and v4
  need a 128-multiple width). Tolerances: table rtol 1e-6 / atol 5e-7; SR
  bf16 state within one bf16 ulp everywhere and bit-equal on at least 99%
  of the touched entries (the Pallas kernels associate some products
  otherwise, so a value on a rounding boundary may round the other way; a
  wrong hash would disagree on about half); adam's limb counts exact;
  untouched rows bit-identical.
* K4, the v2 grid (``_fused_update``, non-SR) forced at the unaligned widths
  300 and 12: every optimizer x momentum x L2 x state dtype, float32 rtol
  1e-6 / atol 5e-7 and bfloat16 within one ulp (the tolerances
  ``tests/test_torch_sparse_update.py`` holds against the Pallas kernel).

The CUDA kernel's SR mode is held against the plain version on the card by
the ``cuda``-marked tests, also through the edges of the kernel's in-kernel
dedup (K = 1, one run over 300 positions, only sentinels, K = 13, K =
9,000; int32 and int64 indices; widths 256, 12 and 513) on a
70,000-row table with the last row touched (``python -m pytest
--noconftest -m cuda tests/test_torch_sparse_update_sr.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gru4rec_tpu_torch.config import GRU4RecConfig  # noqa: E402
from gru4rec_tpu_torch.io.convert import tensor_from_numpy  # noqa: E402
from gru4rec_tpu_torch.ops.kernels import sparse_update  # noqa: E402
from gru4rec_tpu_torch.train.optimizers import make_optimizer  # noqa: E402

SENTINEL = np.iinfo(np.int32).max
N_ROWS, K, STEPS = 64, 24, 3
SR_CASES = [(a, m, l, None) for a in ("adagrad", "adam")
            for m in (0.0, 0.5) for l in (0.0, 1e-4)] + [("adam", 0.5, 1e-4, [0.995, 0.999])]
ADAPTS = ("adagrad", "rmsprop", "adadelta", "adam")


def _kw(adapt, momentum, lmbd, state_dtype, adapt_params=None):
    kw = dict(adapt=adapt, momentum=momentum, lmbd=lmbd,
              learning_rate=1.0 if adapt == "adadelta" else 0.1,
              opt_state_dtype=state_dtype)
    if adapt_params:
        kw["adapt_params"] = adapt_params
    return kw


def _inputs(seed, d, kw):
    """Table, per-step (idx, g, sr seed) and initial state (numpy; bf16
    state as bf16-representable float32; adam's SR count block holds limbs,
    some at 255 so the next step carries)."""
    rng = np.random.RandomState(seed)
    table = rng.randn(N_ROWS, d).astype(np.float32)
    steps = []
    for _ in range(STEPS):
        idx = rng.randint(0, N_ROWS - 8, K).astype(np.int32)
        idx[5] = idx[3]
        idx[7] = idx[3]
        idx[-4:] = SENTINEL
        steps.append((idx, (rng.randn(K, d) * 0.1).astype(np.float32),
                      int(rng.randint(-2**31, 2**31 - 1))))
    opt = make_optimizer(GRU4RecConfig(**kw))
    state = {}
    for k, v in opt.init_state(torch.zeros(N_ROWS, d), sparse=True).items():
        a = (rng.rand(*v.shape) * 0.3).astype(np.float32)
        if k == "acc2" and kw["adapt"] == "adam":
            if v.dtype == torch.bfloat16:  # SR: limbs lo, mid, hi; zeros
                a[:, 2 * d:] = 0.0
                a[:, 2 * d] = rng.choice([0, 7, 254, 255], N_ROWS)
                a[:, 2 * d + 1] = rng.choice([0, 3, 255], N_ROWS)
                a[:, 2 * d + 2] = rng.randint(0, 3, N_ROWS)
            else:
                a[:, 2 * d:] = rng.randint(0, 5, (N_ROWS, 1))
        state[k] = tensor_from_numpy(a, device="cpu").to(v.dtype)
    return table, steps, state


def _jax_opt(kw, monkeypatch, path):
    pytest.importorskip("jax")
    import gru4rec_tpu.train.optimizers as jopt
    from gru4rec_tpu.config import GRU4RecConfig as JaxConfig

    monkeypatch.setattr(jopt, "_FORCE_PALLAS", path != "xla")
    if path != "xla":
        monkeypatch.setattr(jopt, "_FORCE_PALLAS_VERSION", path)
    return jopt.make_optimizer(JaxConfig(**kw))


def _to_jax(t):
    """A JAX array from a private copy of ``t``: a JAX CPU array may share
    its numpy source's memory, and the Pallas kernels alias their table and
    state inputs to their outputs."""
    import jax.numpy as jnp

    a = t.float().numpy().copy()
    return jnp.asarray(a, dtype=jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _steps_from_jax_state(kw, table, steps, state0, monkeypatch, path):
    """Each step run by both packages from the same (JAX's) state, with
    JAX's SR seed; yields (idx, port table, port state, JAX table, JAX state,
    table before the step)."""
    import jax

    opt_j = _jax_opt(kw, monkeypatch, path)
    opt_t = make_optimizer(GRU4RecConfig(**kw))
    tbl = torch.from_numpy(table.copy())
    st = {k: v.clone() for k, v in state0.items()}
    for i, (idx, g, _) in enumerate(steps):
        key = jax.random.PRNGKey(i)
        t_j, st_j = opt_j.apply_sparse(_to_jax(tbl), jax.numpy.asarray(idx),
                                       jax.numpy.asarray(g),
                                       {k: _to_jax(v) for k, v in st.items()}, key=key)
        sr_seed = None
        if opt_t.state_sr:
            from gru4rec_tpu.ops.sr import seed_from_key

            sr_seed = (int(seed_from_key(key)), 0)
        before = tbl.clone()
        opt_t.apply_sparse(tbl, torch.from_numpy(idx), torch.from_numpy(g), st,
                           sr_seed=sr_seed)
        t_j = np.asarray(t_j)
        st_j = {k: np.asarray(v) for k, v in st_j.items()}
        yield idx, tbl, st, t_j, st_j, before.numpy()
        tbl = torch.from_numpy(t_j.copy())
        st = {k: tensor_from_numpy(v, device="cpu") for k, v in st_j.items()}


def _run_torch(kw, table, steps, state0, device="cpu", plain=False):
    """Three steps on the port alone, with each step's own SR seed."""
    opt = make_optimizer(GRU4RecConfig(**kw))
    tbl = torch.from_numpy(table.copy()).to(device)
    st = {k: v.clone().to(device) for k, v in state0.items()}
    for idx, g, seed in steps:
        apply = opt.apply_sparse_plain if plain else opt.apply_sparse
        apply(tbl, torch.from_numpy(idx).to(device), torch.from_numpy(g).to(device), st,
              sr_seed=(seed, 0) if opt.state_sr else None)
    return tbl, st


def _bf16_bits(a):
    if torch.is_tensor(a):
        return a.cpu().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def assert_sr_state_close(name, got, want, touched, min_equal=0.99):
    """One bf16 ulp everywhere; bit-equal on ``min_equal`` of the touched
    entries and on every untouched one. Returns the bit-equal share."""
    g = got.float().cpu().numpy()
    w = want.float().cpu().numpy() if torch.is_tensor(want) else np.asarray(want, np.float32)
    tol = 2.0**-7 * np.maximum(np.abs(g), np.abs(w))
    assert np.all(np.abs(g - w) <= tol), (name, float(np.max(np.abs(g - w))))
    eq = _bf16_bits(got) == _bf16_bits(want)
    assert eq[~touched].all(), name
    share = float(eq[touched].mean())
    assert share >= min_equal, (name, share)
    return share


def _touched(idx_list):
    t = np.zeros(N_ROWS, bool)
    for idx in idx_list:
        t[idx[idx < N_ROWS]] = True
    return t


def _check_step(kw, idx, t_t, st_t, t_j, st_j, before, d):
    """One step from the same state: table rtol 1e-6 / atol 5e-7 and
    untouched rows bit-identical; float32 state likewise; bf16 SR state as
    in :func:`assert_sr_state_close`, adam's limb counts exact; bf16 state
    without SR within one ulp."""
    touched = _touched([idx])
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=1e-6, atol=5e-7, err_msg="table")
    np.testing.assert_array_equal(t_t.numpy()[~touched], before[~touched])
    assert set(st_t) == set(st_j)
    sr_on = kw["opt_state_dtype"] == "bfloat16_sr"
    for k in st_j:
        assert str(st_t[k].dtype).endswith(str(st_j[k].dtype)), (k, st_t[k].dtype)
        if k == "acc2" and kw["adapt"] == "adam" and sr_on:
            # the limb counts (lanes 0..2) exact, lanes 3.. zero
            cb_t = st_t[k][:, 2 * d:].float().numpy()
            np.testing.assert_array_equal(cb_t, st_j[k][:, 2 * d:].astype(np.float32))
            assert not cb_t[:, 3:].any()
            assert_sr_state_close(k, st_t[k][:, :2 * d], st_j[k][:, :2 * d], touched)
        elif st_t[k].dtype == torch.bfloat16 and sr_on and k != "velocity":
            assert_sr_state_close(k, st_t[k], st_j[k], touched)
        elif st_t[k].dtype == torch.bfloat16:
            got, want = st_t[k].float().numpy(), st_j[k].astype(np.float32)
            assert np.all(np.abs(got - want)
                          <= 2.0**-7 * np.maximum(np.abs(got), np.abs(want))), k
        else:
            np.testing.assert_allclose(st_t[k].numpy(), st_j[k], rtol=1e-6, atol=5e-7,
                                       err_msg=k)


@pytest.mark.parametrize("path", ["xla", "v3", "v4"])
@pytest.mark.parametrize("adapt,momentum,lmbd,adapt_params", SR_CASES)
def test_sr_update_matches_jax(adapt, momentum, lmbd, adapt_params, path, monkeypatch):
    d = 128
    kw = _kw(adapt, momentum, lmbd, "bfloat16_sr", adapt_params)
    table, steps, state0 = _inputs(SR_CASES.index((adapt, momentum, lmbd, adapt_params)),
                                   d, kw)
    assert state0["acc2" if adapt == "adam" else "acc"].dtype == torch.bfloat16
    for args in _steps_from_jax_state(kw, table, steps, state0, monkeypatch, path):
        _check_step(kw, *args, d)


@pytest.mark.parametrize("adapt", ["adagrad", "adam"])
def test_sr_update_matches_jax_at_width_12(adapt, monkeypatch):
    d = 12
    kw = _kw(adapt, 0.5, 1e-4, "bfloat16_sr")
    table, steps, state0 = _inputs(20, d, kw)
    for args in _steps_from_jax_state(kw, table, steps, state0, monkeypatch, "xla"):
        _check_step(kw, *args, d)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lmbd", [0.0, 0.01])
@pytest.mark.parametrize("momentum", [0.0, 0.4])
@pytest.mark.parametrize("adapt", ADAPTS)
@pytest.mark.parametrize("d", [300, 12])
def test_unaligned_width_matches_jax_v2_grid(d, adapt, momentum, lmbd, state_dtype,
                                             monkeypatch):
    kw = _kw(adapt, momentum, lmbd, state_dtype)
    table, steps, state0 = _inputs(ADAPTS.index(adapt) + 30, d, kw)
    for args in _steps_from_jax_state(kw, table, steps, state0, monkeypatch, "v2"):
        _check_step(kw, *args, d)


def test_sr_needs_a_seed_and_is_adagrad_adam_only():
    kw = _kw("adagrad", 0.0, 0.0, "bfloat16_sr")
    table, steps, state0 = _inputs(0, 128, kw)
    opt = make_optimizer(GRU4RecConfig(**kw))
    idx, g, _ = steps[0]
    with pytest.raises(ValueError, match="seed"):
        opt.apply_sparse(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(g), dict(state0))
    # rmsprop under bfloat16_sr keeps round-to-nearest (decay-gated) state
    # and needs no seed; the kernel refuses SR for it
    rms = make_optimizer(GRU4RecConfig(**_kw("rmsprop", 0.0, 0.0, "bfloat16_sr")))
    st = rms.init_state(torch.zeros(N_ROWS, 128), sparse=True)
    assert st["acc"].dtype == torch.bfloat16 and not rms.sr_active(st)
    rms.apply_sparse(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(g), st)
    meta = torch.zeros(N_ROWS, 128, device="meta")
    with pytest.raises(ValueError, match="adagrad/adam"):
        sparse_update._check(rms, meta, torch.zeros(K, dtype=torch.int32, device="meta"),
                             torch.zeros(K, 128, device="meta"),
                             rms.init_state(meta, sparse=True), sr=True)
    # dense state stays float32 under bfloat16_sr
    assert opt.init_state(torch.zeros(4, 8))["acc"].dtype == torch.float32


def test_launch_modes():
    assert sparse_update.mode_of("adagrad", 256, False) == "K1"
    assert sparse_update.mode_of("adagrad", 256, True) == "K2"
    assert sparse_update.mode_of("adam", 12, True) == "K3"
    assert sparse_update.mode_of("rmsprop", 300, False) == "K4"
    sparse_update.reset_launches()
    assert set(sparse_update.launches_by_mode.values()) == {0}


def test_sr_state_carries_across_from_jax_bit_exactly():
    """``io/convert`` keeps bf16 SR state bit for bit (ml_dtypes input)."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.RandomState(3)
    a = (rng.randn(16, 140) * 10).astype(ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(t), a.view(np.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("adapt,momentum,lmbd,adapt_params", SR_CASES)
def test_cuda_sr_kernel_matches_plain_version(adapt, momentum, lmbd, adapt_params):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for d in (128, 300, 12):
        kw = _kw(adapt, momentum, lmbd, "bfloat16_sr", adapt_params)
        table, steps, state0 = _inputs(1, d, kw)
        sparse_update.reset_launches()
        t_k, st_k = _run_torch(kw, table, steps, state0, device="cuda")
        torch.cuda.synchronize()
        mode = "K3" if adapt == "adam" else "K2"
        assert sparse_update.launches_by_mode[mode] == STEPS
        t_p, st_p = _run_torch(kw, table, steps, state0, device="cuda", plain=True)
        np.testing.assert_allclose(t_k.cpu().numpy(), t_p.cpu().numpy(), rtol=1e-5,
                                   atol=1e-6)
        touched = _touched([idx for idx, _, _ in steps])
        for k in st_p:
            assert_sr_state_close(k, st_k[k], st_p[k].cpu(), touched)


def _sr_edge_sets(n_rows, rng):
    """Index sets (int64 numpy) for the edges of the kernel's dedup."""
    k13 = rng.randint(0, n_rows, 13)
    k13[[1, 8]] = n_rows - 1
    k13[4] = SENTINEL
    big = rng.randint(0, n_rows, 9000)  # a block reads 1,024 indices per round
    big[rng.choice(9000, 50, replace=False)] = n_rows - 1
    big[rng.choice(9000, 3, replace=False)] = SENTINEL
    return {"K=1": np.array([n_rows - 1]), "one run": np.full(300, 7),
            "all sentinel": np.full(8, SENTINEL), "K=13": k13, "K=9000": big}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 12, 513])
@pytest.mark.parametrize("adapt", ["adagrad", "adam"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_cuda_sr_kernel_dedup_edges(idx_dtype, adapt, d):
    """SR state through the kernel's dedup edges on a table of 70,000 rows
    (the dither's row above 65,536), against the plain version on the card
    at the tolerances of ``test_cuda_sr_kernel_matches_plain_version``:
    bit-equal on rows touched once, one bf16 ulp elsewhere, limb counts
    exact, untouched rows bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_rows = 70_000
    rng = np.random.RandomState(d)
    kw = _kw(adapt, 0.5, 1e-4, "bfloat16_sr")
    opt = make_optimizer(GRU4RecConfig(**kw))
    table = torch.from_numpy(rng.randn(n_rows, d).astype(np.float32))
    st = opt.init_state(table, sparse=True)
    for k, v in st.items():
        a = (rng.rand(*v.shape) * 0.3).astype(np.float32)
        if k == "acc2":  # limbs lo, mid, hi; zeros
            a[:, 2 * d:] = 0.0
            a[:, 2 * d] = rng.choice([0, 7, 255], n_rows)
            a[:, 2 * d + 1] = rng.choice([0, 255], n_rows)
        st[k] = torch.from_numpy(a).to(v.dtype)
    for case, idx in _sr_edge_sets(n_rows, rng).items():
        g = torch.from_numpy((rng.randn(len(idx), d) * 0.1).astype(np.float32))
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(idx_dtype)
        sr_seed = (int(rng.randint(-2**31, 2**31 - 1)), 0)
        t_k, st_k = table.cuda(), {k: v.cuda() for k, v in st.items()}
        t_p, st_p = table.cuda(), {k: v.cuda() for k, v in st.items()}
        sparse_update.reset_launches()
        opt.apply_sparse(t_k, idx_t.cuda(), g.cuda(), st_k, sr_seed=sr_seed)
        torch.cuda.synchronize()
        assert sparse_update.launches_by_mode["K3" if adapt == "adam" else "K2"] == 1, case
        opt.apply_sparse_plain(t_p, idx_t.cuda(), g.cuda(), st_p, sr_seed=sr_seed)
        t_p, st_p = t_p.cpu(), {k: v.cpu() for k, v in st_p.items()}
        real = idx[(idx >= 0) & (idx < n_rows)]
        counts = np.bincount(real, minlength=n_rows)
        touched, once = counts > 0, counts == 1
        t_k = t_k.cpu()
        np.testing.assert_allclose(t_k.numpy(), t_p.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=case)
        assert torch.equal(t_k[~touched], table[~touched]), case
        for k in st:
            a, b = st_k[k].cpu(), st_p[k]
            assert torch.equal(a[~touched], st[k][~touched]), (case, k)
            if not touched.any():
                continue
            if k == "acc2":
                assert torch.equal(a[:, 2 * d:], b[:, 2 * d:]), (case, "limbs")
                a, b = a[:, :2 * d], b[:, :2 * d]
            if k != "velocity":  # velocity: round to nearest, of a value corr1 moves
                assert (_bf16_bits(a)[once] == _bf16_bits(b)[once]).all(), (case, k)
            assert_sr_state_close(k, a, b, touched, min_equal=0.0)
