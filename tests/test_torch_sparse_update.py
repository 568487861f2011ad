"""The port's row-sparse update against the JAX package's.

The port's ``Optimizer.apply_sparse`` on CPU tensors runs the fused
kernel's plain version (the torch-op path). It is held against JAX
``Optimizer.apply_sparse`` on the XLA path and on the Pallas kernel
``_fused_update_v3`` in interpret mode, for every optimizer x momentum x L2
x state dtype, over three steps with duplicated and sentinel indices.
Tolerances: float32 rtol 1e-6 / atol 1e-7 against the XLA path (the
duplicate sums are added in another order) and atol 5e-7 against the Pallas
kernel, which also associates its products otherwise; bfloat16 storage
within one bfloat16 ulp. Rows no index
touches stay bit-identical. The CUDA kernel itself is held against the
plain version on the card by the ``cuda``-marked test, which needs no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_update.py
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
N_ROWS, D, K, STEPS = 64, 128, 24, 3  # v3 needs d % 128 == 0 and a padding group
ADAPTS = ("adagrad", "rmsprop", "adadelta", "adam")


def _cfg_kwargs(adapt, momentum, lmbd, state_dtype):
    return dict(adapt=adapt, momentum=momentum, lmbd=lmbd,
                learning_rate=1.0 if adapt == "adadelta" else 0.1,
                opt_state_dtype=state_dtype)


def _inputs(seed, state_shapes):
    """Table, per-step (idx, g) and initial state values (float32 numpy;
    adam's count block holds small integers)."""
    rng = np.random.RandomState(seed)
    table = rng.randn(N_ROWS, D).astype(np.float32)
    steps = []
    for _ in range(STEPS):
        idx = rng.randint(0, N_ROWS - 8, K).astype(np.int32)
        idx[5] = idx[3]
        idx[7] = idx[3]
        idx[-4:] = SENTINEL
        steps.append((idx, (rng.randn(K, D) * 0.1).astype(np.float32)))
    state = {}
    for k, shape in state_shapes.items():
        v = (rng.rand(*shape) * 0.3).astype(np.float32)
        if k == "acc2" and shape[1] == 2 * D + 128:  # adam count block
            v[:, 2 * D:] = rng.randint(0, 5, (shape[0], 1))
        state[k] = v
    return table, steps, state


def _run_jax(kw, table, steps, state0, monkeypatch, path):
    # imported here: the cuda-marked test runs where JAX is not installed
    jnp = pytest.importorskip("jax.numpy")
    import gru4rec_tpu.train.optimizers as jopt
    from gru4rec_tpu.config import GRU4RecConfig as JaxConfig

    monkeypatch.setattr(jopt, "_FORCE_PALLAS", path == "pallas")
    if path == "pallas":
        monkeypatch.setattr(jopt, "_FORCE_PALLAS_VERSION", "v3")
    opt = jopt.make_optimizer(JaxConfig(**kw))
    st = opt.init_state(jnp.asarray(table), sparse=True)
    st = {k: jnp.asarray(state0[k], dtype=v.dtype) for k, v in st.items()}
    tbl = jnp.asarray(table)
    for idx, g in steps:
        tbl, st = opt.apply_sparse(tbl, jnp.asarray(idx), jnp.asarray(g), st)
    return np.asarray(tbl), {k: np.asarray(v) for k, v in st.items()}


def _run_torch(kw, table, steps, state0, device="cpu"):
    opt = make_optimizer(GRU4RecConfig(**kw))
    tbl = torch.from_numpy(table.copy()).to(device)
    st = opt.init_state(tbl, sparse=True)
    st = {k: torch.tensor(state0[k], device=device).to(v.dtype)
          for k, v in st.items()}
    for idx, g in steps:
        opt.apply_sparse(tbl, torch.from_numpy(idx).to(device),
                         torch.from_numpy(g).to(device), st)
    return tbl, st


def _assert_close(name, got, want, atol=1e-7):
    """float32: rtol 1e-6 / ``atol``; bfloat16: within one bf16 ulp."""
    got, want = got.float().cpu().numpy(), np.asarray(want, dtype=np.float32)
    if name.endswith("bf16"):
        tol = 2.0**-7 * np.maximum(np.abs(got), np.abs(want))
        assert np.all(np.abs(got - want) <= tol), (
            name, float(np.max(np.abs(got - want))))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol, err_msg=name)


def _state_shapes(kw):
    opt = make_optimizer(GRU4RecConfig(**kw))
    return {k: tuple(v.shape) for k, v in
            opt.init_state(torch.zeros(N_ROWS, D), sparse=True).items()}


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lmbd", [0.0, 0.01])
@pytest.mark.parametrize("momentum", [0.0, 0.4])
@pytest.mark.parametrize("adapt", ADAPTS)
def test_apply_sparse_matches_jax(adapt, momentum, lmbd, state_dtype, path,
                                  monkeypatch):
    kw = _cfg_kwargs(adapt, momentum, lmbd, state_dtype)
    table, steps, state0 = _inputs(ADAPTS.index(adapt), _state_shapes(kw))
    t_j, st_j = _run_jax(kw, table, steps, state0, monkeypatch, path)
    t_t, st_t = _run_torch(kw, table, steps, state0)

    # the Pallas kernel associates (1 - v) * g * g and the L2 term otherwise
    # than the XLA path, which the port follows: a few float32 ulps at the
    # table's magnitude (|x| < 4) apart after three steps
    atol = 1e-7 if path == "xla" else 5e-7
    assert set(st_t) == set(st_j)
    _assert_close("table", t_t, t_j, atol)
    for k in st_j:
        assert str(st_t[k].dtype).endswith(str(st_j[k].dtype)), (k, st_t[k].dtype)
        _assert_close(k + ("_bf16" if st_t[k].dtype == torch.bfloat16 else ""),
                      st_t[k], st_j[k].astype(np.float32), atol)

    touched = np.zeros(N_ROWS, bool)
    for idx, _ in steps:
        touched[idx[idx < N_ROWS]] = True
    np.testing.assert_array_equal(t_t.numpy()[~touched], table[~touched])
    for k, v in st_t.items():
        np.testing.assert_array_equal(
            v.float().numpy()[~touched],
            tensor_from_numpy(state0[k], device="cpu").to(v.dtype).float().numpy()[~touched])


def test_cpu_wrapper_takes_plain_version_and_does_not_count():
    kw = _cfg_kwargs("adagrad", 0.4, 0.0, "bfloat16")
    table, steps, state0 = _inputs(0, _state_shapes(kw))
    sparse_update.reset_launches()
    t_t, _ = _run_torch(kw, table, steps, state0)
    assert sum(sparse_update.launches_by_mode.values()) == 0
    opt = make_optimizer(GRU4RecConfig(**kw))
    tbl = torch.from_numpy(table.copy())
    st = {k: torch.tensor(state0[k]).to(v.dtype)
          for k, v in opt.init_state(tbl, sparse=True).items()}
    for idx, g in steps:
        opt.apply_sparse_plain(tbl, torch.from_numpy(idx), torch.from_numpy(g), st)
    assert torch.equal(tbl, t_t)


def test_wrapper_rejects_other_devices_and_layouts():
    kw = _cfg_kwargs("adam", 0.0, 0.0, "float32")
    opt = make_optimizer(GRU4RecConfig(**kw))
    tbl = torch.zeros(N_ROWS, D, device="meta")
    st = opt.init_state(tbl, sparse=True)
    with pytest.raises(ValueError, match="device"):
        sparse_update.fused_update(opt, tbl, torch.zeros(K, dtype=torch.int32, device="meta"),
                                   torch.zeros(K, D, device="meta"), st)
    with pytest.raises(ValueError, match="acc2"):
        sparse_update._check(opt, tbl, torch.zeros(K, dtype=torch.int32, device="meta"),
                             torch.zeros(K, D, device="meta"), {"acc": tbl})


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.0, 0.4])
@pytest.mark.parametrize("adapt", ADAPTS)
def test_cuda_kernel_matches_plain_version(adapt, momentum, state_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = _cfg_kwargs(adapt, momentum, 0.01, state_dtype)
    table, steps, state0 = _inputs(1, _state_shapes(kw))
    sparse_update.reset_launches()
    t_k, st_k = _run_torch(kw, table, steps, state0, device="cuda")
    torch.cuda.synchronize()
    assert sum(sparse_update.launches_by_mode.values()) == STEPS
    t_p, st_p = _run_torch(kw, table, steps, state0, device="cpu")
    _assert_close("table", t_k, t_p.numpy())
    for k in st_p:
        _assert_close(k + ("_bf16" if st_p[k].dtype == torch.bfloat16 else ""),
                      st_k[k], st_p[k].float().numpy())
