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
plain version on the card by the ``cuda``-marked tests, which need no JAX:
every optimizer, the edges of its in-kernel dedup (K = 1, one run over all
K positions, only sentinels, K not a multiple of the warps of a block, K =
9,000, int32 and int64 indices, the last row, a padding row), widths 12 to
513 on both access paths over a 200,064-row table, and
calls under ``torch.cuda.set_sync_debug_mode("error")``:

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


# ---------------------------------------------------------------------------
# The kernel's in-kernel dedup and its two access paths (``vector_path``).

@pytest.mark.parametrize("shape,dtype,offset,expect", [
    ((8, 256), torch.float32, 0, True),
    ((8, 300), torch.float32, 0, True),
    ((8, 12), torch.bfloat16, 0, True),
    ((8, 652), torch.bfloat16, 0, True),    # adam's acc2 at d = 262: 2d + 128
    ((8, 225), torch.float32, 0, False),
    ((8, 513), torch.bfloat16, 0, False),
    ((8, 256), torch.float32, 1, False),    # base pointer 4 bytes off 16
    ((8, 256), torch.float32, 4, True),     # 16 bytes off: still aligned
    ((8, 256), torch.bfloat16, 4, True),    # 8 bytes off: a bf16 access is 8 bytes
    ((8, 256), torch.bfloat16, 2, False),
])
def test_vector_path_needs_aligned_pitches_and_pointers(shape, dtype, offset, expect):
    n = shape[0] * shape[1]
    base = torch.zeros(n + 16, dtype=dtype)  # CPU allocations are 64-byte aligned
    assert base.data_ptr() % 64 == 0
    t = base[offset:offset + n].view(shape)
    assert sparse_update.vector_path(t) is expect


def test_vector_path_needs_every_tensor():
    f32 = torch.zeros(4, 256)
    assert sparse_update.vector_path(f32, torch.zeros(4, 2 * 256 + 128, dtype=torch.bfloat16),
                                     torch.zeros(4, 256, dtype=torch.bfloat16))
    assert not sparse_update.vector_path(f32, torch.zeros(4 * 256 + 1)[1:].view(4, 256))
    assert not sparse_update.vector_path(f32, torch.zeros(4, 225))


def _edge_idx(case, n_rows, rng):
    """Raw indices (int64 numpy) for one edge of the dedup."""
    if case == "K=1":
        return np.array([n_rows - 1])
    if case == "one run, short":  # every position one row, all listed
        return np.full(20, 3)
    if case == "one run, long":  # past the 32 listed: the kernel re-reads idx
        return np.full(300, n_rows - 1)
    if case == "all sentinel":
        return np.full(40, SENTINEL)
    if case == "K=13":  # not a multiple of the 8 warps of a block
        idx = rng.randint(0, n_rows, 13)
        idx[[2, 9]] = n_rows - 1
        idx[5] = SENTINEL
        return idx
    if case == "K=9000":  # a block reads 1,024 indices per round
        idx = rng.randint(0, n_rows // 4, 9000)
        idx[rng.choice(9000, 60, replace=False)] = n_rows - 1
        idx[rng.choice(9000, 7, replace=False)] = SENTINEL
        idx[4100] = n_rows + 5  # a padding row, dropped
        return idx
    raise ValueError(case)


EDGE_CASES = ("K=1", "one run, short", "one run, long", "all sentinel", "K=13", "K=9000")


def _card_vs_cpu(kw, n_rows, d, idx, idx_dtype, seed):
    """One kernel call on the card and one plain-version call on the CPU
    from the same inputs. Returns (kernel table, kernel state, plain table,
    plain state, input table, input state, counts of each row)."""
    rng = np.random.RandomState(seed)
    opt = make_optimizer(GRU4RecConfig(**kw))
    table = torch.from_numpy(rng.randn(n_rows, d).astype(np.float32))
    st = opt.init_state(table, sparse=True)
    for k, v in st.items():
        a = (rng.rand(*v.shape) * 0.3).astype(np.float32)
        if k == "acc2" and kw["adapt"] == "adam":
            a[:, 2 * d:] = rng.randint(0, 5, (n_rows, 1))
        st[k] = torch.from_numpy(a).to(v.dtype)
    g = torch.from_numpy((rng.randn(len(idx), d) * 0.1).astype(np.float32))
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(idx_dtype)
    t_k, st_k = table.cuda(), {k: v.cuda() for k, v in st.items()}
    t_p, st_p = table.clone(), {k: v.clone() for k, v in st.items()}
    sparse_update.reset_launches()
    sparse_update.fused_update(opt, t_k, idx_t.cuda(), g.cuda(), st_k)
    torch.cuda.synchronize()
    assert sum(sparse_update.launches_by_mode.values()) == 1
    opt.apply_sparse_plain(t_p, idx_t, g, st_p)
    real = idx[(idx >= 0) & (idx < n_rows)]
    counts = np.bincount(real, minlength=n_rows)
    return (t_k.cpu(), {k: v.cpu() for k, v in st_k.items()}, t_p, st_p, table, st, counts)


def _assert_kernel_matches(t_k, st_k, t_p, st_p, table, st, counts):
    """The existing tolerances (``_assert_close``); rows no index touches
    bit-identical to the inputs."""
    untouched = torch.from_numpy(counts == 0)
    _assert_close("table", t_k, t_p.numpy())
    assert torch.equal(t_k[untouched], table[untouched])
    for k in st_p:
        _assert_close(k + ("_bf16" if st_p[k].dtype == torch.bfloat16 else ""),
                      st_k[k], st_p[k].float().numpy())
        assert torch.equal(st_k[k][untouched], st[k][untouched]), k


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 225])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_kernel_dedup_edges(case, idx_dtype, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_rows = 1000
    idx = _edge_idx(case, n_rows, np.random.RandomState(EDGE_CASES.index(case)))
    for adapt in ("adagrad", "adam"):
        kw = _cfg_kwargs(adapt, 0.4, 0.01, "bfloat16")
        out = _card_vs_cpu(kw, n_rows, d, idx, idx_dtype, seed=d)
        _assert_kernel_matches(*out)
        counts = out[-1]
        if counts.any():  # the most touched row moved
            r = int(counts.argmax())
            assert not torch.equal(out[0][r], out[4][r])


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", ADAPTS)
@pytest.mark.parametrize("d", [12, 128, 225, 256, 300, 513])
def test_cuda_kernel_widths_and_a_large_table(d, adapt):
    """Both access paths (vector at 12, 128, 256 and 300; scalar at 225 and
    513), one and several passes, on rees46's 200,064 rows with the last
    row touched twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_rows = 200_064
    rng = np.random.RandomState(d)
    idx = rng.randint(0, n_rows, 700)
    idx[[0, 350]] = n_rows - 1
    idx[[10, 20, 30]] = idx[5]
    idx[-4:] = SENTINEL
    kw = _cfg_kwargs(adapt, 0.4, 0.01, "bfloat16")
    out = _card_vs_cpu(kw, n_rows, d, idx, torch.int32, seed=d + 1)
    _assert_kernel_matches(*out)
    assert not torch.equal(out[0][-1], out[4][-1])


@pytest.mark.cuda
def test_cuda_kernel_call_needs_no_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    opt = make_optimizer(GRU4RecConfig(**_cfg_kwargs("adam", 0.4, 0.01, "bfloat16")))
    table = torch.randn(N_ROWS, D, device="cuda")
    st = opt.init_state(table, sparse=True)
    idx = torch.randint(0, N_ROWS, (K,), device="cuda", dtype=torch.int32)
    g = torch.randn(K, D, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sparse_update.fused_update(opt, table, idx, g, st)
        sparse_update.fused_update(opt, table, idx.long(), g, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
