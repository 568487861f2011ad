"""The chunk runner of ``gru4rec_tpu_torch/train/step.py`` as one captured
CUDA graph step, and what that design asks of the code around it.

On the CPU (the eager loop, the graph's plain version):

* after a chunk, every parameter, optimizer-state and hidden-state tensor
  keeps its storage (``data_ptr``) and holds the values of the out-of-place
  dense updates that rebound the state's entries, bit for bit, for every
  adapt x momentum x ``opt_state_dtype`` x input mode;
* ``ops.sr.step_seeds`` equals ``step_seed`` element for element;
* the packed step stack round-trips to the schedule slices, and the live
  count the step computes on the device equals the host's counts;
* a 0-d int32 seed tensor and the same int give bit-equal SR state.

On the card (``cuda``-marked, skipped here; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py``):
the graph against the eager loop bit for bit (parameters, optimizer state,
hidden state, loss), dropout masks that differ between replays and equal
the eager loop's, launch counters that count replays, a rebound state that
raises, and the kernel's device seed against its by-value seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as hst  # noqa: E402

from gru4rec_tpu_torch.config import GRU4RecConfig  # noqa: E402
from gru4rec_tpu_torch.models import gru  # noqa: E402
from gru4rec_tpu_torch.ops import sr  # noqa: E402
from gru4rec_tpu_torch.ops.kernels import sparse_update  # noqa: E402
from gru4rec_tpu_torch.ops.kernels.sparse_update import EPSILON  # noqa: E402
from gru4rec_tpu_torch.ops.kernels.sparse_update import log_decay  # noqa: E402
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402
from gru4rec_tpu_torch.train import optimizers  # noqa: E402
from gru4rec_tpu_torch.train.optimizers import Optimizer, make_optimizer  # noqa: E402
from gru4rec_tpu_torch.utils import cuda_graph  # noqa: E402

N_ITEMS, B, N_SAMPLE, T = 30, 4, 6, 7
ADAPTS = (None, "adagrad", "rmsprop", "adadelta", "adam")  # None: plain SGD
MODES = {"constrained": dict(constrained_embedding=True, embedding=0),
         "onehot": dict(constrained_embedding=False, embedding=0),
         "embedding": dict(constrained_embedding=False, embedding=8)}


def small_cfg(adapt="adagrad", momentum=0.3, opt_state_dtype="float32",
              mode="constrained", **kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=B,
                n_sample=N_SAMPLE, sample_alpha=0.0, adapt=adapt, momentum=momentum,
                learning_rate=1.0 if adapt == "adadelta" else 0.05, lmbd=1e-4,
                compute_dtype="float32", opt_state_dtype=opt_state_dtype,
                dropout_p_hidden=0.2, dropout_p_embed=0.1, seed=5, **MODES[mode])
    args.update(kw)
    return GRU4RecConfig(**args)


def schedule(seed=0, steps=T):
    """(in, out, valid, reset) of ``steps`` steps: masked lanes, resets and
    one fully padded step."""
    rng = np.random.RandomState(seed)
    in_c = rng.randint(0, N_ITEMS, (steps, B)).astype(np.int32)
    out_c = rng.randint(0, N_ITEMS, (steps, B)).astype(np.int32)
    valid = rng.rand(steps, B) < 0.8
    valid[2] = False
    reset = rng.rand(steps, B) < 0.3
    return in_c, out_c, valid, reset


def leaves(state):
    """Every tensor of the training state, by path."""
    out = {f"H{i}": h for i, h in enumerate(state.H)}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        else:
            out[prefix] = tree

    walk(state.params, "params")
    walk(state.opt_state, "opt")
    return out


def run_chunks(cfg, state, chunk_fn, n_chunks=2, steps=T):
    samp1 = torch.zeros(1, device=state.params["Wy"].device)
    logp0 = torch.zeros(gru.pad_items(N_ITEMS, cfg.item_pad_multiple),
                        device=state.params["Wy"].device)
    losses = []
    for c in range(n_chunks):
        ls, ec = chunk_fn(state, *schedule(c, steps), samp1, logp0)
        losses.append(ls)
    return losses


# The dense updates as they were written before the state was updated in
# place: each rebinds its state entries to new tensors.
def _rebinding_adapt_dense(self, g, st):
    a = self.adapt
    if a is None:
        return g
    if a == "adagrad":
        acc = st["acc"] + g**2
        st["acc"] = acc
        return g / torch.sqrt(acc + EPSILON)
    if a == "rmsprop":
        acc = self.v1 * st["acc"] + (1.0 - self.v1) * g**2
        st["acc"] = acc
        return g / torch.sqrt(acc + EPSILON)
    if a == "adadelta":
        acc = self.v1 * st["acc"] + (1.0 - self.v1) * g**2
        scaling = (st["upd"] + EPSILON) / (acc + EPSILON)
        st["upd"] = self.v1 * st["upd"] + (1.0 - self.v1) * scaling * g**2
        st["acc"] = acc
        return g * torch.sqrt(scaling)
    acc = self.v2 * st["acc"] + (1.0 - self.v2) * g**2
    meang = self.v1 * st["meang"] + (1.0 - self.v1) * g
    count = st["count"] + 1.0
    t = count if count.dim() == 0 else count[0]
    mhat = meang / -torch.expm1(t * log_decay(self.v1))
    vhat = acc / -torch.expm1(t * log_decay(self.v2))
    st.update(acc=acc, meang=meang, count=count)
    return mhat / (torch.sqrt(vhat) + EPSILON)


def _rebinding_apply_dense(self, p, g, st):
    g = self._adapt_dense(g, st)
    if self.momentum > 0:
        vel = self.momentum * st["velocity"] - self.lr * (g + self.lmbd * p)
        st["velocity"] = vel
        p.add_(vel)
    else:
        p.copy_(p * (1.0 - self.lr * self.lmbd) - self.lr * g)
    return p, st


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16", "bfloat16_sr"])
@pytest.mark.parametrize("momentum", [0.0, 0.3])
@pytest.mark.parametrize("adapt", ADAPTS)
def test_chunk_keeps_state_storage_and_values(adapt, momentum, opt_state_dtype, mode,
                                              monkeypatch):
    cfg = small_cfg(adapt, momentum, opt_state_dtype, mode)
    state = tstep.init_train_state(cfg, N_ITEMS, "cpu")
    before = {k: (v.data_ptr(), v.clone()) for k, v in leaves(state).items()}
    gen = state.gen
    losses = run_chunks(cfg, state, tstep.make_chunk_fn(cfg, N_ITEMS))
    after = leaves(state)
    assert set(after) == set(before)
    assert state.gen is gen and state.step == 2 * T
    for k, v in after.items():
        assert v.data_ptr() == before[k][0], f"{k} was rebound"
    changed = {k for k in after if not torch.equal(after[k], before[k][1])}
    assert any(k.startswith("params/") for k in changed)
    # the dense optimizer state, where there is one (plain SGD without
    # momentum keeps none), moved
    dense_state = {k for k in after if k.startswith("opt/dense")}
    assert not dense_state or dense_state & changed

    monkeypatch.setattr(Optimizer, "_adapt_dense", _rebinding_adapt_dense)
    monkeypatch.setattr(Optimizer, "apply_dense", _rebinding_apply_dense)
    ref = tstep.init_train_state(cfg, N_ITEMS, "cpu")
    ref_losses = run_chunks(cfg, ref, tstep.make_chunk_fn(cfg, N_ITEMS))
    for k, v in leaves(ref).items():
        assert v.dtype == after[k].dtype and torch.equal(v, after[k]), k
    for a, b in zip(losses, ref_losses):
        assert torch.equal(a, b)


@settings(max_examples=200, deadline=None)
@given(seed=hst.integers(-2**31, 2**32 - 1), salt=hst.integers(0, 2**32 - 1),
       steps=hst.lists(hst.integers(0, 2**40), min_size=1, max_size=40))
def test_step_seeds_equal_step_seed(seed, salt, steps):
    got = sr.step_seeds(seed, np.array(steps, dtype=np.int64), salt)
    assert got.dtype == np.int32 and got.shape == (len(steps),)
    assert got.tolist() == [sr.step_seed(seed, s, salt) for s in steps]


@pytest.mark.parametrize("n_sample", [0, N_SAMPLE])
@pytest.mark.parametrize("seed_names", [(), ("Wy",), ("Wx0", "Wy")])
def test_stack_round_trips_to_the_schedule(n_sample, seed_names):
    in_c, out_c, valid, reset = schedule(3)
    rng = np.random.RandomState(1)
    neg = torch.from_numpy(rng.randint(0, N_ITEMS, (T, n_sample)).astype(np.int32))
    seeds = {k: rng.randint(-2**31, 2**31 - 1, T) for k in seed_names}
    layout = tstep.StackLayout(B, n_sample, seed_names)
    stack = layout.pack(in_c, out_c, valid, reset, neg, seeds, "cpu")
    assert stack.dtype == torch.int32 and stack.shape == (T, layout.width)
    assert layout.width == 4 * B + n_sample + len(seed_names)
    for t in range(T):
        i, o, v, r, n, s = layout.split(stack[t])
        np.testing.assert_array_equal(i.numpy(), in_c[t])
        np.testing.assert_array_equal(o.numpy(), out_c[t])
        assert v.dtype == torch.bool and r.dtype == torch.bool
        np.testing.assert_array_equal(v.numpy(), valid[t])
        np.testing.assert_array_equal(r.numpy(), reset[t])
        if n_sample:
            np.testing.assert_array_equal(n.numpy(), neg[t].numpy())
        else:
            assert n is None
        if seed_names:
            assert {k: int(x) for k, x in s.items()} == {k: int(seeds[k][t]) for k in seeds}
            assert all(x.dim() == 0 for x in s.values())
        else:
            assert s is None


def test_device_live_count_equals_counts():
    """``Mf`` as the step computes it from its row, against the host's
    ``valid_c.sum(axis=1)``, and each step's loss weighted by it."""
    in_c, out_c, valid, reset = schedule(4)
    layout = tstep.StackLayout(B, N_SAMPLE)
    stack = layout.pack(in_c, out_c, valid, reset,
                        torch.zeros((T, N_SAMPLE), dtype=torch.int32), None, "cpu")
    counts = valid.sum(axis=1)
    for t in range(T):
        mf = layout.split(stack[t])[2].sum(dtype=torch.float32)
        assert mf.dtype == torch.float32 and float(mf) == counts[t]
    # the chunk's event count, and an empty step adds nothing
    cfg = small_cfg()
    state = tstep.init_train_state(cfg, N_ITEMS, "cpu")
    chunk_fn = tstep.make_chunk_fn(cfg, N_ITEMS)
    lp = torch.zeros(gru.pad_items(N_ITEMS, cfg.item_pad_multiple))
    _, ec = chunk_fn(state, in_c, out_c, valid, reset, torch.zeros(1), lp)
    assert ec == int(counts.sum())
    snap = {k: v.clone() for k, v in leaves(state).items()}
    ls, ec = chunk_fn(state, in_c[2:3], out_c[2:3], valid[2:3], reset[2:3],
                      torch.zeros(1), lp)
    assert ec == 0 and float(ls) == 0.0 and state.step == T + 1
    assert all(torch.equal(v, snap[k]) for k, v in leaves(state).items())


@pytest.mark.parametrize("adapt", ["adagrad", "adam"])
def test_tensor_seed_equals_int_seed(adapt):
    """The SR update keyed by a 0-d int32 seed tensor stores what the same
    seed as an int stores, bit for bit (the plain version here)."""
    opt = make_optimizer(GRU4RecConfig(adapt=adapt, momentum=0.3,
                                       opt_state_dtype="bfloat16_sr"))
    rng = np.random.RandomState(2)
    idx = torch.from_numpy(rng.randint(0, 50, 40).astype(np.int32))
    g = torch.from_numpy(rng.randn(40, 16).astype(np.float32))
    runs = []
    for seed in (-123456789, torch.tensor(-123456789, dtype=torch.int32)):
        table = torch.from_numpy(np.random.RandomState(3).randn(50, 16).astype(np.float32))
        st = opt.init_state(table, sparse=True)
        for _ in range(3):
            opt.apply_sparse(table, idx, g, st, sr_seed=(seed, 7))
        runs.append([table] + list(st.values()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------- card --- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GRAPH_CASES = [(None, 0.3, "float32", "constrained"),
               ("adagrad", 0.3, "float32", "constrained"),
               ("adagrad", 0.3, "bfloat16_sr", "constrained"),
               ("adam", 0.0, "bfloat16_sr", "embedding"),
               ("rmsprop", 0.3, "bfloat16", "onehot")]


@pytest.mark.cuda
@pytest.mark.parametrize("adapt,momentum,opt_state_dtype,mode", GRAPH_CASES)
def test_cuda_graph_matches_eager_loop(adapt, momentum, opt_state_dtype, mode):
    dev = _card()
    cfg = small_cfg(adapt, momentum, opt_state_dtype, mode)
    runs = []
    for eager in (True, False):
        state = tstep.init_train_state(cfg, N_ITEMS, dev)
        chunk_fn = tstep.make_chunk_fn(cfg, N_ITEMS, _eager=eager)
        losses = run_chunks(cfg, state, chunk_fn, n_chunks=3)
        torch.cuda.synchronize()
        assert (chunk_fn.runner is None) == eager
        runs.append((leaves(state), losses, state.gen.get_state()))
    (le, loss_e, gen_e), (lg, loss_g, gen_g) = runs
    for k in le:
        assert torch.equal(le[k], lg[k]), k
    assert all(torch.equal(a, b) for a, b in zip(loss_e, loss_g))
    assert torch.equal(gen_e, gen_g)


@pytest.mark.cuda
def test_cuda_dropout_masks_differ_between_replays(monkeypatch):
    """Each dropout output is copied into a probe: under capture the probe
    lives in the graph's pool and every replay refills it. The masks (zero
    patterns) differ from step to step and equal the eager loop's."""
    dev = _card()
    cfg = small_cfg()
    dropout = gru._dropout
    probes = []

    def probing(x, p, gen, lanes=None):
        y = dropout(x, p, gen, lanes)
        probes.append(y.clone())
        return y

    monkeypatch.setattr(gru, "_dropout", probing)
    steps = 4 + tstep.WARMUP_STEPS
    in_c, out_c, valid, reset = schedule(5, steps)
    valid[:] = True
    runs = []
    for eager in (True, False):
        probes.clear()
        state = tstep.init_train_state(cfg, N_ITEMS, dev)
        chunk_fn = tstep.make_chunk_fn(cfg, N_ITEMS, _eager=eager)
        lp = torch.zeros(gru.pad_items(N_ITEMS, cfg.item_pad_multiple), device=dev)
        masks = []
        for t in range(steps):
            chunk_fn(state, in_c[t:t + 1], out_c[t:t + 1], valid[t:t + 1],
                     reset[t:t + 1], torch.zeros(1, device=dev), lp)
            masks.append(torch.cat([(y == 0).flatten() for y in probes[-2:]]).cpu())
        runs.append(masks)
    eager_masks, graph_masks = runs
    assert all(torch.equal(a, b) for a, b in zip(eager_masks, graph_masks))
    replayed = graph_masks[tstep.WARMUP_STEPS:]
    assert all(not torch.equal(a, b) for a, b in zip(replayed, replayed[1:]))
    assert all(m.any() and not m.all() for m in replayed)


@pytest.mark.cuda
def test_cuda_counters_count_replays(monkeypatch):
    """``launches_by_mode`` counts each replayed step's updates: the one-hot
    ``Wx0`` (48 columns, K4) and ``Wy`` (128, K1) once per live step, the
    capture itself nothing. A caller's count of wrapper calls (as
    ``chip_smoke.py`` keeps one) comes to the same from its eager calls
    and its calls under capture times the runner's replays."""
    dev = _card()
    cfg = small_cfg(mode="onehot")
    eager, captured = {}, {}
    fused = sparse_update.fused_update

    def counted(opt, table, idx, g, st, sr_seed=None):
        mine = captured if torch.cuda.is_current_stream_capturing() else eager
        mine[table.shape[1]] = mine.get(table.shape[1], 0) + 1
        return fused(opt, table, idx, g, st, sr_seed=sr_seed)

    monkeypatch.setattr(sparse_update, "fused_update", counted)
    sparse_update.reset_launches()
    state = tstep.init_train_state(cfg, N_ITEMS, dev)
    chunk_fn = tstep.make_chunk_fn(cfg, N_ITEMS)
    run_chunks(cfg, state, chunk_fn, n_chunks=3)
    torch.cuda.synchronize()
    runner = chunk_fn.runner
    live = sum(int(schedule(c)[2].any(axis=1).sum()) for c in range(3))
    assert live > tstep.WARMUP_STEPS + 1 and runner.graph is not None
    assert runner.warm == tstep.WARMUP_STEPS and runner.warm + runner.replays == live
    assert runner.graph.tally == {"sparse_update": {"K1": 1, "K4": 1}}
    assert sparse_update.launches_by_mode == {"K1": live, "K2": 0, "K3": 0, "K4": live}
    assert captured == {48: 1, 128: 1}
    assert {k: eager[k] + captured[k] * runner.replays for k in eager} == {48: live,
                                                                           128: live}


@pytest.mark.cuda
def test_cuda_dedup_rows_is_deterministic():
    """The plain version's duplicate sums on the card are the same bits
    call after call (plain SGD's row update runs them inside the captured
    step, where a sum in no fixed order would part graph from eager loop),
    the same distinct rows as the CPU's, and each sum within float32
    summation's error bound of the exact one: (terms - 1) * 2**-24 * the
    sum of the terms' magnitudes."""
    dev = _card()
    rng = np.random.RandomState(6)
    for K, d, n in ((2208, 256, 500), (4000, 1, 30), (33, 300, 37504)):
        idx = rng.randint(0, n, K).astype(np.int32)
        idx[rng.rand(K) < 0.1] = tstep.SENTINEL
        g = (rng.randn(K, d) * np.exp(3 * rng.randn(K, 1))).astype(np.float32)
        g = g[:, 0].copy() if d == 1 else g
        idx_t, g_t = torch.from_numpy(idx), torch.from_numpy(g)
        want_idx, _ = optimizers.dedup_rows(idx_t, g_t)
        exact = optimizers.dedup_rows(idx_t, g_t.double())[1]
        magnitude = optimizers.dedup_rows(idx_t, g_t.double().abs())[1]
        terms = optimizers.dedup_rows(idx_t, torch.ones(K, dtype=torch.float64))[1]
        if d > 1:
            terms = terms[:, None]
        runs = [optimizers.dedup_rows(idx_t.to(dev), g_t.to(dev)) for _ in range(3)]
        for uidx, g_sum in runs:
            assert torch.equal(uidx.cpu(), want_idx)
            assert torch.equal(g_sum, runs[0][1])
        err = (runs[0][1].cpu().double() - exact).abs()
        assert bool((err <= (terms - 1).clamp(min=0) * 2.0**-24 * magnitude).all())


@pytest.mark.cuda
def test_cuda_rebound_state_raises():
    """A chunk whose state tensors are not the captured ones raises instead
    of replaying a graph that would update the old buffers."""
    dev = _card()
    cfg = small_cfg()
    state = tstep.init_train_state(cfg, N_ITEMS, dev)
    chunk_fn = tstep.make_chunk_fn(cfg, N_ITEMS)
    samp1 = torch.zeros(1, device=dev)
    logp0 = torch.zeros(gru.pad_items(N_ITEMS, cfg.item_pad_multiple), device=dev)
    for c in range(2):
        chunk_fn(state, *schedule(c), samp1, logp0)
    assert chunk_fn.runner.graph is not None and chunk_fn.runner.pool_bytes > 0
    state.H = gru.init_hidden(cfg, B, dev)
    with pytest.raises(RuntimeError, match="captured"):
        chunk_fn(state, *schedule(2), samp1, logp0)


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", ["adagrad", "adam"])
def test_cuda_device_seed_equals_by_value_seed(adapt):
    dev = _card()
    opt = make_optimizer(GRU4RecConfig(adapt=adapt, momentum=0.3,
                                       opt_state_dtype="bfloat16_sr"))
    rng = np.random.RandomState(4)
    idx = torch.from_numpy(rng.randint(0, 5000, 2000).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.randn(2000, 256).astype(np.float32)).to(dev)
    runs = []
    for seed in (-987654321, torch.tensor(-987654321, dtype=torch.int32, device=dev)):
        table = torch.from_numpy(np.random.RandomState(5).randn(5000, 256)
                                 .astype(np.float32)).to(dev)
        st = opt.init_state(table, sparse=True)
        sparse_update.reset_launches()
        for _ in range(3):
            sparse_update.fused_update(opt, table, idx, g, st, sr_seed=(seed, 11))
        torch.cuda.synchronize()
        assert sparse_update.launches_by_mode["K3" if adapt == "adam" else "K2"] == 3
        runs.append([table] + list(st.values()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_cuda_chunk_functions_leave_no_memory_behind():
    """Every chunk function warms up and captures on one stream per device:
    cuBLAS keeps a workspace per stream for the life of the process, so a
    stream per chunk function would leave one more behind each time. A
    second chunk function, run and freed, leaves as much allocated as the
    first did."""
    import gc

    dev = _card()
    cfg = small_cfg()
    allocated = []
    for _ in range(3):
        state = tstep.init_train_state(cfg, N_ITEMS, dev)
        chunk_fn = tstep.make_chunk_fn(cfg, N_ITEMS)
        run_chunks(cfg, state, chunk_fn)
        assert chunk_fn.runner.stream is cuda_graph.capture_stream(dev)
        del state, chunk_fn
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(dev))
    assert allocated[1] == allocated[2] == allocated[0], allocated
