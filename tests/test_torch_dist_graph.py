"""The mesh programs of ``gru4rec_tpu_torch/parallel/`` as captured CUDA
graphs: the distributed training chunk's packed step stack, its collectives
and its device seeds, and the captured mesh step, evaluation step and top-k
call.

Every case needs a card: a gloo mesh is never captured, so the CPU has no
graph to check. The packed-stack chunk's eager loop, the device seeds on
row-shards, ``Mesh.all_gather``'s single-buffer form and the gloo mesh's
eager design are held to JAX and to their list and int forms on the CPU by
``test_torch_parallel.py``, through the gloo ranks of
``tests/torch_dist_worker.py``.

On the card (``cuda``-marked, skipped here; run there with ``python -m
pytest --noconftest -m cuda tests/test_torch_dist_graph.py``), on a one-rank
NCCL mesh (NCCL takes one rank per card): the captured mesh chunk bit-equal
to its ``_eager=True`` loop and to the single-device captured chunk, for
adagrad and adam, float32 and ``bfloat16_sr`` state, constrained and one-hot
input, with one replay per live step after the warm-up; ``evaluate(mesh=)``
through its graph bit-equal to its eager loop and to the single-device call
in the four tie modes, full catalog and subset, kept and standalone;
``predict_topk(mesh=)`` through its graph bit-equal to eager mesh serving
and to the single-device call over session, k and batch changes, its graphs
dropped when another mesh is used and not taken by a model whose lanes lie
on the CPU; a rebound state raises; a gloo mesh on the card stays eager; a
capture that fails raises instead of going on eagerly.
"""

import contextlib

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.config import GRU4RecConfig  # noqa: E402
from gru4rec_tpu_torch.models import gru  # noqa: E402
from gru4rec_tpu_torch.parallel.dist_step import (make_dist_chunk_fn,  # noqa: E402
                                                  shard_params, shard_train_state)
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402

N_ITEMS, B, N_SAMPLE, T = 30, 4, 6, 7
MODES = {"constrained": dict(constrained_embedding=True, embedding=0),
         "onehot": dict(constrained_embedding=False, embedding=0)}
CARD_CASES = [(a, d, m) for a in ("adagrad", "adam") for d in ("float32", "bfloat16_sr")
              for m in MODES]
TIE_MODES = ("standard", "conservative", "median", "tiebreaking")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _one_rank_mesh(backend):
    """A 1x1 mesh on ``cuda:0`` over ``backend``, its process group torn
    down afterwards."""
    import torch.distributed as dist

    from gru4rec_tpu_torch.parallel import make_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_mesh(1, 1, device="cuda:0", backend=backend)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def small_cfg(adapt="adagrad", opt_state_dtype="float32", mode="constrained"):
    return GRU4RecConfig(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=B,
                         n_sample=N_SAMPLE, sample_alpha=0.0, adapt=adapt, momentum=0.3,
                         learning_rate=0.05, lmbd=1e-4, compute_dtype="float32",
                         opt_state_dtype=opt_state_dtype, dropout_p_hidden=0.2,
                         dropout_p_embed=0.1, seed=5, **MODES[mode])


def schedule(seed):
    """(in, out, valid, reset) of ``T`` steps: masked lanes, resets and one
    fully padded step."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(T, B) < 0.8
    valid[2] = False
    return (rng.randint(0, N_ITEMS, (T, B)).astype(np.int32),
            rng.randint(0, N_ITEMS, (T, B)).astype(np.int32), valid, rng.rand(T, B) < 0.3)


def run_chunks(state, chunk_fn, dev, n_chunks=3):
    samp1 = torch.zeros(1, device=dev)
    logp0 = torch.zeros(gru.pad_items(N_ITEMS, 128), device=dev)
    return [chunk_fn(state, *schedule(c), samp1, logp0)[0] for c in range(n_chunks)]


def state_leaves(state):
    from gru4rec_tpu_torch.utils.cuda_graph import leaves

    return leaves(state.H, state.params, state.opt_state)


def markov(n_sessions, n_items=40, seed=0):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def fitted(dev):
    cfg = GRU4RecConfig(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=8,
                        n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                        chunk_size=16, n_epochs=1, item_pad_multiple=8, seed=3,
                        constrained_embedding=True)
    return gru4rec_tpu_torch.GRU4Rec(cfg, device=dev).fit(markov(150))


def twin(model, dev):
    """Another model holding ``model``'s parameters and catalog, with lanes
    of its own."""
    m = gru4rec_tpu_torch.GRU4Rec(model.config, device=dev)
    m.params, m.itemidmap, m.n_items = model.params, model.itemidmap, model.n_items
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("adapt,opt_state_dtype,mode", CARD_CASES)
def test_cuda_mesh_chunk_graph_matches_eager_and_one_device(adapt, opt_state_dtype, mode):
    dev = _card()
    cfg = small_cfg(adapt, opt_state_dtype, mode)
    runs = {}
    with _one_rank_mesh("nccl") as mesh:
        assert mesh.capturable
        for name in ("single", "mesh_eager", "mesh_graph"):
            state = tstep.init_train_state(cfg, N_ITEMS, dev)
            if name == "single":
                fn = tstep.make_chunk_fn(cfg, N_ITEMS)
            else:
                state = shard_train_state(state, cfg, mesh)
                fn = make_dist_chunk_fn(cfg, N_ITEMS, mesh, _eager=name == "mesh_eager")
            losses = run_chunks(state, fn, dev)
            torch.cuda.synchronize()
            runs[name] = (state_leaves(state), losses, state.gen.get_state(), fn.runner)
    runner = runs["mesh_graph"][3]
    live = sum(int(schedule(c)[2].any(axis=1).sum()) for c in range(3))
    assert runs["mesh_eager"][3] is None and runner.graph is not None
    assert runner.warm == tstep.WARMUP_STEPS and runner.warm + runner.replays == live
    graph_leaves, graph_losses, graph_gen, _ = runs["mesh_graph"]
    for other in ("mesh_eager", "single"):
        want_leaves, want_losses, want_gen, _ = runs[other]
        assert len(graph_leaves) == len(want_leaves)
        assert all(torch.equal(a, b) for a, b in zip(graph_leaves, want_leaves)), other
        assert all(torch.equal(a, b) for a, b in zip(graph_losses, want_losses)), other
        assert torch.equal(graph_gen, want_gen), other


@pytest.mark.cuda
@pytest.mark.parametrize("items", ["full", "subset"])
def test_cuda_mesh_evaluate_graph_matches_eager(items):
    from gru4rec_tpu_torch import evaluate

    dev = _card()
    model = fitted(dev)
    test = markov(40, seed=5)
    subset = [f"item_{i}" for i in range(0, 40, 3)] if items == "subset" else None
    with _one_rank_mesh("nccl") as mesh:
        # the kept graph reads live shards, as fit's validation does
        shards = shard_params(model.params, model.config, mesh)
        for mode in TIE_MODES:
            kw = dict(cut_off=[1, 5, 20], batch_size=8, mode=mode, items=subset)
            graphs = {}
            kept = [evaluate(model, test, mesh=mesh, _shards=shards, _graphs=graphs, **kw)
                    for _ in range(2)]
            standalone = evaluate(model, test, mesh=mesh, **kw)
            eager = evaluate(model, test, mesh=mesh, _eager=True, **kw)
            single = evaluate(model, test, **kw)
            assert kept[0] == kept[1] == standalone == eager == single, mode
            (graph,) = graphs.values()  # one capture, replayed by both calls
            assert graph.graph is not None and graph.warm == tstep.WARMUP_STEPS
            assert len(graph.H[0]) == 8


@pytest.mark.cuda
def test_cuda_mesh_topk_graph_matches_eager():
    dev = _card()
    model = fitted(dev)
    eager, single = twin(model, dev), twin(model, dev)
    eager._serve_graphs = None  # eager serving on the card
    catalog = model.itemidmap.index.values
    rng = np.random.RandomState(1)
    calls = [(8, 5, np.array([1, 1, 2, 2, 3, 3, 4, 4])), (8, 5, np.array([1, 1, 9, 2, 3, 3, 4, 8])),
             (8, 5, np.array([1, 1, 9, 2, 3, 3, 4, 8])), (8, 3, np.array([5, 1, 9, 2, 3, 6, 4, 8])),
             (4, 5, np.array([1, 2, 3, 4])), (8, 5, np.arange(8)), (8, 5, np.arange(8))]
    with _one_rank_mesh("nccl") as mesh:
        for batch, k, sess in calls:
            inp = catalog[rng.randint(0, model.n_items, batch)]
            got = model.predict_topk(sess, inp, k=k, batch=batch, mesh=mesh)
            for other in (eager.predict_topk(sess, inp, k=k, batch=batch, mesh=mesh),
                          single.predict_topk(sess, inp, k=k, batch=batch)):
                assert (got[0] == other[0]).all() and np.array_equal(got[1], other[1])
        graphs = {key: g for key, g in model._serve_graphs.items() if len(key) == 4}
        assert set(graphs) == {("topk", 8, 5, mesh), ("topk", 8, 3, mesh), ("topk", 4, 5, mesh)}
        # the batch change gave new lanes: (8, 5) was captured again on them
        assert graphs[("topk", 8, 5, mesh)].replays == 1
    for a, b in zip(model.H, eager.H):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_mesh_topk_graphs_follow_the_mesh_and_the_lanes():
    """A new mesh drops the graphs captured on the one before (their pools
    and its communicators); a model whose lanes lie on the CPU serves an
    NCCL mesh eagerly, equal to the captured call."""
    dev = _card()
    model = fitted(dev)
    host = twin(model, "cpu")
    sess, inp = np.arange(8), model.itemidmap.index.values[:8]
    with _one_rank_mesh("nccl") as first:
        want = model.predict_topk(sess, inp, k=5, batch=8, mesh=first)
        got = host.predict_topk(sess, inp, k=5, batch=8, mesh=first)
        assert (got[0] == want[0]).all() and np.array_equal(got[1], want[1])
        assert host._serve_graphs == {}
        assert ("topk", 8, 5, first) in model._serve_graphs
    with _one_rank_mesh("nccl") as second:
        model.predict_topk(sess, inp, k=5, batch=8, mesh=second)
        assert [key for key in model._serve_graphs if len(key) == 4] == [("topk", 8, 5, second)]


@pytest.mark.cuda
def test_cuda_mesh_rebound_state_raises():
    dev = _card()
    cfg = small_cfg()
    with _one_rank_mesh("nccl") as mesh:
        state = shard_train_state(tstep.init_train_state(cfg, N_ITEMS, dev), cfg, mesh)
        fn = make_dist_chunk_fn(cfg, N_ITEMS, mesh)
        run_chunks(state, fn, dev, n_chunks=2)
        assert fn.runner.graph is not None and fn.runner.pool_bytes > 0
        state.H = gru.init_hidden(cfg, B, dev)
        with pytest.raises(RuntimeError, match="captured"):
            run_chunks(state, fn, dev, n_chunks=1)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_gloo_mesh_on_the_card_stays_eager():
    from gru4rec_tpu_torch import evaluate

    dev = _card()
    cfg = small_cfg()
    model = fitted(dev)
    with _one_rank_mesh("gloo") as mesh:
        assert not mesh.capturable
        state = shard_train_state(tstep.init_train_state(cfg, N_ITEMS, dev), cfg, mesh)
        fn = make_dist_chunk_fn(cfg, N_ITEMS, mesh)
        assert fn.runner is None
        losses = run_chunks(state, fn, dev)
        assert all(bool(torch.isfinite(x)) for x in losses)
        graphs = {}
        got = evaluate(model, markov(40, seed=5), cut_off=[5], batch_size=8, mesh=mesh,
                       _graphs=graphs)
        assert graphs == {}
        assert got == evaluate(model, markov(40, seed=5), cut_off=[5], batch_size=8)
        model.predict_topk(np.arange(8), model.itemidmap.index.values[:8], k=5, batch=8,
                           mesh=mesh)
        assert not any(len(key) == 4 for key in model._serve_graphs)


@pytest.mark.cuda
def test_cuda_failed_mesh_capture_raises(monkeypatch):
    """A host wait under capture (here a ``.item()`` before the step's first
    collective) fails the capture: the chunk raises, nothing replays and
    nothing goes on eagerly."""
    dev = _card()
    cfg = small_cfg()
    with _one_rank_mesh("nccl") as mesh:
        gather = mesh.all_gather

        def waiting(t, axis):
            float(t.float().sum())  # a host wait
            return gather(t, axis)

        monkeypatch.setattr(mesh, "all_gather", waiting)
        state = shard_train_state(tstep.init_train_state(cfg, N_ITEMS, dev), cfg, mesh)
        fn = make_dist_chunk_fn(cfg, N_ITEMS, mesh)
        with pytest.raises(RuntimeError):
            run_chunks(state, fn, dev, n_chunks=2)
        assert fn.runner.graph is None and fn.runner.replays == 0
        assert fn.runner.warm == tstep.WARMUP_STEPS
        torch.cuda.synchronize()
