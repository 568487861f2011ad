"""Worker process of the port's mesh tests (tests/test_torch_parallel.py).

Each worker is one rank of a ``gloo`` mesh on the CPU. It drives the
port's mesh entry points (``make_mesh``, the distributed training chunk,
``fit(mesh=)``, ``evaluate(mesh=)``, ``predict_topk(mesh=)``, checkpoints,
the collectives and stochastic-rounding seeds of the packed step stack) on
the inputs the test module wrote, and writes what it read to
``<out_dir>/rank<r>.npz``; ``test_torch_parallel.py`` holds those
against the JAX package and the port's single-device path. Imports torch
and the port only.

Not a pytest module: run as ``python torch_dist_worker.py <rank> <n_data>
<n_model> <port> <init> <inputs.npz> <out_dir>``, where ``init`` is ``env``
(the launcher's variables, as ``torchrun`` sets them), ``tcp``
(``init_distributed(coordinator_address=...)``) or ``none`` (a one-rank mesh
in a process started without a launcher).
"""

import contextlib
import json
import os
import sys

import numpy as np


def flat(prefix, tree, out):
    """Tensors of a dict/list tree into ``out`` under ``prefix/key/i``, as
    float32 or int numpy arrays."""
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{prefix}/{k}", v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(f"{prefix}/{i}", v, out)
    else:
        t = tree.detach().cpu()
        out[prefix] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def main():
    rank, nd, nm, port = (int(a) for a in sys.argv[1:5])
    init, inputs_path, out_dir = sys.argv[5:8]
    world = nd * nm

    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from gru4rec_tpu_torch.parallel import init_distributed, make_mesh

    if init == "env":
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    elif init == "tcp":
        init_distributed(coordinator_address=f"localhost:{port}", num_processes=world,
                         process_id=rank)
        # a repeat call is a no-op
        init_distributed(coordinator_address=f"localhost:{port}", num_processes=world,
                         process_id=rank)
    mesh = make_mesh(nd, nm, device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world

    inputs = dict(np.load(inputs_path, allow_pickle=False))
    out = {"rank": np.array(rank), "di": np.array(mesh.di), "mi": np.array(mesh.mi),
           "model_ranks": np.array(mesh.ranks("model")),
           "data_ranks": np.array(mesh.ranks("data"))}
    tasks = json.loads(str(inputs["tasks"]))
    for task in tasks[f"{nd}x{nm}"]:
        globals()[f"task_{task}"](mesh, inputs, out, out_dir)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _cfg(kw):
    from gru4rec_tpu_torch import GRU4RecConfig

    return GRU4RecConfig(**kw)


def _frame(inputs, name):
    import pandas as pd

    return pd.DataFrame({"SessionId": inputs[f"{name}/SessionId"],
                         "ItemId": inputs[f"{name}/ItemId"],
                         "Time": inputs[f"{name}/Time"]})


def _chunk(mesh, inputs, case, cfg_kw):
    """One distributed chunk from a fresh state; the canonical state after."""
    import torch

    from gru4rec_tpu_torch.models.gru import input_mode
    from gru4rec_tpu_torch.parallel.dist_step import (make_dist_chunk_fn, shard_train_state,
                                                      unshard_train_state)
    from gru4rec_tpu_torch.train.step import init_train_state, sparse_table_names

    cfg = _cfg(cfg_kw)
    n_items = int(inputs[f"chunk/{case}/n_items"])
    sched = [inputs[f"chunk/{case}/{k}"] for k in ("in", "out", "valid", "reset")]
    state = shard_train_state(init_train_state(cfg, n_items, "cpu"), cfg, mesh)
    fn = make_dist_chunk_fn(cfg, n_items, mesh)
    seeds = None
    if cfg.opt_state_dtype == "bfloat16_sr":
        seeds = {t: inputs[f"chunk/{case}/seed/{t}"]
                 for t in sparse_table_names(input_mode(cfg))}
    loss, ev = fn(state, *sched, torch.from_numpy(inputs[f"chunk/{case}/samp1"]),
                  torch.from_numpy(inputs[f"chunk/{case}/logp0"]),
                  neg=torch.from_numpy(inputs[f"chunk/{case}/neg"]), sr_seeds=seeds)
    return float(loss), ev, unshard_train_state(state, cfg, mesh)


def task_chunk(mesh, inputs, out, out_dir):
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    for case in json.loads(str(inputs[f"chunk_cases/{nd}x{nm}"])):
        cfg_kw = json.loads(str(inputs[f"chunk/{case}/cfg"]))
        loss, ev, state = _chunk(mesh, inputs, case, cfg_kw)
        out[f"chunk/{case}/loss"] = np.array(loss)
        out[f"chunk/{case}/events"] = np.array(ev)
        flat(f"chunk/{case}/params", state.params, out)
        flat(f"chunk/{case}/sparse", state.opt_state["sparse"], out)
        flat(f"chunk/{case}/H", state.H, out)


def task_padding(mesh, inputs, out, out_dir):
    """A chunk in which the lanes of data rank 1 are all padding for two
    steps and one step is padding everywhere, against the single-device
    chunk on the same inputs."""
    import torch

    from gru4rec_tpu_torch.train.step import init_train_state, make_chunk_fn

    case = "padding"
    cfg_kw = json.loads(str(inputs[f"chunk/{case}/cfg"]))
    loss, ev, state = _chunk(mesh, inputs, case, cfg_kw)
    cfg = _cfg(cfg_kw)
    n_items = int(inputs[f"chunk/{case}/n_items"])
    single = init_train_state(cfg, n_items, "cpu")
    sched = [inputs[f"chunk/{case}/{k}"] for k in ("in", "out", "valid", "reset")]
    loss1, ev1 = make_chunk_fn(cfg, n_items)(
        single, *sched, torch.from_numpy(inputs[f"chunk/{case}/samp1"]),
        torch.from_numpy(inputs[f"chunk/{case}/logp0"]),
        neg=torch.from_numpy(inputs[f"chunk/{case}/neg"]))
    out["padding/loss"] = np.array([loss, float(loss1)])
    out["padding/events"] = np.array([ev, ev1])
    out["padding/step"] = np.array([state.step, single.step])
    flat("padding/mesh", state.params, out)
    flat("padding/single", single.params, out)


def task_clip(mesh, inputs, out, out_dir):
    """The grad_cap cases: one chunk on the mesh, the same chunk on one
    device, and on one device without the cap (its ``Wy``)."""
    import torch

    from gru4rec_tpu_torch.models.gru import input_mode
    from gru4rec_tpu_torch.train.step import (init_train_state, make_chunk_fn,
                                              sparse_table_names)

    for case in json.loads(str(inputs["clip_cases"])):
        cfg_kw = json.loads(str(inputs[f"chunk/{case}/cfg"]))
        loss, _, state = _chunk(mesh, inputs, case, cfg_kw)
        flat(f"{case}/mesh/params", state.params, out)
        flat(f"{case}/mesh/sparse", state.opt_state["sparse"], out)
        for table, st in state.opt_state["sparse"].items():
            for slot, v in st.items():
                out[f"{case}/dtype/sparse/{table}/{slot}"] = np.array(
                    str(v.dtype).replace("torch.", ""))
        n_items = int(inputs[f"chunk/{case}/n_items"])
        sched = [inputs[f"chunk/{case}/{k}"] for k in ("in", "out", "valid", "reset")]
        for cap in (cfg_kw["grad_cap"], 0.0):
            cfg = _cfg(dict(cfg_kw, grad_cap=cap))
            single = init_train_state(cfg, n_items, "cpu")
            seeds = None
            if cfg.opt_state_dtype == "bfloat16_sr":
                seeds = {t: inputs[f"chunk/{case}/seed/{t}"]
                         for t in sparse_table_names(input_mode(cfg))}
            loss1, _ = make_chunk_fn(cfg, n_items)(
                single, *sched, torch.from_numpy(inputs[f"chunk/{case}/samp1"]),
                torch.from_numpy(inputs[f"chunk/{case}/logp0"]),
                neg=torch.from_numpy(inputs[f"chunk/{case}/neg"]), sr_seeds=seeds)
            if cap:
                out[f"{case}/loss"] = np.array([loss, float(loss1)])
                flat(f"{case}/single/params", single.params, out)
                flat(f"{case}/single/sparse", single.opt_state["sparse"], out)
            else:
                out[f"{case}/uncapped_Wy"] = single.params["Wy"].numpy()


@contextlib.contextmanager
def _injected(draws):
    """The negative draw both chunk functions share patched with the rows of
    ``draws``, one per call (chunk_size 1: one call per step); yields the
    list of calls."""
    import torch

    from gru4rec_tpu_torch.train import step as tstep

    calls = []

    def injected(gen, samp1, n_steps, n_sample, n_items, alpha, sampler):
        assert n_steps == 1
        calls.append(None)
        return torch.from_numpy(draws[len(calls) - 1:len(calls)])

    saved = tstep.draw_negatives
    tstep.draw_negatives = injected
    try:
        yield calls
    finally:
        tstep.draw_negatives = saved


def task_fit(mesh, inputs, out, out_dir):
    """fit(mesh=) with in-fit validation and keep_best, JAX's negatives
    injected; then the same fit on one device."""
    from gru4rec_tpu_torch import GRU4Rec

    cfg_kw = json.loads(str(inputs["fit/cfg"]))
    train, valid = _frame(inputs, "fit/train"), _frame(inputs, "fit/valid")
    kw = dict(eval_data=valid, eval_cutoff=5, eval_batch_size=8, keep_best=True)
    for name, m in (("mesh", mesh), ("single", None)):
        with _injected(inputs["fit/neg"]) as calls:
            model = GRU4Rec(_cfg(cfg_kw), device="cpu").fit(train, mesh=m, **kw)
        assert len(calls) == sum(e["steps"] for e in model.epoch_stats)
        out[f"fit/{name}/loss"] = np.array([e["loss"] for e in model.epoch_stats])
        out[f"fit/{name}/recall"] = np.array([v["recall"] for v in model.valid_stats])
        out[f"fit/{name}/mrr"] = np.array([v["mrr"] for v in model.valid_stats])
        assert all(t.device.type == "cpu" for t in model.params["Wh"])
        flat(f"fit/{name}/params", model.params, out)


def _markov(n_sessions, n_items, seed):
    import pandas as pd

    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 7)):
            rows.append((s, f"it{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def task_checkpoint(mesh, inputs, out, out_dir):
    """Rank 0 alone writes; a mesh resume equals an uninterrupted mesh run."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec

    cfg_kw = json.loads(str(inputs["ckpt/cfg"]))
    data = _markov(120, 24, seed=1)
    full = GRU4Rec(_cfg(cfg_kw), device="cpu").fit(data, mesh=mesh)
    ckpt = os.path.join(out_dir, "mesh_ck.npz")
    part = GRU4Rec(_cfg(cfg_kw), device="cpu").fit(data, mesh=mesh, n_epochs=2,
                                                    checkpoint_every=2, checkpoint_path=ckpt)
    # every rank asks to save to a path of its own: only rank 0's is written
    own = os.path.join(out_dir, f"own_rank{mesh.rank}.npz")
    part.savemodel(own)
    part.save_checkpoint(os.path.join(out_dir, f"own_ckpt_rank{mesh.rank}.npz"))
    out["ckpt/wrote"] = np.array([os.path.exists(own),
                                  os.path.exists(os.path.join(
                                      out_dir, f"own_ckpt_rank{mesh.rank}.npz"))])
    resumed = GRU4Rec(_cfg(cfg_kw), device="cpu").fit(data, resume=ckpt, mesh=mesh)
    out["ckpt/epochs"] = np.array([len(full.epoch_stats), len(resumed.epoch_stats)])
    out["ckpt/loss"] = np.array([full.epoch_stats[-1]["loss"], resumed.epoch_stats[-1]["loss"]])
    out["ckpt/equal"] = np.array([
        torch.equal(full.params["Wy"], resumed.params["Wy"]),
        torch.equal(full._train_state.opt_state["sparse"]["Wy"]["acc"],
                    resumed._train_state.opt_state["sparse"]["Wy"]["acc"]),
        all(torch.equal(a, b) for a, b in zip(full.params["Wh"], resumed.params["Wh"]))])


def task_retrain(mesh, inputs, out, out_dir):
    """fit then fit(retrain=True) over a grown catalog, on the mesh and on
    one device; evaluate(mesh=) on the grown model."""
    from gru4rec_tpu_torch import GRU4Rec, evaluate

    cfg_kw = json.loads(str(inputs["retrain/cfg"]))
    for name, m in (("mesh", mesh), ("single", None)):
        model = GRU4Rec(_cfg(cfg_kw), device="cpu").fit(_markov(100, 20, seed=0), mesh=m)
        n0 = model.n_items
        model.fit(_markov(100, 30, seed=2), retrain=True, n_epochs=1, mesh=m)
        rec, _ = evaluate(model, _markov(20, 30, seed=5), cut_off=[5], batch_size=8, mesh=m)
        out[f"retrain/{name}/n_items"] = np.array([n0, model.n_items])
        out[f"retrain/{name}/recall"] = np.array(rec)
        flat(f"retrain/{name}/params", model.params, out)


def _eval_models(inputs):
    from gru4rec_tpu_torch import GRU4Rec

    return {name: GRU4Rec.loadmodel(str(inputs[f"eval/{name}/path"]), device="cpu")
            for name in json.loads(str(inputs["eval/models"]))}


def task_evaluate(mesh, inputs, out, out_dir):
    from gru4rec_tpu_torch import evaluate

    test = _frame(inputs, "eval/test")
    subset = list(inputs["eval/subset"])
    for name, model in _eval_models(inputs).items():
        for mode in ("standard", "conservative", "median", "tiebreaking"):
            for items in ("full", "subset"):
                rec, mrr = evaluate(model, test, cut_off=[1, 5, 20], batch_size=16, mode=mode,
                                    items=subset if items == "subset" else None, mesh=mesh)
                out[f"eval/{name}/{mode}/{items}"] = np.array([rec, mrr])
        # rounded down to a multiple of the data axis
        rec, mrr = evaluate(model, test, cut_off=[1, 5, 20], batch_size=15, mesh=mesh)
        out[f"eval/{name}/batch15"] = np.array([rec, mrr])


def task_topk(mesh, inputs, out, out_dir):
    """Two predict_topk(mesh=) calls in a row (the lanes carry over, two
    sessions change), then one single-device call continuing the lanes."""
    for name, model in _eval_models(inputs).items():
        for i, (sess, inp) in enumerate(zip(inputs["topk/sessions"], inputs["topk/inputs"])):
            ids, scores = model.predict_topk(sess, list(inp), k=7, batch=8, mesh=mesh)
            out[f"topk/{name}/{i}/ids"] = ids.astype(str)
            out[f"topk/{name}/{i}/scores"] = scores
        ids, scores = model.predict_topk(inputs["topk/sessions"][-1], list(inputs["topk/inputs"][0]),
                                         k=7, batch=8)
        out[f"topk/{name}/after/ids"] = ids.astype(str)
        out[f"topk/{name}/after/scores"] = scores


def task_bit_equal(mesh, inputs, out, out_dir):
    """A 1 x 1 mesh repeats the single-device fit, evaluate and
    predict_topk bit for bit (dropout on)."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec, evaluate

    cfg_kw = json.loads(str(inputs["bit/cfg"]))
    train, test = _markov(150, 40, seed=3), _markov(40, 40, seed=4)
    a = GRU4Rec(_cfg(cfg_kw), device="cpu").fit(train)
    b = GRU4Rec(_cfg(cfg_kw), device="cpu").fit(train, mesh=mesh)
    sa, sb = a._train_state, b._train_state
    leaves = {}
    flat("p", sa.params, leaves)
    flat("s", sa.opt_state, leaves)
    other = {}
    flat("p", sb.params, other)
    flat("s", sb.opt_state, other)
    out["bit/leaves"] = np.array(sorted(leaves))
    out["bit/fit"] = np.array([
        [e["loss"] for e in a.epoch_stats] == [e["loss"] for e in b.epoch_stats],
        sorted(leaves) == sorted(other),
        all(np.array_equal(leaves[k], other[k]) for k in leaves),
        sa.step == sb.step,
        torch.equal(sa.gen.get_state(), sb.gen.get_state())])
    same = []
    for mode in ("standard", "conservative", "median", "tiebreaking"):
        for items in (None, [f"it{i}" for i in range(0, 40, 3)]):
            same.append(evaluate(a, test, cut_off=[1, 5, 20], batch_size=16, mode=mode,
                                 items=items)
                        == evaluate(b, test, cut_off=[1, 5, 20], batch_size=16, mode=mode,
                                    items=items, mesh=mesh))
    out["bit/evaluate"] = np.array(same)
    sess = np.arange(8)
    inp = [f"it{i}" for i in range(8)]
    ia, sa_ = a.predict_topk(sess, inp, k=5, batch=8)
    ib, sb_ = b.predict_topk(sess, inp, k=5, batch=8, mesh=mesh)
    out["bit/topk"] = np.array([(ia == ib).all(), np.array_equal(sa_, sb_)])


def task_seed_forms(mesh, inputs, out, out_dir):
    """Stochastically rounded updates of this rank's row-shard keyed by 0-d
    int32 seed tensors (the views of the packed stack that a step hands the
    update) against the same seeds as ints, and against the whole table's
    update (seed row offset 0) on the shard's rows; adagrad and adam."""
    import torch

    from gru4rec_tpu_torch.parallel.mesh import local_block
    from gru4rec_tpu_torch.train.optimizers import SENTINEL, make_optimizer

    nm, mi = mesh.shape["model"], mesh.mi
    rng = np.random.RandomState(2)
    n, d, K = 64, 16, 40
    idx = torch.from_numpy(rng.randint(0, n, K).astype(np.int32))
    g = torch.from_numpy(rng.randn(K, d).astype(np.float32))
    base = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    rows = n // nm
    r0 = mi * rows
    idx_l = torch.where((idx >= r0) & (idx < r0 + rows), idx - r0, SENTINEL)
    for adapt in ("adagrad", "adam"):
        opt = make_optimizer(_cfg(dict(adapt=adapt, momentum=0.3,
                                       opt_state_dtype="bfloat16_sr")))
        runs = {}
        for form in ("tensor", "int", "whole"):
            table = base.clone() if form == "whole" else local_block(base, nm, mi, "cpu")
            st = opt.init_state(table, sparse=True)
            for seed in (-123456789, 0x7FFFFFF0, 5):
                if form == "tensor":
                    seed = torch.tensor(seed, dtype=torch.int32)
                opt.apply_sparse(table, idx if form == "whole" else idx_l, g, st,
                                 sr_seed=(seed, 0 if form == "whole" else r0))
            got = [table] + list(st.values())
            runs[form] = [t[r0:r0 + rows] for t in got] if form == "whole" else got
        out[f"seed_forms/{adapt}"] = np.array([
            all(torch.equal(a, b) for a, b in zip(runs["tensor"], runs[other]))
            for other in ("int", "whole")])


def task_gather_forms(mesh, inputs, out, out_dir):
    """``Mesh.all_gather`` (one collective into one buffer) against the
    list form of ``dist.all_gather`` and a concatenation, over both axes,
    for int32, float32 and bfloat16 blocks and a transposed input."""
    import torch
    import torch.distributed as dist

    same = []
    for axis in ("data", "model"):
        for dtype, shape, transpose in ((torch.int32, (3, 4), False),
                                        (torch.int32, (4, 3), True),
                                        (torch.float32, (5,), False),
                                        (torch.bfloat16, (2, 3, 2), False)):
            t = (torch.arange(int(np.prod(shape))) + 100 * mesh.rank).reshape(shape).to(dtype)
            if transpose:
                t = t.t()
            parts = [torch.empty_like(t.contiguous()) for _ in mesh.ranks(axis)]
            dist.all_gather(parts, t.contiguous(), group=mesh._groups[axis])
            got = mesh.all_gather(t, axis)
            same.append(got.dtype == dtype and torch.equal(got, torch.cat(parts)))
    out["gather_forms"] = np.array(same)


def task_eager_by_design(mesh, inputs, out, out_dir):
    """A gloo mesh is not capturable: its chunk function has no runner."""
    from gru4rec_tpu_torch.parallel.dist_step import make_dist_chunk_fn

    case = json.loads(str(inputs[f"chunk_cases/{mesh.shape['data']}x{mesh.shape['model']}"]))[0]
    cfg = _cfg(json.loads(str(inputs[f"chunk/{case}/cfg"])))
    n_items = int(inputs[f"chunk/{case}/n_items"])
    out["eager_by_design"] = np.array([
        mesh.capturable, make_dist_chunk_fn(cfg, n_items, mesh).runner is None,
        make_dist_chunk_fn(cfg, n_items, mesh, _eager=True).runner is None])


if __name__ == "__main__":
    main()
