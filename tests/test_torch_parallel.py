"""The port's mesh (``gru4rec_tpu_torch/parallel/``) against the JAX package's,
on the CPU over ``gloo``.

Each mesh shape (2x2, 1x2, 2x1, 1x1) is spawned once for the module as
``tests/torch_dist_worker.py`` processes, one per rank (2x2 and 2x1 from the
launcher's environment, 1x2 through ``init_distributed(coordinator_address=)``,
1x1 in processes started without a launcher); each rank writes what it read
to an ``.npz``. The JAX references run meanwhile in this process, on the 8
virtual CPU devices of ``tests/conftest.py``. Cases:

* ``factor_mesh``, the rank layout and groups of ``make_mesh``, and which
  leaves are row-sharded (``param_specs`` / ``state_specs`` against JAX's
  ``param_pspecs`` / ``state_pspecs``);
* one distributed chunk (the packed step stack, run by the eager loop: a
  gloo mesh is never captured) against JAX's ``make_dist_chunk_fn`` on
  ``make_mesh(nd, nm)`` from the same state, with JAX's negatives and
  stochastic-rounding seeds, in all three input modes, adagrad and adam,
  float32 and ``bfloat16_sr`` state: loss rtol 1e-4, parameters rtol 2e-4 /
  atol 1e-6, bf16 state atol 1e-3;
* on every shape: stochastically rounded row-shard updates keyed by 0-d
  int32 seed tensors equal the same seeds as ints and the whole table's
  update bit for bit; ``Mesh.all_gather``'s single-buffer collective equals
  the list form of ``dist.all_gather``; a gloo mesh is not capturable and
  its chunk function has no runner;
* a chunk in which one data rank's lanes are all padding, and a step that is
  padding everywhere, against the single-device chunk;
* ``fit(mesh=)`` with in-fit validation and ``keep_best`` against JAX's
  ``fit(mesh=)`` (negatives injected) and the port's single-device fit;
* ``evaluate(mesh=)`` in every deterministic tie mode, with and without an
  item subset, against the port's single-device ``evaluate`` (atol 1e-6)
  and JAX's single-device one on the same weights, ranking activated scores
  (``rank_invariant`` patched False, ``_CHUNK_FN_CACHE`` cleared: F1); the
  tiebreaking mode by distribution only (F3); ``batch_size`` rounded down to
  the data axis;
* ``predict_topk(mesh=)`` against JAX's, an elu and a softmax head: ids
  where the scores are distinct, scores within atol 1e-6; the lane state
  carries on into a single-device call;
* rank 0 alone writes the checkpoint, and a mesh resume equals an
  uninterrupted mesh run bit for bit; ``retrain=True`` under a mesh;
* a 1x1 mesh is bit-equal to the single-device ``fit``, ``evaluate`` and
  ``predict_topk``.

Every spawn and wait has a wall-clock limit, so a hang fails the module's
tests instead of running out the suite's clock.
"""

import json
import os
import socket
import subprocess
import sys
import time
import types

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
from gru4rec_tpu.parallel import dist_step as jdist  # noqa: E402
from gru4rec_tpu.parallel import mesh as jmesh  # noqa: E402
from gru4rec_tpu.train import step as jstep  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap  # noqa: E402
from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order  # noqa: E402
from gru4rec_tpu_torch.data.tools import compute_offset  # noqa: E402
from gru4rec_tpu_torch.models import gru as tgru  # noqa: E402
from gru4rec_tpu_torch.ops.sampling import build_alias_table  # noqa: E402
from gru4rec_tpu_torch.parallel import dist_step, mesh as tmesh  # noqa: E402
from test_config_fuzz import draw_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
SPAWN_TIMEOUT = 240  # seconds for every spawn together

# shape -> (how the ranks initialize, worker tasks)
# the mesh primitives every shape checks (collective and seed forms, gloo
# kept eager)
FORMS = ["seed_forms", "gather_forms", "eager_by_design"]
SHAPES = {
    "2x2": ("env", ["chunk", "padding", "clip", "fit", "checkpoint", "retrain", "evaluate",
                    "topk"] + FORMS),
    "1x2": ("tcp", ["chunk", "evaluate", "topk"] + FORMS),
    "2x1": ("env", ["chunk", "padding", "evaluate", "topk"] + FORMS),
    "1x1": ("none", ["bit_equal", "chunk"] + FORMS),
}
CHUNK_CASES = {
    "constrained-adagrad": dict(constrained_embedding=True),
    "constrained-adam": dict(constrained_embedding=True, adapt="adam", learning_rate=0.01),
    "embedding-adagrad": dict(embedding=16),
    "onehot-adagrad": dict(),
    "constrained-adagrad-sr": dict(constrained_embedding=True, opt_state_dtype="bfloat16_sr"),
    "embedding-adam-sr": dict(embedding=16, adapt="adam", learning_rate=0.01,
                              opt_state_dtype="bfloat16_sr"),
}
CHUNK_SHAPES = {"2x2": list(CHUNK_CASES),
                "1x2": ["constrained-adagrad", "onehot-adagrad", "embedding-adam-sr"],
                "2x1": ["constrained-adagrad", "onehot-adagrad", "constrained-adagrad-sr",
                        "embedding-adam-sr"],
                "1x1": list(CHUNK_CASES)}
# the grad_cap draws of the config-surface fuzz (tests/test_config_fuzz.py;
# 2 and 11 one-hot, 3 with an embedding, 0 constrained): each draw's model,
# loss and optimizer fields on the chunk cases' data, through the 2x2 mesh
# against the port's single device (worker task "clip"), where global-norm
# clipping runs over row-sharded sparse gradients. The drawn cap of 5 is
# above every step's gradient norm on this data, so each draw runs again
# with a cap of 1e-4, which the steps' norms exceed.
CLIP_DRAWS = (0, 2, 3, 11)
CLIP_CASES = [f"clip-{d}{v}" for d in CLIP_DRAWS for v in ("", "-tight")]
TIGHT_CAP = 1e-4
CLIP_FIELDS = ("loss", "final_act", "hidden_act", "layers", "n_sample", "adapt", "momentum",
               "lmbd", "grad_cap", "logq", "smoothing", "embedding",
               "constrained_embedding", "learning_rate", "opt_state_dtype")
CHUNK_N_ITEMS = 90
CUTOFFS = [1, 5, 20]
TIE_MODES = ("standard", "conservative", "median")


def chunk_cfg(**kw):
    args = dict(loss="bpr-max", final_act="elu-1", layers=[16], batch_size=8, n_sample=12,
                chunk_size=5, item_pad_multiple=32, learning_rate=0.1, momentum=0.2,
                logq=1.0, adapt="adagrad", dropout_p_hidden=0.0, dropout_p_embed=0.0,
                sampler="searchsorted", compute_dtype="float32", opt_state_dtype="float32",
                constrained_embedding=False, embedding=0, seed=3)
    args.update(kw)
    return args


def clip_cfg(case):
    """``clip-<draw>``: the draw's fields; ``clip-<draw>-tight``: with the cap
    at ``TIGHT_CAP``."""
    draw = int(case.split("-")[1])
    kw = draw_config(np.random.RandomState(1000 + draw))
    assert kw["grad_cap"] > 0
    if case.endswith("-tight"):
        kw["grad_cap"] = TIGHT_CAP
    return chunk_cfg(**{k: kw[k] for k in CLIP_FIELDS if k in kw})


# the fit case: the slice's config (tests/test_torch_slice.py) at chunk_size 1
FIT_CFG = dict(loss="bpr-max", final_act="elu-0.5", layers=[32], batch_size=8, n_sample=16,
               sample_alpha=0.4, constrained_embedding=True, adapt="adagrad", momentum=0.4,
               learning_rate=0.05, compute_dtype="float32", opt_state_dtype="float32",
               chunk_size=1, n_epochs=2, seed=7)
CKPT_CFG = dict(loss="cross-entropy", final_act="softmax", layers=[16], batch_size=8,
                n_sample=8, n_epochs=3, chunk_size=32, item_pad_multiple=32,
                learning_rate=0.1, compute_dtype="float32", opt_state_dtype="float32")
RETRAIN_CFG = dict(loss="cross-entropy", final_act="softmax", layers=[16], batch_size=8,
                   n_sample=8, n_epochs=2, chunk_size=32, item_pad_multiple=32,
                   compute_dtype="float32")
BIT_CFG = dict(loss="bpr-max", final_act="elu-0.5", layers=[24], batch_size=8, n_sample=16,
               constrained_embedding=True, n_epochs=2, chunk_size=16, item_pad_multiple=32,
               dropout_p_hidden=0.2, dropout_p_embed=0.1, learning_rate=0.05, momentum=0.3)
# the evaluation models: an elu head on 60 items (96 rows: both shards of a
# 2-wide model axis hold items) and a softmax head (128 rows: the second
# shard holds padding only)
EVAL_MODELS = {
    "elu": dict(FIT_CFG, chunk_size=32, item_pad_multiple=32),
    "softmax": dict(loss="cross-entropy", final_act="softmax", layers=[16], batch_size=8,
                    n_sample=16, n_epochs=2, chunk_size=32, compute_dtype="float32",
                    learning_rate=0.1),
}
TOPK_SESSIONS = np.array([[1, 1, 2, 2, 3, 3, 4, 4], [1, 1, 9, 2, 3, 3, 4, 8]])
TOPK_INPUTS = np.array([[f"item_{i}" for i in (3, 7, 1, 0, 11, 5, 2, 9)],
                        [f"item_{i}" for i in (4, 8, 2, 1, 12, 6, 3, 10)]])


def markov(n_sessions, n_items=60, seed=0):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _put_frame(inputs, name, df):
    for col in ("SessionId", "ItemId", "Time"):
        inputs[f"{name}/{col}"] = np.asarray(df[col].to_numpy(),
                                             dtype=str if col == "ItemId" else np.int64)


def _chunk_inputs(inputs):
    """Each chunk case's schedule, JAX's negatives and SR seeds; the padding
    case (data rank 1's lanes dead for steps 1-2, step 3 dead everywhere)."""
    rng = np.random.RandomState(0)
    C, B, n = 5, 8, CHUNK_N_ITEMS
    n_pad = tgru.pad_items(n, 32)
    cdf = np.linspace(0.01, 1.0, n, dtype=np.float32)
    logp0 = (np.abs(rng.randn(n_pad)) + 0.1).astype(np.float32)
    cases = {case: chunk_cfg(**kw) for case, kw in CHUNK_CASES.items()}
    cases["padding"] = chunk_cfg(constrained_embedding=True)
    cases.update({case: clip_cfg(case) for case in CLIP_CASES})
    for case, kw in cases.items():
        cfg = gru4rec_tpu.GRU4RecConfig(**kw)
        in_c = rng.randint(0, n, (C, B)).astype(np.int32)
        out_c = rng.randint(0, n, (C, B)).astype(np.int32)
        valid = np.ones((C, B), bool)
        valid[-1, B // 2:] = False  # dead lanes
        if case == "padding":
            valid[1:3, B // 2:] = False
            valid[3] = False
        reset = np.zeros((C, B), bool)
        reset[0] = True
        reset[2, :2] = True
        key = jax.random.PRNGKey(cfg.seed)
        neg = np.asarray(jax_draw_negatives(
            jax.random.fold_in(jax.random.fold_in(key, 1), 0), jnp.asarray(cdf), C,
            cfg.n_sample, n, cfg.sample_alpha, cfg.sampler))
        p = f"chunk/{case}"
        inputs.update({f"{p}/cfg": json.dumps(kw), f"{p}/n_items": n,
                       f"{p}/in": in_c, f"{p}/out": out_c, f"{p}/valid": valid,
                       f"{p}/reset": reset, f"{p}/samp1": cdf, f"{p}/logp0": logp0,
                       f"{p}/neg": neg})
        for table in jstep.SR_TABLE_SALT:
            inputs[f"{p}/seed/{table}"] = np.array([
                int(seed_from_key(jax.random.fold_in(
                    jax.random.fold_in(jax.random.fold_in(key, 0), s),
                    jstep.SR_TABLE_SALT[table]))) for s in range(C)], np.int64)
    for shape, names in CHUNK_SHAPES.items():
        inputs[f"chunk_cases/{shape}"] = json.dumps(names)
    inputs["clip_cases"] = json.dumps(CLIP_CASES)


def _fit_inputs(inputs):
    """The fit case's data and JAX's negative draw of every step."""
    train, valid = markov(150), markov(40, seed=5)
    cfg = gru4rec_tpu_torch.GRU4RecConfig(**FIT_CFG)
    itemidmap = build_itemidmap(train, "ItemId")
    data = apply_itemidmap(train, itemidmap, "ItemId")
    offsets = compute_offset(data, "SessionId")
    order = session_order(data, "SessionId", "Time", cfg.time_sort, len(offsets) - 1)
    T = build_schedule(data["ItemIdx"].values.astype(np.int32), offsets, order,
                       cfg.batch_size).n_steps
    pop = data.groupby("ItemId").size().reindex(itemidmap.index.values).values
    packed = jnp.asarray(build_alias_table(pop, cfg.sample_alpha))
    k1 = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 1)
    draw = jax.jit(jax.vmap(lambda s: jax_draw_negatives(
        jax.random.fold_in(k1, s), packed, 1, cfg.n_sample, len(itemidmap),
        cfg.sample_alpha, "alias")[0]))
    inputs["fit/neg"] = np.asarray(draw(jnp.arange(T * cfg.n_epochs)))
    inputs["fit/cfg"] = json.dumps(FIT_CFG)
    _put_frame(inputs, "fit/train", train)
    _put_frame(inputs, "fit/valid", valid)
    return train, valid


def _eval_inputs(inputs, d):
    """The evaluation models, trained by the port on one device, and their
    archives (which both packages load)."""
    models = {}
    for name, kw in EVAL_MODELS.items():
        m = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**kw), device="cpu")
        m.fit(markov(150))
        path = str(d / f"eval_{name}.npz")
        m.savemodel(path)
        inputs[f"eval/{name}/path"] = path
        models[name] = path
    inputs["eval/models"] = json.dumps(list(EVAL_MODELS))
    inputs["eval/subset"] = np.array([f"item_{i}" for i in range(0, 60, 2)])
    _put_frame(inputs, "eval/test", markov(40, seed=5))
    inputs["topk/sessions"] = TOPK_SESSIONS
    inputs["topk/inputs"] = TOPK_INPUTS
    return models


def _spawn(d, inputs_path):
    procs = []
    for shape, (init, _) in SHAPES.items():
        nd, nm = (int(x) for x in shape.split("x"))
        out_dir = d / shape
        out_dir.mkdir()
        port = _free_port()
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "OMP_NUM_THREADS": "1", "GRU4REC_TPU_NAN_DUMP": ""}
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        for r in range(nd * nm):
            log = open(out_dir / f"rank{r}.log", "w")
            # output to files, not pipes: the ranks wait on each other in
            # collectives, so a full pipe would stall them all
            procs.append((shape, r, log, subprocess.Popen(
                [sys.executable, WORKER, str(r), str(nd), str(nm), str(port), init,
                 inputs_path, str(out_dir)],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)))
    return procs


def _wait(procs, d, deadline):
    failed = []
    try:
        for shape, r, log, p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                failed.append(f"{shape} rank {r}: timed out")
                continue
            if p.returncode != 0:
                failed.append(f"{shape} rank {r}: exit {p.returncode}")
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(f"--- {s} rank {r}\n" + (d / s / f"rank{r}.log").read_text()[-3000:]
                         for s, r, _, _ in procs)
        pytest.fail("mesh workers failed: " + "; ".join(failed) + "\n" + logs)


def _jax_chunk(case, nd, nm, inputs):
    cfg = gru4rec_tpu.GRU4RecConfig(**json.loads(inputs[f"chunk/{case}/cfg"]))
    mesh = jmesh.make_mesh(nd, nm)
    s = jdist.shard_train_state(
        jstep.init_train_state(cfg, CHUNK_N_ITEMS, jax.random.PRNGKey(cfg.seed)), cfg, mesh)
    fn = jdist.make_dist_chunk_fn(cfg, CHUNK_N_ITEMS, mesh)
    args = [inputs[f"chunk/{case}/{k}"] for k in ("in", "out", "valid", "reset", "samp1",
                                                   "logp0")]
    params, opt, H, key, step, loss, ev = fn(s.params, s.opt_state, s.H, s.key, s.step,
                                             *map(jnp.asarray, args))
    u = jdist.unshard_train_state(
        s._replace(params=params, opt_state=opt, H=H, key=key, step=step), cfg, mesh)
    return float(loss), float(ev), u


def jax_evaluate(model, test, **kw):
    """JAX's single-device evaluate on activated scores (F1)."""
    saved = jeval.rank_invariant
    jeval.rank_invariant = lambda name: False
    jeval._CHUNK_FN_CACHE.clear()
    try:
        return jeval.evaluate(model, test, **kw)
    finally:
        jeval.rank_invariant = saved
        jeval._CHUNK_FN_CACHE.clear()


def _jax_topk(path, mesh):
    m = gru4rec_tpu.GRU4Rec.loadmodel(path)
    return [m.predict_topk(s, list(i), k=7, batch=8, mesh=mesh)
            for s, i in zip(TOPK_SESSIONS, TOPK_INPUTS)]


def _single_refs(paths, test, subset):
    """The port's single-device evaluate and predict_topk on the models."""
    refs = {}
    for name, path in paths.items():
        m = gru4rec_tpu_torch.GRU4Rec.loadmodel(path, device="cpu")
        for mode in TIE_MODES + ("tiebreaking",):
            for items in ("full", "subset"):
                refs[f"eval/{name}/{mode}/{items}"] = np.array(gru4rec_tpu_torch.evaluate(
                    m, test, cut_off=CUTOFFS, batch_size=16, mode=mode,
                    items=subset if items == "subset" else None))
        for b in (14, 15):
            refs[f"eval/{name}/batch{b}"] = np.array(
                gru4rec_tpu_torch.evaluate(m, test, cut_off=CUTOFFS, batch_size=b))
        calls = [m.predict_topk(s, list(i), k=7, batch=8)
                 for s, i in zip(TOPK_SESSIONS, TOPK_INPUTS)]
        calls.append(m.predict_topk(TOPK_SESSIONS[-1], list(TOPK_INPUTS[0]), k=7, batch=8))
        refs[f"topk/{name}"] = calls
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    t0 = time.time()
    inputs = {"tasks": json.dumps({s: t for s, (_, t) in SHAPES.items()}),
              "ckpt/cfg": json.dumps(CKPT_CFG), "retrain/cfg": json.dumps(RETRAIN_CFG),
              "bit/cfg": json.dumps(BIT_CFG)}
    _chunk_inputs(inputs)
    train, valid = _fit_inputs(inputs)
    paths = _eval_inputs(inputs, d)
    inputs_path = str(d / "inputs.npz")
    np.savez(inputs_path, **inputs)
    procs = _spawn(d, inputs_path)
    try:
        ref = {"jax_chunk": {(shape, case): _jax_chunk(case, *map(int, shape.split("x")), inputs)
                             for shape, cases in CHUNK_SHAPES.items() for case in cases}}
        jfit = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**FIT_CFG))
        jfit.fit(train, mesh=jmesh.make_mesh(2, 2), eval_data=valid, eval_cutoff=5,
                 eval_batch_size=8, keep_best=True)
        ref["jax_fit"] = jfit
        test = markov(40, seed=5)
        subset = list(inputs["eval/subset"])
        ref["single"] = _single_refs(paths, test, subset)
        ref["jax_eval"] = {}
        for name, path in paths.items():
            jm = gru4rec_tpu.GRU4Rec.loadmodel(path)
            for mode in TIE_MODES:
                for items in ("full", "subset"):
                    if name == "softmax" and mode != "standard":
                        continue
                    ref["jax_eval"][(name, mode, items)] = np.array(jax_evaluate(
                        jm, test, cut_off=CUTOFFS, batch_size=16, mode=mode,
                        items=subset if items == "subset" else None))
        ref["jax_topk"] = {name: _jax_topk(path, jmesh.make_mesh(2, 2))
                           for name, path in paths.items()}
    finally:
        _wait(procs, d, t0 + SPAWN_TIMEOUT)
    out = {shape: [dict(np.load(d / shape / f"rank{r}.npz"))
                   for r in range(int(shape[0]) * int(shape[2]))] for shape in SHAPES}
    return types.SimpleNamespace(out=out, dir=d, **ref)


def _tree(npz, prefix):
    return {k[len(prefix) + 1:]: v for k, v in npz.items() if k.startswith(prefix + "/")}


def _jax_flat(params):
    """A JAX params pytree as ``{"Wy": a, "Wx/0": a, ...}`` numpy arrays."""
    out = {}
    for k, v in params.items():
        if isinstance(v, (list, tuple)):
            out.update({f"{k}/{i}": np.asarray(a, np.float32) for i, a in enumerate(v)})
        else:
            out[k] = np.asarray(v, np.float32)
    return out


# ---------------------------------------------------------------------- #
def test_factor_mesh_equals_jax():
    for n in range(1, 17):
        assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n), n


@pytest.mark.parametrize("mode_kw", [{"constrained_embedding": True}, {"embedding": 16}, {}],
                         ids=["constrained", "embedding", "onehot"])
def test_sharded_leaves_equal_jax_pspecs(mode_kw):
    """``param_specs`` / ``state_specs`` row-shard exactly the leaves JAX's
    ``param_pspecs`` / ``state_pspecs`` put on ``model``."""
    from gru4rec_tpu_torch.train.step import init_train_state

    kw = chunk_cfg(adapt="adam", **mode_kw)
    js = jstep.init_train_state(gru4rec_tpu.GRU4RecConfig(**kw), CHUNK_N_ITEMS,
                                jax.random.PRNGKey(0))
    ts = init_train_state(gru4rec_tpu_torch.GRU4RecConfig(**kw), CHUNK_N_ITEMS, "cpu")
    mode = tgru.input_mode(gru4rec_tpu_torch.GRU4RecConfig(**kw))

    def axis(spec):
        return "model" if spec[0] == "model" else None

    jp = jmesh.param_pspecs(js.params, mode)
    tp = tmesh.param_specs(ts.params, mode)
    assert set(jp) == set(tp)
    for k, v in jp.items():
        assert ([axis(s) for s in v] if isinstance(v, list) else axis(v)) == tp[k], k
    jst = jmesh.state_pspecs(js.opt_state)
    tst = tmesh.state_specs(ts.opt_state)
    assert {n: {s: axis(p) for s, p in st.items()} for n, st in jst["sparse"].items()} \
        == tst["sparse"]
    assert all(v is None for group in tst["dense"].values() for st in group
               for v in st.values())


@pytest.mark.parametrize("shape", list(SHAPES))
def test_make_mesh_rank_layout_and_groups(runs, shape):
    nd, nm = int(shape[0]), int(shape[2])
    for r, o in enumerate(runs.out[shape]):
        di, mi = divmod(r, nm)
        assert (int(o["rank"]), int(o["di"]), int(o["mi"])) == (r, di, mi)
        assert list(o["model_ranks"]) == [di * nm + m for m in range(nm)]
        assert list(o["data_ranks"]) == [d * nm + mi for d in range(nd)]


@pytest.mark.parametrize("shape,case", [(s, c) for s, cs in CHUNK_SHAPES.items() for c in cs])
def test_dist_chunk_matches_jax(runs, shape, case):
    loss_j, ev_j, uj = runs.jax_chunk[(shape, case)]
    for o in runs.out[shape]:  # every rank holds the canonical result
        np.testing.assert_allclose(float(o[f"chunk/{case}/loss"]), loss_j, rtol=1e-4)
        assert int(o[f"chunk/{case}/events"]) == ev_j
        params = _tree(o, f"chunk/{case}/params")
        want = _jax_flat(uj.params)
        assert set(params) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(params[k], w, rtol=2e-4, atol=1e-6, err_msg=k)
        sparse = _tree(o, f"chunk/{case}/sparse")
        for table, st in uj.opt_state["sparse"].items():
            for slot, w in st.items():
                w = np.asarray(w)
                bf16 = w.dtype.name == "bfloat16"
                np.testing.assert_allclose(sparse[f"{table}/{slot}"], w.astype(np.float32),
                                           rtol=0 if bf16 else 2e-4, atol=1e-3 if bf16 else 1e-6,
                                           err_msg=f"{table}/{slot}")
        for i, h in enumerate(uj.H):
            np.testing.assert_allclose(o[f"chunk/{case}/H/{i}"], np.asarray(h),
                                       rtol=2e-4, atol=1e-6)



@pytest.mark.parametrize("case", CLIP_CASES)
def test_grad_cap_on_the_mesh_equals_one_device(runs, case):
    """Global-norm clipping on the 2x2 mesh, over the row-sharded sparse
    gradients of every rank, against the port's single device on the same
    chunk: loss rtol 1e-4, parameters and state within the mesh tolerances
    above; under the tight cap the clip bites (the unclipped chunk ends
    elsewhere), under the drawn cap of 5 it does not."""
    bites = case.endswith("-tight")
    for o in runs.out["2x2"]:
        loss, loss1 = o[f"{case}/loss"]
        np.testing.assert_allclose(loss, loss1, rtol=1e-4)
        one = _tree(o, f"{case}/single")
        got = _tree(o, f"{case}/mesh")
        assert set(got) == set(one)
        for k, w in one.items():
            bf16 = k.startswith("sparse/") and str(o[f"{case}/dtype/{k}"]) == "bfloat16"
            np.testing.assert_allclose(got[k], w, rtol=0 if bf16 else 2e-4,
                                       atol=1e-3 if bf16 else 1e-6, err_msg=f"{case} {k}")
        moved = np.abs(one["params/Wy"] - o[f"{case}/uncapped_Wy"]).max()
        assert (moved > 1e-4) if bites else (moved == 0), (case, moved)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tensor_seeds_equal_int_seeds_on_row_shards(runs, shape):
    """Stochastically rounded updates of a row-shard keyed by 0-d int32 seed
    tensors (the packed step stack's views) equal the same seeds as ints and
    the whole table's update, bit for bit."""
    for o in runs.out[shape]:
        for adapt in ("adagrad", "adam"):
            tensor_vs_int, tensor_vs_whole = o[f"seed_forms/{adapt}"]
            assert tensor_vs_int, (adapt, int(o["rank"]))
            assert tensor_vs_whole, (adapt, int(o["rank"]))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_all_gather_single_buffer_equals_list_form(runs, shape):
    for o in runs.out[shape]:
        assert o["gather_forms"].all(), o["gather_forms"]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_gloo_mesh_runs_eagerly(runs, shape):
    """A gloo mesh is not capturable: its chunk function has no runner."""
    for o in runs.out[shape]:
        capturable, runner_none, eager_runner_none = o["eager_by_design"]
        assert not capturable and runner_none and eager_runner_none


@pytest.mark.parametrize("shape", ["2x2", "2x1"])
def test_all_padding_lane_block_joins_every_step(runs, shape):
    """Data rank 1's lanes are padding for two steps and every lane for one:
    each rank ran every step and matches the single-device chunk."""
    for o in runs.out[shape]:
        np.testing.assert_allclose(o["padding/loss"][0], o["padding/loss"][1], rtol=1e-4)
        assert o["padding/events"][0] == o["padding/events"][1]
        assert o["padding/step"][0] == o["padding/step"][1] == 5
        mesh_p, single_p = _tree(o, "padding/mesh"), _tree(o, "padding/single")
        for k, w in single_p.items():
            np.testing.assert_allclose(mesh_p[k], w, rtol=2e-4, atol=1e-6, err_msg=k)


def test_fit_with_validation_and_keep_best_matches_jax(runs):
    jm = runs.jax_fit
    for o in runs.out["2x2"]:
        np.testing.assert_allclose(o["fit/mesh/loss"], [e["loss"] for e in jm.epoch_stats],
                                   rtol=1e-4)
        # JAX's mesh evaluator ranks logits (F2): equal up to a saturated tie
        np.testing.assert_allclose(o["fit/mesh/recall"], [v["recall"] for v in jm.valid_stats],
                                   atol=0.02)
        np.testing.assert_allclose(o["fit/mesh/mrr"], [v["mrr"] for v in jm.valid_stats],
                                   atol=0.02)
        params = _tree(o, "fit/mesh/params")
        for k, w in _jax_flat(jm.params).items():
            np.testing.assert_allclose(params[k], w, rtol=0, atol=1e-5, err_msg=k)


def test_fit_on_a_mesh_follows_the_single_device_fit(runs):
    """The same negatives: the mesh run and the one-device run agree up to
    the order of the sums; in-fit validation metrics are equal."""
    for o in runs.out["2x2"]:
        np.testing.assert_allclose(o["fit/mesh/loss"], o["fit/single/loss"], rtol=1e-5)
        np.testing.assert_allclose(o["fit/mesh/recall"], o["fit/single/recall"], atol=1e-6)
        np.testing.assert_allclose(o["fit/mesh/mrr"], o["fit/single/mrr"], atol=1e-6)
        single = _tree(o, "fit/single/params")
        for k, v in _tree(o, "fit/mesh/params").items():
            np.testing.assert_allclose(v, single[k], rtol=2e-4, atol=1e-6, err_msg=k)


def test_rank0_alone_writes_and_mesh_resume_is_exact(runs):
    for o in runs.out["2x2"]:
        assert list(o["ckpt/wrote"]) == [o["rank"] == 0] * 2
        assert list(o["ckpt/epochs"]) == [3, 1]
        assert o["ckpt/loss"][0] == o["ckpt/loss"][1]
        assert o["ckpt/equal"].all()
    assert (runs.dir / "2x2" / "mesh_ck.npz").exists()


def test_retrain_under_a_mesh(runs):
    for o in runs.out["2x2"]:
        for name in ("mesh", "single"):
            n0, n1 = o[f"retrain/{name}/n_items"]
            assert n1 > n0
        assert o["retrain/mesh/recall"][0] > 0.5
        np.testing.assert_allclose(o["retrain/mesh/recall"], o["retrain/single/recall"],
                                   atol=1e-6)
        single = _tree(o, "retrain/single/params")
        for k, v in _tree(o, "retrain/mesh/params").items():
            np.testing.assert_allclose(v, single[k], rtol=2e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("items", ["full", "subset"])
@pytest.mark.parametrize("model", list(EVAL_MODELS))
@pytest.mark.parametrize("shape", ["2x2", "1x2", "2x1"])
def test_evaluate_on_a_mesh(runs, shape, model, items):
    """Activated scores on every shard: the port's single-device metrics,
    and JAX's single-device ones on the same weights."""
    for o in runs.out[shape]:
        for mode in TIE_MODES:
            got = o[f"eval/{model}/{mode}/{items}"]
            np.testing.assert_allclose(got, runs.single[f"eval/{model}/{mode}/{items}"],
                                       rtol=0, atol=1e-6, err_msg=mode)
            want = runs.jax_eval.get((model, mode, items))
            if want is not None:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=mode)


@pytest.mark.parametrize("shape", ["2x2", "1x2", "2x1"])
def test_evaluate_tiebreaking_by_distribution(runs, shape):
    for o in runs.out[shape]:
        for model in EVAL_MODELS:
            for items in ("full", "subset"):
                got = o[f"eval/{model}/tiebreaking/{items}"]
                std = runs.single[f"eval/{model}/standard/{items}"]
                cons = runs.single[f"eval/{model}/conservative/{items}"]
                assert np.all(got[0] <= std[0] + 1e-6) and np.all(got[0] >= cons[0] - 1e-6)
                np.testing.assert_allclose(
                    got, runs.single[f"eval/{model}/tiebreaking/{items}"], atol=0.05)


@pytest.mark.parametrize("shape", ["2x2", "1x2", "2x1"])
def test_evaluate_rounds_batch_down_to_the_data_axis(runs, shape):
    """batch_size 15 on a 2-wide data axis runs at 14 (the lane packing of
    a single-device run at 14); on a 1-wide one at 15."""
    ran_at = 15 - 15 % int(shape[0])
    for o in runs.out[shape]:
        for model in EVAL_MODELS:
            np.testing.assert_allclose(o[f"eval/{model}/batch15"],
                                       runs.single[f"eval/{model}/batch{ran_at}"], atol=1e-6)


@pytest.mark.parametrize("model", list(EVAL_MODELS))
@pytest.mark.parametrize("shape", ["2x2", "1x2", "2x1"])
def test_predict_topk_on_a_mesh_matches_jax(runs, shape, model):
    for o in runs.out[shape]:
        for i, (ids_j, sc_j) in enumerate(runs.jax_topk[model]):
            ids, sc = o[f"topk/{model}/{i}/ids"], o[f"topk/{model}/{i}/scores"]
            np.testing.assert_allclose(sc, sc_j, rtol=0, atol=1e-6)
            # ids where the scores are distinct (tied scores may order apart)
            distinct = np.ones_like(sc, bool)
            distinct[:, 1:] &= np.abs(np.diff(sc, axis=1)) > 1e-6
            distinct[:, :-1] &= np.abs(np.diff(sc, axis=1)) > 1e-6
            assert (ids[distinct] == ids_j.astype(str)[distinct]).all()


@pytest.mark.parametrize("shape", ["2x2", "1x2", "2x1"])
def test_predict_topk_lanes_are_shared_with_one_device(runs, shape):
    """Two mesh calls, then a single-device call: the lanes carried over, as
    three single-device calls carry them."""
    for o in runs.out[shape]:
        for model in EVAL_MODELS:
            calls = runs.single[f"topk/{model}"]
            for i in range(2):
                np.testing.assert_allclose(o[f"topk/{model}/{i}/scores"], calls[i][1],
                                           rtol=0, atol=1e-6)
            np.testing.assert_allclose(o[f"topk/{model}/after/scores"], calls[2][1],
                                       rtol=0, atol=1e-6)


def test_one_by_one_mesh_is_bit_equal_to_one_device(runs):
    (o,) = runs.out["1x1"]
    assert len(o["bit/leaves"]) == 15  # parameters, accumulators, velocities
    assert o["bit/fit"].all(), o["bit/fit"]
    assert o["bit/evaluate"].all(), o["bit/evaluate"]
    assert o["bit/topk"].all()


def test_detect_scratch_layout_takes_the_canonical_rows_only():
    cfg = gru4rec_tpu_torch.GRU4RecConfig(item_pad_multiple=32)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    n_pad = tgru.pad_items(60, 32)
    assert dist_step.detect_scratch_layout({"Wy": torch.zeros(n_pad, 4)}, 60, cfg, mesh) == 0
    # JAX's training layout (8 scratch rows per shard) does not exist here
    with pytest.raises(ValueError, match="canonical"):
        dist_step.detect_scratch_layout({"Wy": torch.zeros(n_pad + 16, 4)}, 60, cfg, mesh)
