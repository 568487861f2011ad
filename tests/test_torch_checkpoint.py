"""The port's checkpoints against the JAX package's, on the CPU.

* Archive layout: for every ``adapt`` and every ``opt_state_dtype``, the
  port's model archive (with the optimizer) and training checkpoint hold
  the JAX package's keys, apart from the random state (JAX's
  ``state/key``/``state/key_typed``, the port's
  ``state/torch_gen``/``state/torch_gen_device``), with the same shapes,
  dtypes and ``opt_dtype`` tags, and the same values where both start from
  the same initialisation.
* Model archives cross-load both ways with equal predictions (float32
  within rtol 1e-5 / atol 1e-6, a bf16-cast model within rtol 1e-2), and
  ``include_optimizer=True`` leaves come back bit for bit.
* A port resume equals an uninterrupted run exactly, under ``float32`` and
  ``bfloat16_sr``, with ``train_random_order`` on and off.
* A JAX training checkpoint resumes in the port with equal weights, state,
  step and epoch (and a generator seeded from ``cfg.seed``, which it says).
* ``_extend_items`` grows the tables and their state exactly as the JAX
  package does, bit for bit.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gru4rec_tpu  # noqa: E402
from gru4rec_tpu.data.loader import build_itemidmap  # noqa: E402
from gru4rec_tpu.io import checkpoint as jckpt  # noqa: E402
from gru4rec_tpu.train import step as jstep  # noqa: E402
import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from gru4rec_tpu_torch.io.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from gru4rec_tpu_torch.models.gru import map_params  # noqa: E402
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402

N_ITEMS = 30
TOL = dict(rtol=1e-5, atol=1e-6)
MODES = {"constrained": {"constrained_embedding": True},
         "embedding": {"embedding": 12}, "onehot": {}}
GEN_KEYS_JAX = {"state/key", "state/key_typed"}
GEN_KEYS_PORT = {"state/torch_gen", "state/torch_gen_device"}


def markov(n_sessions, n_items=N_ITEMS, seed=0, prefix="item_"):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"{prefix}{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def cfg_kwargs(mode="constrained", **kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                momentum=0.4, chunk_size=16, n_epochs=1, item_pad_multiple=8, seed=3,
                **MODES[mode])
    args.update(kw)
    return args


def bits(x):
    """(dtype name, exact bit pattern) of a JAX array, numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().dtype.name, x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.uint16)
    return a.dtype.name, a


def assert_bit_equal(got, want, what=""):
    (dg, bg), (dw, bw) = bits(got), bits(want)
    assert dg == dw, (what, dg, dw)
    np.testing.assert_array_equal(bg, bw, err_msg=what)


def assert_leaves_bit_equal(t_opt, j_opt):
    t_leaves = tckpt.flatten_opt_state(t_opt)
    j_leaves = jax.tree_util.tree_leaves(j_opt)
    assert len(t_leaves) == len(j_leaves)
    for i, (a, b) in enumerate(zip(t_leaves, j_leaves)):
        assert_bit_equal(a, b, f"opt leaf {i}")


def assert_params_bit_equal(t_params, j_params):
    j_params = jax.tree_util.tree_map(np.asarray, j_params)
    assert set(t_params) == set(j_params)
    for k in t_params:
        t = t_params[k] if isinstance(t_params[k], list) else [t_params[k]]
        j = j_params[k] if isinstance(j_params[k], list) else [j_params[k]]
        assert len(t) == len(j)
        for i, (a, b) in enumerate(zip(t, j)):
            assert_bit_equal(a, b, f"{k}[{i}]")


_SESSIONS = iter(range(1_000_000, 10**9, 1_000))


def serve(m, seed=0):
    """Scores of a short request stream: fresh sessions on every lane, then
    a change of session on two of the four."""
    rng = np.random.RandomState(seed)
    base = next(_SESSIONS)
    out = []
    for sess in (base + np.arange(4), base + np.array([0, 11, 2, 13])):
        items = [f"item_{i}" for i in rng.randint(N_ITEMS, size=4)]
        out.append(m.predict_next_batch(sess, items, batch=4).values)
    return np.stack(out)


def init_pair(mode, **kw):
    """A JAX and a port model over the same catalog, each holding its own
    package's fresh training state (the same initial weights)."""
    cfg_j = gru4rec_tpu.GRU4RecConfig(**cfg_kwargs(mode, **kw))
    cfg_t = gru4rec_tpu_torch.GRU4RecConfig(**cfg_kwargs(mode, **kw))
    itemidmap = build_itemidmap(markov(60), "ItemId")
    n = len(itemidmap)
    m_j, m_t = gru4rec_tpu.GRU4Rec(cfg_j), gru4rec_tpu_torch.GRU4Rec(cfg_t, device="cpu")
    m_j._train_state = jstep.init_train_state(cfg_j, n, jax.random.PRNGKey(0))
    m_t._train_state = tstep.init_train_state(cfg_t, n, "cpu")
    for m in (m_j, m_t):
        m.itemidmap, m.n_items = itemidmap, n
        m.params, m.H = m._train_state.params, m._train_state.H
    return m_j, m_t


# (adapt, mode): every optimizer, every input mode somewhere
LAYOUTS = [("adagrad", "constrained"), ("rmsprop", "embedding"), ("adadelta", "onehot"),
           ("adam", "embedding"), ("adam", "constrained"), (None, "onehot")]


@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16", "bfloat16_sr"])
@pytest.mark.parametrize("adapt,mode", LAYOUTS)
def test_archive_layout_matches_jax(adapt, mode, opt_state_dtype, tmp_path):
    m_j, m_t = init_pair(mode, adapt=adapt, opt_state_dtype=opt_state_dtype)
    for kind in ("model", "train"):
        pj, pt = str(tmp_path / f"{kind}_j.npz"), str(tmp_path / f"{kind}_t.npz")
        if kind == "model":
            jckpt.save_model(m_j, pj, include_optimizer=True)
            tckpt.save_model(m_t, pt, include_optimizer=True)
        else:
            jckpt.save_train_checkpoint(m_j, m_j._train_state, 1, pj)
            tckpt.save_train_checkpoint(m_t, m_t._train_state, 1, pt)
        with np.load(pj) as aj, np.load(pt) as at:
            kj, kt = set(aj.files), set(at.files)
            if kind == "train":
                assert GEN_KEYS_JAX <= kj and GEN_KEYS_PORT <= kt
                kj, kt = kj - GEN_KEYS_JAX, kt - GEN_KEYS_PORT
            assert kt == kj, (kind, sorted(kt ^ kj))
            assert any(k.startswith("opt/") for k in kt)
            for k in sorted(kt):
                # the same initial weights, zero state: equal values too
                assert at[k].dtype == aj[k].dtype and at[k].shape == aj[k].shape, k
                np.testing.assert_array_equal(at[k], aj[k], err_msg=k)


def test_model_archives_cross_load(tmp_path):
    kw = cfg_kwargs(opt_state_dtype="bfloat16")  # bf16 velocity leaves
    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**kw))
    m_j.fit(markov(60))
    want = serve(m_j)

    # JAX -> port, with the optimizer: leaves and step bit for bit
    pj = str(tmp_path / "jax.npz")
    m_j.savemodel(pj, include_optimizer=True)
    m_t = gru4rec_tpu_torch.GRU4Rec.loadmodel(pj, device="cpu")
    assert m_t.device.type == "cpu" and m_t.params["Wy"].device.type == "cpu"
    assert_params_bit_equal(m_t.params, m_j.params)
    assert_leaves_bit_equal(m_t._train_state.opt_state, m_j._train_state.opt_state)
    assert m_t._train_state.step == int(m_j._train_state.step) > 0
    assert list(m_t.itemidmap.index) == list(m_j.itemidmap.index)
    np.testing.assert_allclose(serve(m_t), want, **TOL)

    # port -> JAX, with the optimizer
    pt = str(tmp_path / "port.npz")
    m_t.savemodel(pt, include_optimizer=True)
    m_j2 = gru4rec_tpu.GRU4Rec.loadmodel(pt)
    assert_params_bit_equal(m_t.params, m_j2.params)
    assert_leaves_bit_equal(m_t._train_state.opt_state, m_j2._train_state.opt_state)
    assert int(m_j2._train_state.step) == m_t._train_state.step
    np.testing.assert_allclose(serve(m_j2), want, **TOL)

    # the port's own weights, port -> JAX
    m_own = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**kw), device="cpu")
    m_own.fit(markov(60, seed=4))
    m_own.savemodel(pt)
    m_j3 = gru4rec_tpu.GRU4Rec.loadmodel(pt)
    assert m_j3._train_state is None
    np.testing.assert_allclose(serve(m_own, seed=1), serve(m_j3, seed=1), **TOL)

    # bf16-cast models, both ways: the same bf16 bits, scores within 1e-2
    m_j.cast_for_serving("bfloat16")
    m_j.savemodel(pj)
    m_tb = gru4rec_tpu_torch.GRU4Rec.loadmodel(pj, device="cpu")
    assert m_tb.params["Wy"].dtype == torch.bfloat16
    assert_params_bit_equal(m_tb.params, m_j.params)
    np.testing.assert_allclose(serve(m_tb), serve(m_j), rtol=1e-2, atol=1e-3)
    m_own.cast_for_serving("bfloat16").savemodel(pt)
    m_jb = gru4rec_tpu.GRU4Rec.loadmodel(pt)
    assert_params_bit_equal(m_own.params, m_jb.params)
    np.testing.assert_allclose(serve(m_own, seed=1), serve(m_jb, seed=1),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("random_order", [False, True])
@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16_sr"])
def test_port_resume_is_exact(opt_state_dtype, random_order, tmp_path):
    kw = cfg_kwargs(opt_state_dtype=opt_state_dtype, train_random_order=random_order,
                    dropout_p_hidden=0.2, n_epochs=3, chunk_size=8)
    data = markov(80)
    ckpt = str(tmp_path / "ck.npz")

    def model():
        return gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**kw), device="cpu")

    straight = model().fit(data)
    first = model().fit(data, n_epochs=2, checkpoint_every=2, checkpoint_path=ckpt)
    assert first._completed_epochs == 2
    resumed = model().fit(data, resume=ckpt)
    assert [e["loss"] for e in resumed.epoch_stats] == [straight.epoch_stats[-1]["loss"]]
    s, r = straight._train_state, resumed._train_state
    assert r.step == s.step and resumed._completed_epochs == 3
    for k in s.params:
        for a, b in zip(*(p[k] if isinstance(p[k], list) else [p[k]]
                          for p in (s.params, r.params))):
            assert torch.equal(a, b), k
    for a, b in zip(tckpt.flatten_opt_state(s.opt_state),
                    tckpt.flatten_opt_state(r.opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if opt_state_dtype == "bfloat16_sr":
        assert s.opt_state["sparse"]["Wy"]["acc"].dtype == torch.bfloat16
    # save_checkpoint() counts epochs across the resume
    resumed.save_checkpoint(ckpt)
    with np.load(ckpt) as a:
        assert int(a["meta/epoch"]) == 3 and int(a["state/step"]) == s.step


def test_jax_training_checkpoint_resumes_in_port(tmp_path, capsys):
    kw = cfg_kwargs(n_epochs=2, opt_state_dtype="bfloat16")
    data = markov(60)
    ckpt = str(tmp_path / "jax_ck.npz")
    m_j = gru4rec_tpu.GRU4Rec(gru4rec_tpu.GRU4RecConfig(**kw))
    m_j.fit(data, n_epochs=1, checkpoint_every=1, checkpoint_path=ckpt)
    js, jepoch = jckpt.load_train_checkpoint(ckpt, gru4rec_tpu.GRU4Rec())

    m_t = gru4rec_tpu_torch.GRU4Rec(device="cpu")
    capsys.readouterr()
    ts, tepoch = tckpt.load_train_checkpoint(ckpt, m_t)
    assert "seeded with cfg.seed=3" in capsys.readouterr().out
    assert tepoch == jepoch == 1 and ts.step == int(js.step) > 0
    assert m_t.config.to_dict() == gru4rec_tpu_torch.GRU4RecConfig(**kw).to_dict()
    assert_params_bit_equal(ts.params, js.params)
    assert_leaves_bit_equal(ts.opt_state, js.opt_state)
    for a, b in zip(ts.H, js.H):
        assert_bit_equal(a, b, "H")

    # fit(resume=) trains the remaining epoch from there
    m_t = gru4rec_tpu_torch.GRU4Rec(device="cpu")
    m_t.fit(data, resume=ckpt)
    out = capsys.readouterr().out
    assert "Resuming training from" in out and "seeded with cfg.seed=3" in out
    assert len(m_t.epoch_stats) == 1 and m_t._completed_epochs == 2
    assert m_t._train_state.step == int(js.step) + m_t.epoch_stats[0]["steps"]
    assert torch.isfinite(m_t.params["Wy"]).all()

    # a port archive from another device type: the same, with the message
    pt = str(tmp_path / "port_ck.npz")
    m_t.save_checkpoint(pt)
    with np.load(pt) as a:
        entries = {k: a[k] for k in a.files}
    entries["state/torch_gen_device"] = np.array("cuda")
    np.savez(pt, **entries)
    m_t2 = gru4rec_tpu_torch.GRU4Rec(device="cpu")
    ts2, epoch2 = tckpt.load_train_checkpoint(pt, m_t2)
    assert "(cuda archive)" in capsys.readouterr().out and epoch2 == 2
    assert_params_bit_equal(ts2.params, map_params(lambda t: t.numpy(), m_t.params))


@pytest.mark.parametrize("mode", list(MODES))
def test_extend_items_matches_jax(mode):
    m_j, m_t = init_pair(mode, opt_state_dtype="bfloat16", adapt="adagrad")
    # live optimizer state: random values in every slot
    rng = np.random.RandomState(4)
    j_opt = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32), a.dtype),
        m_j._train_state.opt_state)
    m_j._train_state = m_j._train_state._replace(opt_state=j_opt)
    m_t._train_state.opt_state = opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, j_opt), device="cpu")
    m_t.params = params_from_jax(jax.tree_util.tree_map(np.asarray, m_j.params),
                                 device="cpu")
    m_t._train_state.params = m_t.params
    old_wy = m_t.params["Wy"]
    unseen = np.array([f"new_{i}" for i in range(11)], dtype=object)
    m_j._extend_items(unseen)
    m_t._extend_items(unseen)
    assert m_t.n_items == m_j.n_items == N_ITEMS + 11
    assert list(m_t.itemidmap.index) == list(m_j.itemidmap.index)
    assert (m_t.itemidmap.values == m_j.itemidmap.values).all()
    assert_params_bit_equal(m_t.params, m_j.params)
    assert_leaves_bit_equal(m_t._train_state.opt_state, m_j._train_state.opt_state)
    assert m_t._train_state.params is m_t.params and m_t.params["Wy"] is not old_wy
    sparse = m_t._train_state.opt_state["sparse"]
    assert sparse["Wy"]["velocity"].dtype == torch.bfloat16
    assert all(st[k].shape[0] == m_t.params["Wy"].shape[0]
               for st in sparse.values() for k in st)


def test_retrain_after_loadmodel(tmp_path, capsys):
    kw = cfg_kwargs()
    m = gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**kw), device="cpu")
    m.fit(markov(60))
    bare, full = str(tmp_path / "bare.npz"), str(tmp_path / "full.npz")
    m.savemodel(bare)
    m.savemodel(full, include_optimizer=True)
    new = markov(40, n_items=N_ITEMS + 6, seed=5)
    m2 = gru4rec_tpu_torch.GRU4Rec.loadmodel(bare, device="cpu")
    assert m2._train_state is None
    capsys.readouterr()
    m2.fit(new, retrain=True)
    out = capsys.readouterr().out
    assert ("retrain: no optimizer state on the model — reinitializing accumulators"
            in out and "Extending item tables with 6 new items" in out)
    m3 = gru4rec_tpu_torch.GRU4Rec.loadmodel(full, device="cpu")
    assert m3._train_state.step == m._train_state.step
    m3.fit(new, retrain=True)
    for mm in (m2, m3):
        assert mm.n_items == N_ITEMS + 6 and torch.isfinite(mm.params["Wy"]).all()
        assert mm._train_state.opt_state["sparse"]["Wy"]["acc"].shape[0] == \
            mm.params["Wy"].shape[0]
    with pytest.raises(ValueError, match="previously trained"):
        gru4rec_tpu_torch.GRU4Rec(device="cpu").fit(new, retrain=True)
