"""The port's model-side modules against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX function and
its PyTorch counterpart: the initial weights (bit-equal), ``forward`` in the
three input modes with one and two layers (compute_dtype float32; rtol 1e-5
/ atol 1e-6, the matmuls sum in another order), the six losses and their
gradients (rtol 1e-5 / atol 1e-6), the activation grammar, ranks in the four
tie modes (exact), the alias table and CDF (byte-equal), the negative draws
(by distribution: the two packages' generators differ), the schedule
schedule (identical arrays) and the config grammar.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gru4rec_tpu.config import GRU4RecConfig as JaxConfig  # noqa: E402
from gru4rec_tpu.data.scheduler import _build_schedule_numpy  # noqa: E402
from gru4rec_tpu.models import gru as jgru  # noqa: E402
from gru4rec_tpu.ops import activations as jact  # noqa: E402
from gru4rec_tpu.ops import losses as jlosses  # noqa: E402
from gru4rec_tpu.ops import ranking as jranking  # noqa: E402
from gru4rec_tpu.ops import sampling as jsampling  # noqa: E402
from gru4rec_tpu_torch.config import GRU4RecConfig  # noqa: E402
from gru4rec_tpu_torch.data.scheduler import build_schedule  # noqa: E402
from gru4rec_tpu_torch.io.convert import params_from_jax  # noqa: E402
from gru4rec_tpu_torch.models import gru  # noqa: E402
from gru4rec_tpu_torch.ops import activations, losses, ranking, sampling  # noqa: E402

MODES = {"onehot": {}, "embedding": {"embedding": 24},
         "constrained": {"constrained_embedding": True}}
LOSSES = ["cross-entropy", "xe_logit", "bpr", "bpr-max", "top1", "top1-max"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("init_as_normal", [False, True])
def test_init_params_bit_equal(mode, init_as_normal):
    kw = dict(layers=[16, 8], item_pad_multiple=8, init_as_normal=init_as_normal,
              **MODES[mode])
    want = _np_tree(jgru.init_params(JaxConfig(**kw), 37))
    got = gru.init_params(GRU4RecConfig(**kw), 37, "cpu")
    assert set(got) == set(want)
    for k in want:
        w = want[k] if isinstance(want[k], list) else [want[k]]
        g = got[k] if isinstance(got[k], list) else [got[k]]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b)


def _gathered(params, cfg, X, Yfull, lib):
    Wy = np.asarray(params["Wy"])
    if cfg.constrained_embedding:
        rows = {"WyS": Wy[np.concatenate([X, Yfull])]}
    elif cfg.embedding:
        rows = {"E": np.asarray(params["E"])[X], "Wy": Wy[Yfull]}
    else:
        rows = {"Wx0": np.asarray(params["Wx"][0])[X], "Wy": Wy[Yfull]}
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {k: conv(v) for k, v in rows.items()}


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_jax(mode, n_layers):
    n_items, B, n_neg = 40, 6, 10
    kw = dict(layers=[16] * n_layers, batch_size=B, n_sample=n_neg,
              final_act="elu-1", item_pad_multiple=8, compute_dtype="float32",
              **MODES[mode])
    jcfg, cfg = JaxConfig(**kw), GRU4RecConfig(**kw)
    params = _np_tree(jgru.init_params(jcfg, n_items))
    tparams = params_from_jax(params, device="cpu")
    rng = np.random.RandomState(0)
    X = rng.randint(0, n_items, B)
    Yfull = np.concatenate([rng.randint(0, n_items, B), rng.randint(0, n_items, n_neg)])
    H = [(rng.randn(B, 16) * 0.1).astype(np.float32) for _ in range(n_layers)]
    logq = (rng.rand(B + n_neg) * 0.5).astype(np.float32)
    col_valid = np.ones(B + n_neg, bool)
    col_valid[2] = False

    for training, lq in ((False, None), (True, logq)):
        jH, jy = jgru.forward(
            params, _gathered(params, jcfg, X, Yfull, "jax"),
            [jnp.asarray(h) for h in H], jcfg, M=B, training=training,
            col_valid=jnp.asarray(col_valid),
            logq_correction=None if lq is None else jnp.asarray(lq))
        tH, ty = gru.forward(
            tparams, _gathered(params, cfg, X, Yfull, "torch"),
            [torch.from_numpy(h) for h in H], cfg, M=B, training=training,
            col_valid=torch.from_numpy(col_valid),
            logq_correction=None if lq is None else torch.from_numpy(lq))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for a, b in zip(tH, jH):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    # full-catalog scoring (the evaluation path), padded rows masked
    n_pad = params["Wy"].shape[0]
    item_valid = np.arange(n_pad) < n_items
    src = {"constrained": "WyS", "embedding": "E", "onehot": "Wx0"}[mode]
    jrows = {src: _gathered(params, jcfg, X, Yfull, "jax")[src][:B]}
    trows = {src: _gathered(params, cfg, X, Yfull, "torch")[src][:B]}
    _, jy = jgru.forward(params, jrows, [jnp.asarray(h) for h in H], jcfg, M=B,
                         training=False, full_catalog=True,
                         item_valid=jnp.asarray(item_valid))
    _, ty = gru.forward(tparams, trows, [torch.from_numpy(h) for h in H], cfg, M=B,
                        training=False, full_catalog=True,
                        item_valid=torch.from_numpy(item_valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_bfloat16_compute_rounds_operands_like_jax():
    kw = dict(layers=[16], batch_size=4, n_sample=6, item_pad_multiple=8,
              constrained_embedding=True, compute_dtype="bfloat16")
    jcfg, cfg = JaxConfig(**kw), GRU4RecConfig(**kw)
    params = _np_tree(jgru.init_params(jcfg, 20))
    rng = np.random.RandomState(3)
    X, Yfull = rng.randint(0, 20, 4), rng.randint(0, 20, 10)
    H = [(rng.randn(4, 16) * 0.1).astype(np.float32)]
    _, jy = jgru.forward(params, _gathered(params, jcfg, X, Yfull, "jax"),
                         [jnp.asarray(H[0])], jcfg, M=4, training=False)
    _, ty = gru.forward(params_from_jax(params, device="cpu"),
                        _gathered(params, cfg, X, Yfull, "torch"),
                        [torch.from_numpy(H[0])], cfg, M=4, training=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(name, smoothing):
    rng = np.random.RandomState(LOSSES.index(name))
    B, n_neg = 5, 7
    if name == "cross-entropy":  # takes log of the scores: feed probabilities
        yhat = rng.dirichlet(np.ones(B + n_neg), size=B).astype(np.float32)
    else:
        yhat = rng.randn(B, B + n_neg).astype(np.float32)
    row_valid = np.array([True, True, False, True, True])
    col_valid = np.concatenate([row_valid, np.ones(n_neg, bool)])
    M = float(row_valid.sum())
    jfn = jlosses.get_loss(name, n_neg, smoothing, bpreg=1.3)
    tfn = losses.get_loss(name, n_neg, smoothing, bpreg=1.3)
    jval, jgrad = jax.value_and_grad(
        lambda y: jfn(y, jnp.float32(M), jnp.asarray(row_valid), jnp.asarray(col_valid))
    )(jnp.asarray(yhat))
    y_t = torch.from_numpy(yhat).requires_grad_(True)
    tval = tfn(y_t, M, torch.from_numpy(row_valid), torch.from_numpy(col_valid))
    (tgrad,) = torch.autograd.grad(tval, y_t)
    np.testing.assert_allclose(float(tval.detach()), float(jval), **TOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("name", ["linear", "tanh", "relu", "sigmoid", "softmax",
                                  "softmax_logit", "leaky-0.1", "elu-0.5",
                                  "selu-1.05-1.67"])
def test_activations_match_jax(name):
    x = np.random.RandomState(0).randn(4, 9).astype(np.float32) * 2
    cv = np.ones(9, bool)
    cv[3] = False
    args_j = (jnp.asarray(x), jnp.asarray(cv)) if "softmax" in name else (jnp.asarray(x),)
    args_t = ((torch.from_numpy(x), torch.from_numpy(cv)) if "softmax" in name
              else (torch.from_numpy(x),))
    np.testing.assert_allclose(activations.get_activation(name)(*args_t).numpy(),
                               np.asarray(jact.get_activation(name)(*args_j)), **TOL)
    assert activations.rank_invariant(name) == jact.rank_invariant(name)
    yn = np.random.RandomState(1).randn(4, 9).astype(np.float32)
    np.testing.assert_allclose(
        activations.softmax_neg(torch.from_numpy(yn), torch.from_numpy(cv)).numpy(),
        np.asarray(jact.softmax_neg(jnp.asarray(yn), jnp.asarray(cv))), **TOL)


@pytest.mark.parametrize("mode", ranking.TIE_MODES)
def test_compute_ranks_match_jax(mode):
    rng = np.random.RandomState(1)
    others = rng.randint(0, 5, (6, 11)).astype(np.float32)  # many ties
    target = others[np.arange(6), rng.randint(0, 11, 6)]
    got = ranking.compute_ranks(torch.from_numpy(others), torch.from_numpy(target), mode)
    want = jranking.compute_ranks(jnp.asarray(others), jnp.asarray(target), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alpha", [0.4, 0.75, 1.0])
def test_sampler_tables_byte_equal(alpha):
    pop = np.random.RandomState(2).randint(1, 500, 257)
    np.testing.assert_array_equal(
        sampling.build_alias_table(pop, alpha),
        np.asarray(jsampling.build_alias_table(pop, alpha).packed))
    got, want = sampling.popularity_cdf(pop, alpha), jsampling.popularity_cdf(pop, alpha)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("sampler,alpha", [("alias", 0.75), ("searchsorted", 0.5),
                                           ("alias", 0.0)])
def test_negative_draws_match_target_distribution(sampler, alpha):
    rng = np.random.RandomState(1)
    n_items = 50
    pop = rng.randint(1, 200, n_items)
    p_target = pop.astype(np.float64) ** alpha
    p_target /= p_target.sum()
    samp1 = torch.from_numpy(sampling.build_alias_table(pop, alpha) if sampler == "alias"
                             else sampling.popularity_cdf(pop, alpha))
    gen = torch.Generator().manual_seed(0)
    draws = sampling.draw_negatives(gen, samp1, 200, 1000, n_items, alpha, sampler)
    assert draws.shape == (200, 1000) and draws.dtype == torch.int32
    emp = np.bincount(draws.numpy().ravel(), minlength=n_items) / draws.numel()
    np.testing.assert_allclose(emp, p_target, atol=0.004)


def _sessions(seed):
    rng = np.random.RandomState(seed)
    n_sessions = rng.randint(5, 60)
    lens = rng.randint(1, 10, size=n_sessions)
    offsets = np.zeros(n_sessions + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)
    items = rng.randint(0, 1000, size=int(offsets[-1])).astype(np.int32)
    return items, offsets, rng.permutation(n_sessions)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("batch_size", [1, 3, 8, 32])
@pytest.mark.parametrize("require_two_lanes", [False, True])
def test_schedule_identical(seed, batch_size, require_two_lanes):
    items, offsets, order = _sessions(seed)
    want = _build_schedule_numpy(items, offsets, order, batch_size, require_two_lanes)
    got = build_schedule(items, offsets, order, batch_size, require_two_lanes)
    for f in ("in_idx", "out_idx", "valid", "reset"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_config_grammar_round_trips():
    s = ("loss=bpr-max,final_act=elu-0.5,layers=224/112,batch_size=80,"
         "n_sample=2048,sample_alpha=0.4,constrained_embedding=True,"
         "adapt=adam,adapt_params=0.8/0.99,momentum=0.4,embedding=layersize,"
         "chunk_size=64,dedup_impl=sort,opt_state_dtype=float32")
    got = GRU4RecConfig.from_parameter_string(s).to_dict()
    assert got == JaxConfig.from_parameter_string(s).to_dict()
    assert GRU4RecConfig.from_dict(got).to_dict() == got


def test_convert_runs_on_the_card_unless_asked_for_the_cpu():
    """``io/convert``'s ``device=None`` is the card; where there is none it
    raises instead of falling back to the CPU."""
    a = {"Wy": np.ones((2, 3), np.float32)}
    if torch.cuda.is_available():
        assert params_from_jax(a)["Wy"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(a)
    assert params_from_jax(a, device="cpu")["Wy"].device.type == "cpu"

