"""The bfloat16 mixed-precision product of ``gru4rec_tpu_torch/ops/mixed_mm.py``
(``compute_dtype="bfloat16"``, every configuration's default) against the
JAX package's ``gru4rec_tpu/models/gru.py::_make_mm`` and its ``jax.grad``.

On the CPU, at the shapes of the GRU cell, the input projection and the
scores (the scores' operand a transposed, column-sliced view of a table):

* ``split_bf16x3`` is exact: three bfloat16 terms that sum to the float32
  value, magnitudes 1e-30 to 1e30;
* the plain version against JAX: the product within
  ``2·K·2^-24·(|a|·|b|)`` entrywise (both sum the same exact products in
  float32, in other orders: torch's and XLA's CPU products agree on about
  40% of the entries, not all), each operand's gradient within one bf16
  ulp beyond ``2·N·2^-24·(|g|·|other|)``, the bound of the float32 sum it
  rounds (an entry that cancels can round either way), and bit-equal on
  at least 99% of the entries (the share is printed);
* the card route's arithmetic rehearsed on the CPU: ``_MixedMM`` with its
  GEMM replaced by a float32 product of the widened bfloat16 operands (the
  split, the tripled depth and the rounding are the card's own code):
  the same bounds against JAX, the sum's bound taken at the tripled depth,
  and one launch counted per product;
* the training slice (a small constrained model, bfloat16 products) step
  by step from JAX's state, through the plain version and through the
  rehearsed route: loss within rtol 1e-4; parameters within atol 1e-5 +
  lr·2^-7, since a gradient entry that rounds to bfloat16 one ulp (at
  most 2^-7 of it) away from JAX's moves adagrad's step ``lr·g/sqrt(acc +
  g²)`` by at most lr·2^-7 (the plain version already does this, one
  ``Wy`` entry 8.3e-5 off in 60 sessions), and at least 97% of each
  table's entries within atol 1e-5 (a dense table's gradient sums many
  rounded products: ``Wrz``'s share falls to 98.8% on one step here);
* ``make_mm`` picks the product by ``compute_dtype``; a captured graph's
  tally goes back into the counters on each replay.

On the card (``cuda``-marked, skipped here; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_mixed_mm.py``):
``make_mm`` on CUDA tensors takes ``_MixedMM`` (its launches counted,
within the bounds of the plain version on the card), a failing
tensor-core product raises instead of taking the plain version, and a
captured forward and backward equals the eager one bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gru4rec_tpu_torch  # noqa: E402
from gru4rec_tpu_torch.models import gru  # noqa: E402
from gru4rec_tpu_torch.ops import mixed_mm  # noqa: E402
from gru4rec_tpu_torch.train import step as tstep  # noqa: E402
from gru4rec_tpu_torch.utils import cuda_graph  # noqa: E402

# JAX is imported by the CPU tests that use it: the card's machine has none

U = 2.0**-24  # float32 unit roundoff
BF16 = torch.bfloat16
# (M, K, N, table width): the GRU cell's two products, the input projection
# and the scores, whose right operand is Wy[:, :K].T of a (N, width) table
SHAPES = {"cell_rz": (16, 48, 96, None), "cell_h": (16, 48, 48, None),
          "projection": (16, 32, 144, None), "scores": (16, 48, 200, 128)}
MIN_BIT_EQUAL = 0.99


def operands(shape, seed=0):
    """Seeded numpy inputs at the model's scales: activations in (-1, 1),
    Glorot-scale weights, a cotangent of a sampled loss's size. Returns
    (a, table, g): the right operand is ``table`` itself, or ``table[:,
    :K].T`` when the shape names a table width."""
    M, K, N, width = shape
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (M, K)).astype(np.float32)
    table = (rng.randn(*((N, width) if width else (K, N))) * 0.1).astype(np.float32)
    g = (rng.randn(M, N) * 1e-3).astype(np.float32)
    return a, table, g


def right(table, shape):
    return table[:, :shape[1]].T if shape[3] else table


def jax_product(a, table, g, shape):
    """JAX's product, and its gradients for the cotangent ``g`` with
    respect to ``a`` and the right operand (numpy)."""
    import jax
    import jax.numpy as jnp

    import gru4rec_tpu
    from gru4rec_tpu.models.gru import _make_mm

    mm = _make_mm(gru4rec_tpu.GRU4RecConfig(compute_dtype="bfloat16"))
    out, vjp = jax.vjp(mm, jnp.asarray(a), jnp.asarray(right(table, shape)))
    ga, gb = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(ga), np.asarray(gb)


def torch_product(fn, a, table, g, shape):
    """``fn(a, b)`` on CPU tensors and its gradients for ``g`` (numpy),
    ``b`` the view of ``table`` that the model would pass."""
    ta = torch.tensor(a, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    out = fn(ta, right(tt, shape))
    out.backward(torch.from_numpy(g))
    return (out.detach().numpy(), ta.grad.numpy(),
            np.ascontiguousarray(right(tt.grad, shape).numpy()))


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16).double().numpy()


def bf16_ulp(x):
    """The bfloat16 ulp of each entry of ``|x|`` (0 where x is 0)."""
    m, e = np.frexp(np.abs(x).astype(np.float64))
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))


def assert_product_close(got, want, a, b, where):
    """Within ``2·K·2^-24·(|a16|·|b16|)`` entrywise: the float32 sums of the
    same exact products in two orders."""
    bound = 2 * a.shape[1] * U * (np.abs(bf16(a)) @ np.abs(bf16(b)))
    bad = np.abs(got.astype(np.float64) - want) > bound
    assert not bad.any(), f"{where}: {int(bad.sum())} entries past the bound"


def assert_grad_close(got, want, bound, where):
    """Within one bf16 ulp of the larger beyond ``bound``; returns the
    bit-equal share, which must be at least ``MIN_BIT_EQUAL``."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    tol = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + bound
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{where}: {int(bad.sum())} entries past one bf16 ulp"
    share = float((got == want).mean())
    print(f"{where}: bit-equal share {share:.6f} of {got.size}")
    assert share >= MIN_BIT_EQUAL, where
    return share


def grad_bounds(a, b, g, depth):
    """The float32 sum bounds of each operand's gradient, at ``depth`` times
    the product's own depth (3 on the tripled route) plus JAX's sum."""
    ga = (depth + 1) * b.shape[1] * U * (np.abs(g) @ np.abs(bf16(b)).T)
    gb = (depth + 1) * a.shape[0] * U * (np.abs(bf16(a)).T @ np.abs(g))
    return ga, gb


def rehearsed_tc_mm(a16, b16):
    """The card's GEMM on the CPU: bfloat16 operands, float32 sums."""
    assert a16.dtype == BF16 and b16.dtype == BF16
    return torch.mm(a16.float(), b16.float())


@pytest.fixture
def rehearsal(monkeypatch):
    """``_MixedMM`` runnable on CPU tensors, its launches counted from 0."""
    monkeypatch.setattr(mixed_mm, "_tc_mm", rehearsed_tc_mm)
    mixed_mm.reset_launches()
    yield
    mixed_mm.reset_launches()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_bf16x3_is_exact(seed):
    rng = np.random.RandomState(seed)
    mags = 10.0 ** rng.uniform(-30, 30, 20000)
    x = (mags * rng.choice([-1.0, 1.0], mags.size)).astype(np.float32)
    # values that bfloat16 holds, and float32 neighbours of one
    x[:4] = [1.0, -0.5, 3.0, 2.0 ** -100]
    x[4:6] = np.nextafter(np.float32(1.0), np.float32([2.0, 0.0]))
    g = torch.from_numpy(x)
    terms = mixed_mm.split_bf16x3(g)
    assert all(t.dtype == BF16 for t in terms)
    total = sum(t.double() for t in terms)
    np.testing.assert_array_equal(total.numpy(), x.astype(np.float64))
    # each term is the bfloat16 rounding of what the ones before leave
    g1, g2, g3 = (t.double() for t in terms)
    assert torch.equal(g1, g.to(BF16).double())
    assert torch.equal(g3[:4], torch.zeros(4, dtype=torch.float64))
    assert bool((g2.abs() <= g1.abs() * 2.0**-8).all())
    assert bool((g3.abs() <= g2.abs() * 2.0**-8).all())


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_version_matches_jax(name):
    shape = SHAPES[name]
    a, table, g = operands(shape)
    b = right(table, shape)
    out_j, ga_j, gb_j = jax_product(a, table, g, shape)
    out_t, ga_t, gb_t = torch_product(mixed_mm.mixed_mm, a, table, g, shape)
    assert_product_close(out_t, out_j, a, b, f"{name} product")
    bound_a, bound_b = grad_bounds(a, b, g, 1)
    assert_grad_close(ga_t, ga_j, bound_a, f"{name} grad a")
    assert_grad_close(gb_t, gb_j, bound_b, f"{name} grad b")


@pytest.mark.parametrize("name", list(SHAPES))
def test_card_route_rehearsed_matches_jax(name, rehearsal):
    shape = SHAPES[name]
    a, table, g = operands(shape, seed=1)
    b = right(table, shape)
    out_j, ga_j, gb_j = jax_product(a, table, g, shape)
    out_t, ga_t, gb_t = torch_product(mixed_mm._MixedMM.apply, a, table, g, shape)
    assert mixed_mm.launches_by_mode == {"forward": 1, "backward": 2}
    assert_product_close(out_t, out_j, a, b, f"{name} product")
    bound_a, bound_b = grad_bounds(a, b, g, 3)
    assert_grad_close(ga_t, ga_j, bound_a, f"{name} grad a")
    assert_grad_close(gb_t, gb_j, bound_b, f"{name} grad b")


def test_card_route_takes_bf16_weights_as_they_are(rehearsal):
    """A table cast to bfloat16 (``cast_for_serving``) enters the product
    as it is: the same scores as from its float32 master, and no gradient
    asked of it."""
    shape = SHAPES["scores"]
    a, table, _ = operands(shape, seed=2)
    ta = torch.from_numpy(a)
    t16 = torch.from_numpy(table).to(BF16)
    got = mixed_mm._MixedMM.apply(ta, right(t16, shape))
    want = mixed_mm._MixedMM.apply(ta, right(torch.from_numpy(table), shape))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    out_j, _, _ = jax_product(a, table, np.zeros_like(got.numpy()), shape)
    assert_product_close(got.numpy(), out_j, a, right(table, shape), "bf16 table")


def test_card_route_gradient_of_one_operand(rehearsal):
    """Only the operands that need a gradient get a GEMM."""
    a, table, g = operands(SHAPES["cell_h"], seed=3)
    ta = torch.tensor(a, requires_grad=True)
    out = mixed_mm._MixedMM.apply(ta, torch.from_numpy(table))
    out.backward(torch.from_numpy(g))
    assert mixed_mm.launches_by_mode == {"forward": 1, "backward": 1}
    assert ta.grad.dtype == torch.float32
    assert torch.equal(ta.grad, ta.grad.to(BF16).float())  # rounded as JAX's


def test_make_mm_picks_the_product():
    a = torch.randn(4, 8)
    b = torch.randn(8, 5)
    cfg = gru4rec_tpu_torch.GRU4RecConfig
    assert gru.make_mm(cfg(compute_dtype="bfloat16")) is mixed_mm.mixed_mm
    mm32 = gru.make_mm(cfg(compute_dtype="float32"))
    assert torch.equal(mm32(a, b), a @ b)
    mixed_mm.reset_launches()
    assert torch.equal(mixed_mm.mixed_mm(a, b), mixed_mm.mixed_mm_plain(a, b))
    assert set(mixed_mm.launches_by_mode.values()) == {0}  # CPU: the plain version


def test_counted_graph_replay_adds_its_tally():
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)

    mixed_mm.reset_launches()
    counted = cuda_graph.CountedGraph(Graph(), {"mixed_mm": {"forward": 4, "backward": 8}})
    counted.replay()
    counted.replay()
    assert replays == [1, 1]
    assert mixed_mm.launches_by_mode == {"forward": 8, "backward": 16}
    mixed_mm.reset_launches()


def assert_slice_params_close(tparams, jparams, lr):
    """Within atol 1e-5 + lr·2^-7, and at least 97% of the entries of
    every table within 1e-5 (module doc)."""
    import jax

    jp = jax.tree_util.tree_map(np.asarray, jparams)
    pairs = [("Wy", tparams["Wy"], jp["Wy"])] + [
        (f"{k}[{i}]", t, j) for k in ("Wx", "Wh", "Wrz", "Bh")
        for i, (t, j) in enumerate(zip(tparams[k], jp[k]))]
    for name, t, j in pairs:
        diff = np.abs(t.numpy().astype(np.float64) - j)
        assert diff.max() <= 1e-5 + lr * 2.0**-7, (name, diff.max())
        assert (diff <= 1e-5).mean() >= 0.97, (name, (diff > 1e-5).sum())


def _slice_setup():
    """Both packages' one-step chunk functions with bfloat16 products, from
    the same initial weights, on ``tests/test_torch_slice.py``'s markov
    schedule and JAX's negative draws."""
    from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap
    from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order
    from gru4rec_tpu_torch.data.tools import compute_offset
    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.ops.sampling import build_alias_table

    import gru4rec_tpu
    import jax
    from gru4rec_tpu.train import step as jstep
    import test_torch_slice as slice_test

    kw = slice_test.cfg_kwargs("float32", compute_dtype="bfloat16")
    cfg_j, cfg_t = gru4rec_tpu.GRU4RecConfig(**kw), gru4rec_tpu_torch.GRU4RecConfig(**kw)
    n_items = slice_test.N_ITEMS
    data = slice_test.markov(60)
    itemidmap = build_itemidmap(data, "ItemId")
    data = apply_itemidmap(data, itemidmap, "ItemId")
    offsets = compute_offset(data, "SessionId")
    order = session_order(data, "SessionId", "Time", True, len(offsets) - 1)
    sched = build_schedule(data["ItemIdx"].values.astype(np.int32), offsets, order, 8)
    pop = data.groupby("ItemId").size().reindex(itemidmap.index.values).values
    packed = build_alias_table(pop, 0.4)
    logp0 = np.zeros(pad_items(n_items, cfg_t.item_pad_multiple), np.float32)
    jstate = jstep.init_train_state(cfg_j, n_items, jax.random.PRNGKey(cfg_j.seed))
    return (cfg_j, cfg_t, sched, packed, logp0, jstate,
            slice_test.jax_negatives(cfg_j.seed, packed, cfg_t.n_sample))


@pytest.mark.parametrize("route", ["plain", "card_rehearsed"])
def test_training_slice_steps_match_jax(route, monkeypatch):
    """Every step from JAX's state (``io/convert.py``), the port fed JAX's
    negatives: loss within rtol 1e-4, every parameter as the module doc
    says.
    ``card_rehearsed`` sends every product of the step through
    ``_MixedMM`` with the rehearsed GEMM."""
    import jax.numpy as jnp
    from gru4rec_tpu.train import step as jstep
    import test_torch_slice as slice_test

    if route == "card_rehearsed":
        monkeypatch.setattr(mixed_mm, "_tc_mm", rehearsed_tc_mm)
        monkeypatch.setattr(gru, "mixed_mm", mixed_mm._MixedMM.apply)
    cfg_j, cfg_t, sched, packed, logp0, jstate, draw = _slice_setup()
    jchunk = jstep.make_chunk_fn(cfg_j, slice_test.N_ITEMS)
    tchunk = tstep.make_chunk_fn(cfg_t, slice_test.N_ITEMS)
    tstate = tstep.TrainState(None, None, None, tstep.make_generator(cfg_t.seed, "cpu"))
    samp_j, lp_j = jnp.asarray(packed), jnp.asarray(logp0)
    samp_t, lp_t = torch.from_numpy(packed), torch.from_numpy(logp0)
    mixed_mm.reset_launches()
    for t in range(sched.n_steps):
        slice_test.sync_from_jax(tstate, jstate)
        sl = [x[t:t + 1] for x in (sched.in_idx, sched.out_idx, sched.valid, sched.reset)]
        neg = draw(int(jstate.step))
        jstate, ls_j, _ = jchunk(jstate, *map(jnp.asarray, sl), samp_j, lp_j)
        ls_t, _ = tchunk(tstate, *sl, samp_t, lp_t, neg=torch.from_numpy(neg))
        np.testing.assert_allclose(float(ls_t), float(ls_j), rtol=1e-4)
        assert_slice_params_close(tstate.params, jstate.params, cfg_t.learning_rate)
    # constrained GRU-32: the projection, the cell's two products and the
    # scores each step, and a gradient of every operand but the incoming
    # hidden state (H · Wrz: no gradient flows into H, as in JAX)
    live = int(sched.valid.any(axis=1).sum())
    want = {"forward": 4 * live, "backward": 7 * live} if route == "card_rehearsed" \
        else {"forward": 0, "backward": 0}
    assert mixed_mm.launches_by_mode == want
    mixed_mm.reset_launches()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gru4rec_tpu_torch.models.gru4rec import resolve_device

    return resolve_device("cuda")


def _card_operands(name, dev, seed=0):
    shape = SHAPES[name]
    a, table, g = operands(shape, seed)
    ta = torch.tensor(a, device=dev, requires_grad=True)
    tt = torch.tensor(table, device=dev, requires_grad=True)
    return ta, tt, torch.from_numpy(g).to(dev), shape


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_make_mm_takes_the_tensor_cores(name, card):
    ta, tt, g, shape = _card_operands(name, card)
    mm = gru.make_mm(gru4rec_tpu_torch.GRU4RecConfig(compute_dtype="bfloat16"))
    mixed_mm.reset_launches()
    out = mm(ta, right(tt, shape))
    assert type(out.grad_fn).__name__ == "_MixedMMBackward"
    out.backward(g)
    torch.cuda.synchronize()
    assert mixed_mm.launches_by_mode == {"forward": 1, "backward": 2}
    pa = ta.detach().clone().requires_grad_(True)
    pt = tt.detach().clone().requires_grad_(True)
    plain = mixed_mm.mixed_mm_plain(pa, right(pt, shape))
    plain.backward(g)
    a, b = ta.detach().cpu().numpy(), right(tt.detach(), shape).cpu().numpy()
    assert_product_close(out.detach().cpu().numpy(), plain.detach().cpu().numpy(), a, b,
                         f"{name} product")
    bound_a, bound_b = grad_bounds(a, b, g.cpu().numpy(), 3)
    assert_grad_close(ta.grad.cpu().numpy(), pa.grad.cpu().numpy(), bound_a,
                      f"{name} grad a")
    assert_grad_close(right(tt.grad, shape).cpu().numpy(),
                      right(pt.grad, shape).cpu().numpy(), bound_b, f"{name} grad b")
    mixed_mm.reset_launches()


@pytest.mark.cuda
def test_cuda_failing_product_raises(card, monkeypatch):
    """No fallback: a tensor-core product that fails raises, and the plain
    version is never called for CUDA tensors."""
    def broken(a16, b16):
        raise RuntimeError("tensor-core product unavailable")

    def plain(a, b):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(mixed_mm, "_tc_mm", broken)
    monkeypatch.setattr(mixed_mm, "mixed_mm_plain", plain)
    ta, tt, _, shape = _card_operands("scores", card)
    with pytest.raises(RuntimeError, match="tensor-core product unavailable"):
        mixed_mm.mixed_mm(ta, right(tt, shape))


@pytest.mark.cuda
def test_cuda_captured_product_matches_eager(card):
    """The product and both gradients captured in a CUDA graph equal the
    eager call bit for bit; the capture's launches come back per replay."""
    ta, tt, g, shape = _card_operands("scores", card, seed=4)

    def call():
        out = mixed_mm.mixed_mm(ta, right(tt, shape))
        return (out, *torch.autograd.grad(out, (ta, tt), g))

    stream = cuda_graph.capture_stream(card)
    eager = [cuda_graph.run_on(stream, call) for _ in range(cuda_graph.WARMUP_STEPS)][-1]
    mixed_mm.reset_launches()
    graph, _, captured = cuda_graph.capture(call, stream)
    assert graph.tally == {"mixed_mm": {"forward": 1, "backward": 2}}
    assert mixed_mm.launches_by_mode == {"forward": 0, "backward": 0}
    graph.replay()
    torch.cuda.synchronize()
    assert mixed_mm.launches_by_mode == {"forward": 1, "backward": 2}
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)
    mixed_mm.reset_launches()
