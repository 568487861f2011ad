"""Full-catalog ranking after the scores GEMM:
``gru4rec_tpu_torch/ops/kernels/score_rank.py`` (the wrapper of
``csrc/score_rank.cu`` and its plain version) and its route in
``eval/evaluation.py::make_eval_step``.

On the CPU:

* the plain version equals the op sequence the evaluation step ran before
  it (``masked_softmax`` of the biased scores, the ``-inf`` mask of the
  padding columns, the target's gather, ``compute_ranks``' comparisons and
  sums) bit for bit, in every tie mode the kernel takes, with padding
  columns, planted ties and invalid lanes (target column 0);
* the step's route through it (taken on the card; here with
  ``evaluation._on_card`` patched and the wrapper ``score_rank_cuda``
  replaced by its plain version) gives the lanes and counters of
  ``gru.forward``'s full-catalog path bit for bit;
* that route turns its counts into ranks through
  ``evaluation.ranks_from_counts`` and the CPU's full-catalog step through
  ``evaluation.compute_ranks``, so a fault planted in the one reaches its
  route alone;
* ``make_eval_step`` calls the wrapper only on the card, for full-catalog
  ranking under a softmax final activation in the ``standard``,
  ``conservative`` or ``median`` tie mode; the CPU, the subset,
  ``tiebreaking``, elementwise final activations and the mesh step never
  reach it;
* on that route with bfloat16 products, the evaluation runner
  (``_EvalGraph``) hands the scores product its bfloat16 copy of the
  table, laid out as the product's own cast, rounded once per call
  whatever the steps (``table_casts``, the span
  ``gru4rec.evaluate.cast``) and again at each call of a kept runner
  after an in-place change of ``Wy``; a bfloat16 table, float32 products,
  the subset, ``tiebreaking``, an elementwise activation and the CPU make
  no copy;
* the wrapper's card path raises on logits, bias or targets it does not
  take (dtype, shape, contiguity, device, tie mode), with a stub for the
  launch, and counts a call it does take.

On the card (``cuda``-marked, skipped here; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_score_rank.py``):
the kernel's counts against the plain version's on the card at (8, 1,000),
(240, 37,120) and (512, 200,064), several seeds, every tie mode, padding
columns and invalid lanes: each lane's difference at most the number of
other columns whose plain activated value lies within one ulp of the
target's (the kernel sums the softmax in another order), so exact where
there are none; exactly equal on planted
exact ties; the same bound on lanes that the kernel recounts exactly (a
subnormal or zero target probability, a NaN or infinite score); one call
per step of a captured ``evaluate``, graph against eager bit for bit;
on the fused route at standard ties, the table rounded once per call in
both, a kept graph after an in-place change of ``Wy`` against a
standalone call, and one cast of the table in a traced call.
This file imports no JAX.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gru4rec_tpu_torch.config import GRU4RecConfig  # noqa: E402
from gru4rec_tpu_torch.eval import evaluation as teval  # noqa: E402
from gru4rec_tpu_torch.models import gru  # noqa: E402
from gru4rec_tpu_torch.ops.activations import masked_softmax  # noqa: E402
from gru4rec_tpu_torch.ops.kernels import score_rank as sr  # noqa: E402
from gru4rec_tpu_torch.ops.ranking import compute_ranks, ranks_from_counts  # noqa: E402
from gru4rec_tpu_torch.train.step import StackLayout  # noqa: E402

MODES = sr.MODES
# every elementwise final activation of ops/activations.py, which the
# kernel's elementwise mode takes
ELEMENTWISE = ["elu-0.5", "elu-1", "linear", "relu", "leaky-0.1", "selu-1.0507-1.6733",
               "tanh", "sigmoid"]
SATURATING = ("elu", "selu", "relu", "tanh", "sigmoid")  # flat below some logit
SATURATED = range(4, 10)  # logits_case's columns far below zero


def logits_case(B, N, n_items, seed, device="cpu", ties=True, width=48, saturate=False):
    """Logits (B, N), the bias column of a (N, width) float32 table (a
    strided view), int32 targets with every third lane invalid (column 0)
    and, with ``ties``, columns 1-3 copies of column 0 (logits and bias)
    and each lane's target copied into two columns of its own at the top of
    the catalog. With ``saturate`` too, the columns ``SATURATED`` hold
    distinct logits from -120 down, where elu, selu, relu, tanh and sigmoid
    saturate, and the lanes ``1::3`` target one of them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N) * 3.0).astype(np.float32)
    table = np.zeros((N, width), np.float32)
    b = width // 2
    table[:n_items, b] = rng.randn(n_items).astype(np.float32) * 0.5
    tgt = rng.randint(0, n_items - 2 * B, size=B).astype(np.int32)
    tgt[::3] = 0
    if ties and saturate:
        for k, c in enumerate(SATURATED):
            x[:, c] = -120.0 - 10.0 * k
            table[c, b] = 0.0
        tgt[1::3] = SATURATED[2]
    if ties:
        x[:, 1:4] = x[:, :1]
        table[1:4, b] = table[0, b]
        for r in range(B):
            for c in (n_items - 1 - 2 * r, n_items - 2 - 2 * r):
                x[r, c] = x[r, tgt[r]]
                table[c, b] = table[tgt[r], b]
    t = torch.from_numpy(table).to(device)
    return (torch.from_numpy(x).to(device), t[:, width // 2],
            torch.from_numpy(tgt).to(device))


def todays_counts(x, bias, n_items, tgt, mode, final_act="softmax"):
    """The evaluation step's op sequence before the kernel existed: for an
    elementwise activation, the eager route's (``gru.activate``, then the
    step's own mask)."""
    item_valid = torch.arange(x.shape[1]) < n_items
    if final_act == "softmax":
        yhat = masked_softmax(x + bias, item_valid)
    else:
        cfg = types.SimpleNamespace(final_act=final_act)
        yhat = gru.activate(x + bias, cfg, training=False, valid=item_valid,
                            full_catalog=True)
    yhat = torch.where(item_valid, yhat, -torch.inf)
    target = yhat[torch.arange(x.shape[0]), tgt]
    t = target[:, None]
    gt = torch.sum(yhat > t, dim=1)
    second = None
    if mode == "conservative":
        second = torch.sum(yhat >= t, dim=1)
    elif mode == "median":
        second = torch.sum(yhat == t, dim=1)
    return gt, second, compute_ranks(yhat, target, mode)


@pytest.mark.parametrize("final_act", ["softmax", *ELEMENTWISE])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_the_eager_sequence(mode, seed, final_act):
    B, N, n_items = 12, 301, 290
    x, bias, tgt = logits_case(B, N, n_items, seed, saturate=True)
    gt, second = sr.score_rank_plain(x, bias, n_items, tgt, mode, final_act)
    want_gt, want_second, want_ranks = todays_counts(x, bias, n_items, tgt, mode, final_act)
    assert torch.equal(gt, want_gt)
    assert (second is None) == (want_second is None)
    if second is not None:
        assert torch.equal(second, want_second)
    assert torch.equal(ranks_from_counts(gt, second, mode), want_ranks)
    # the ties are there: a lane's target equals several columns
    eq = sr.score_rank_plain(x, bias, n_items, tgt, "median", final_act)[1]
    assert int(eq.min()) >= 3 and int(eq[::3].min()) >= 4
    if final_act.split("-")[0] in SATURATING:
        # the saturated columns tie with the lanes that target one of them
        assert int(eq[1::3].min()) >= len(SATURATED) + 2
        if final_act.startswith("elu-"):
            t = gru.activate(x + bias, types.SimpleNamespace(final_act=final_act),
                             training=False)[1, SATURATED[2]]
            assert float(t) == -float(final_act[4:])


@pytest.mark.parametrize("act, want", [
    ("elu-1", (3, 1.0, 0.0)), ("elu-0.5", (3, 0.5, 0.0)), ("linear", (0, 0.0, 0.0)),
    ("relu", (1, 0.0, 0.0)), ("leaky-0.1", (2, 0.1, 0.0)), ("tanh", (5, 0.0, 0.0)),
    ("sigmoid", (6, 0.0, 0.0)), ("selu-1.0507-1.6733", (4, 1.0507, 1.6733)),
    ("softmax", None), ("softmax_logit", None), ("elu", None), ("elu-x", None),
    ("tanh-1", None), ("selu-1", None), ("swish", None)])
def test_elementwise_codes(act, want):
    """The kernel's activation code and parameters, parsed from the
    activation's name as ``get_activation`` parses it; None where the
    elementwise mode does not take it (the softmax family takes the other
    mode)."""
    assert sr.elementwise_code(act) == want
    assert sr.takes(act) == (want is not None or act in sr.SOFTMAX)


def step_cfg(**kw):
    args = dict(loss="cross-entropy", final_act="softmax", layers=[16], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                item_pad_multiple=8, seed=3, constrained_embedding=True)
    args.update(kw)
    return GRU4RecConfig(**args)


def step_inputs(cfg, n_items, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = gru.init_params(cfg, n_items, "cpu")
    params["Wy"][:n_items, cfg.layers[-1]] = torch.randn(n_items, generator=gen) * 0.3
    b = cfg.batch_size
    in_idx = torch.randint(0, n_items, (b,), generator=gen, dtype=torch.int32)
    out_idx = torch.randint(0, n_items, (b,), generator=gen, dtype=torch.int32)
    valid = torch.arange(b) % 4 != 3
    reset = torch.arange(b) % 3 == 0
    H = [torch.randn(b, h, generator=gen) for h in cfg.layers]
    return params, H, in_idx, out_idx, valid, reset


def forward_path_step(cfg, n_items, cutoffs, mode):
    """The full-catalog step as it ran before the route: ``gru.forward``'s
    activated scores, the mask and ``compute_ranks``."""

    def step(params, H, in_idx, out_idx, valid, reset, rec, mrr, gen):
        Wy = params["Wy"]
        H_in = [torch.where(reset[:, None], 0.0, h) for h in H]
        srows = gru.input_rows(params, torch.where(valid, in_idx, 0), "constrained")
        item_valid = torch.arange(Wy.shape[0]) < n_items
        H_new, yhat = gru.forward(params, srows, H_in, cfg, M=in_idx.shape[0], training=False,
                                  full_catalog=True, item_valid=item_valid)
        yhat = torch.where(item_valid, yhat, -torch.inf)
        target = yhat[torch.arange(in_idx.shape[0]), torch.where(valid, out_idx, 0)]
        ranks = compute_ranks(yhat, target, mode) + 0.0
        vf = valid.float()
        for k, c in enumerate(cutoffs):
            hit = (ranks <= c).float() * vf
            rec[k] += torch.sum(hit)
            mrr[k] += torch.sum(hit / ranks)
        for h, hn, ho in zip(H, H_new, H_in):
            h.copy_(torch.where(valid[:, None], hn, ho))

    return step


@pytest.mark.parametrize("final_act", ["softmax", "softmax_logit", "elu-0.5", "elu-1", "tanh",
                                       "linear", "relu", "sigmoid"])
@pytest.mark.parametrize("mode", MODES)
def test_routed_step_matches_the_forward_path(mode, final_act, monkeypatch):
    calls = []
    monkeypatch.setattr(teval, "_on_card", lambda t: True)
    monkeypatch.setattr(sr, "score_rank_cuda",
                        lambda *a: calls.append(a[4:]) or sr.score_rank_plain(*a))
    cfg = step_cfg(final_act=final_act, compute_dtype="bfloat16")
    n_items, cutoffs = 50, (1, 5, 20)
    params, H, in_idx, out_idx, valid, reset = step_inputs(cfg, n_items)
    outs = []
    for step in (teval.make_eval_step(cfg, n_items, cutoffs, mode),
                 forward_path_step(cfg, n_items, cutoffs, mode)):
        Hs = [h.clone() for h in H]
        rec, mrr = torch.zeros(3), torch.zeros(3)
        for _ in range(3):  # the lanes carry over
            step(params, Hs, in_idx, out_idx, valid, reset, rec, mrr, None)
        outs.append((Hs, rec, mrr))
    (H1, rec1, mrr1), (H2, rec2, mrr2) = outs
    assert torch.equal(rec1, rec2) and torch.equal(mrr1, mrr2)
    assert all(torch.equal(a, b) for a, b in zip(H1, H2))
    assert float(rec1[-1]) > 0 and calls == [(mode, final_act)] * 3


class FakeMesh:
    """One rank's mesh (``parallel/mesh.py::Mesh``'s surface that the
    mesh step reads): its collectives return their input."""
    shape = {"data": 1, "model": 1}
    mi = 0

    @staticmethod
    def lanes(batch):
        return 0, batch

    @staticmethod
    def all_reduce(t, axis, op=None):
        return t


ROUTES = {  # name: (final_act, tie mode, subset, mesh, on the card, reaches the wrapper)
    "softmax standard": ("softmax", "standard", False, False, True, True),
    "softmax conservative": ("softmax", "conservative", False, False, True, True),
    "softmax_logit median": ("softmax_logit", "median", False, False, True, True),
    "cpu": ("softmax", "standard", False, False, False, False),
    "subset": ("softmax", "standard", True, False, True, False),
    "tiebreaking": ("softmax", "tiebreaking", False, False, True, False),
    "elu": ("elu-0.5", "standard", False, False, True, True),
    "tanh": ("tanh", "median", False, False, True, True),
    "linear": ("linear", "conservative", False, False, True, True),
    "elu tiebreaking": ("elu-1", "tiebreaking", False, False, True, False),
    "elu cpu": ("elu-1", "standard", False, False, False, False),
    "elu subset": ("elu-1", "median", True, False, True, False),
    "mesh": ("softmax", "standard", False, True, True, False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_make_eval_step_routes(route, monkeypatch):
    final_act, mode, subset, mesh, card, engaged = ROUTES[route]
    calls = []

    def patched(*args):
        calls.append(args[4])
        return sr.score_rank_plain(*args)

    monkeypatch.setattr(sr, "score_rank_cuda", patched)
    monkeypatch.setattr(teval, "_on_card", lambda t: card)
    cfg = step_cfg(final_act=final_act)
    n_items = 40
    params, H, in_idx, out_idx, valid, reset = step_inputs(cfg, n_items, seed=1)
    item_idx = torch.arange(0, n_items, 4, dtype=torch.int32) if subset else None
    if mesh:
        step = teval.make_dist_eval_step(cfg, n_items, (5,), mode, FakeMesh(), cfg.batch_size,
                                         subset)
    else:
        step = teval.make_eval_step(cfg, n_items, (5,), mode, subset)
    rec, mrr = torch.zeros(1), torch.zeros(1)
    gen = torch.Generator().manual_seed(0)
    step(params, H, in_idx, out_idx, valid, reset, rec, mrr, gen, item_idx)
    assert calls == ([mode] if engaged else [])


@pytest.mark.parametrize("seam", ["ranks_from_counts", "compute_ranks"])
@pytest.mark.parametrize("card", [True, False], ids=["card route", "cpu route"])
def test_fault_seam_of_each_full_catalog_route(card, seam, monkeypatch):
    """Each full-catalog route ranks through one module-level function of
    ``evaluation``: the card's through ``ranks_from_counts``, the CPU's
    through ``compute_ranks``. A fault planted there (every rank one
    worse) moves that route's counters, and the other function's does
    not."""
    monkeypatch.setattr(teval, "_on_card", lambda t: card)
    monkeypatch.setattr(sr, "score_rank_cuda", sr.score_rank_plain)
    cfg = step_cfg()
    n_items, cutoffs = 40, (1, 5, 20)
    params, H, in_idx, out_idx, valid, reset = step_inputs(cfg, n_items, seed=2)
    outs = []
    for fault in (False, True):
        if fault:
            ranks = getattr(teval, seam)
            monkeypatch.setattr(teval, seam, lambda *a: ranks(*a) + 1)
        Hs = [h.clone() for h in H]
        rec, mrr = torch.zeros(3), torch.zeros(3)
        step = teval.make_eval_step(cfg, n_items, cutoffs, "standard")
        for _ in range(3):
            step(params, Hs, in_idx, out_idx, valid, reset, rec, mrr, None)
        outs.append(torch.cat([rec, mrr]))
    reaches = card == (seam == "ranks_from_counts")
    assert float(outs[0][2]) > 0  # recall@20
    assert torch.equal(outs[0], outs[1]) != reaches


@pytest.fixture
def card_route(monkeypatch):
    """The card's fused route on the CPU: ``_on_card`` patched, the
    kernel's wrapper replaced by its plain version."""
    monkeypatch.setattr(teval, "_on_card", lambda t: True)
    monkeypatch.setattr(sr, "score_rank_cuda", sr.score_rank_plain)


def runner_case(cfg, n_items, steps, mode="standard", subset=False, seed=0):
    """An uncaptured evaluation runner (``_EvalGraph``) of the routed step
    over ``steps`` random schedule rows, built as ``evaluate`` builds it,
    and its stack and item list."""
    rng = np.random.RandomState(seed)
    B = cfg.batch_size
    stack = StackLayout(B, 0).pack(rng.randint(0, n_items, (steps, B)),
                                   rng.randint(0, n_items, (steps, B)),
                                   rng.rand(steps, B) < 0.8, rng.rand(steps, B) < 0.3,
                                   None, None, "cpu")
    item_idx = torch.arange(0, n_items, 4, dtype=torch.int32) if subset else None
    step = teval.make_eval_step(cfg, n_items, (1, 5, 20), mode, subset)
    runner = teval._EvalGraph(step, cfg, B, B, 3, None if item_idx is None else len(item_idx),
                              torch.device("cpu"), False, teval._table_cols(cfg, mode, subset))
    return runner, stack, item_idx


@pytest.mark.parametrize("final_act", ["softmax", "elu-1"])
def test_scores_product_reads_the_rounded_table(final_act, card_route, monkeypatch):
    """The runner's scores product gets its bfloat16 table, with the shape,
    strides and values of the product's own cast of ``Wy[:, :h].T``, and
    counts bit for bit as the step that casts on every step; under the
    kernel's softmax and elementwise modes alike."""
    seen = []
    make_mm = gru.make_mm

    def recording(cfg):
        mm = make_mm(cfg)
        return lambda a, b: seen.append(b) or mm(a, b)

    monkeypatch.setattr(gru, "make_mm", recording)
    cfg = step_cfg(compute_dtype="bfloat16", final_act=final_act)
    n_items, steps = 50, 4
    params, H = step_inputs(cfg, n_items)[:2]
    runner, stack, _ = runner_case(cfg, n_items, steps)
    runner.count(params, stack, seed=1)
    want = params["Wy"][:, :cfg.layers[-1]].T.to(torch.bfloat16)
    scores = [b for b in seen if b.shape == want.shape]
    assert len(scores) == steps
    for b in scores:
        assert b.dtype == torch.bfloat16 and b.stride() == want.stride() == (1, 16)
        assert b.data_ptr() == runner.table.data_ptr() and torch.equal(b, want)
    # the step without the table, as it ran before: the product casts
    Hs = [torch.zeros_like(h) for h in H]
    rec, mrr = torch.zeros(3), torch.zeros(3)
    step = teval.make_eval_step(cfg, n_items, (1, 5, 20), "standard")
    layout = StackLayout(cfg.batch_size, 0)
    for row in stack:
        in_idx, out_idx, valid, reset, _, _ = layout.split(row)
        step(params, Hs, in_idx, out_idx, valid, reset, rec, mrr, None)
    assert torch.equal(rec, runner.rec) and torch.equal(mrr, runner.mrr)
    assert all(torch.equal(a, b) for a, b in zip(Hs, runner.H))
    assert float(rec[-1]) > 0


@pytest.mark.parametrize("steps", [1, 3, 9])
def test_table_rounded_once_per_call(steps, card_route):
    from torch.profiler import ProfilerActivity, profile

    cfg = step_cfg(compute_dtype="bfloat16")
    params = step_inputs(cfg, 50)[0]
    runner, stack, _ = runner_case(cfg, 50, steps)
    teval.reset_table_casts()
    for calls in (1, 2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            runner.count(params, stack, seed=1)
        assert teval.table_casts == {"per_call": calls}
        assert [e.name for e in prof.events()].count("gru4rec.evaluate.cast") == 1
    teval.reset_table_casts()


def test_kept_runner_scores_the_live_table(card_route):
    """A runner kept across calls (``fit``'s validation keeps its graph)
    rounds the table again at each call: after an in-place change of
    ``Wy`` it counts what a fresh runner counts on the changed weights."""
    cfg = step_cfg(compute_dtype="bfloat16")
    n_items, h = 50, cfg.layers[-1]
    params = step_inputs(cfg, n_items)[0]
    runner, stack, _ = runner_case(cfg, n_items, 6)
    first = [t.clone() for t in runner.count(params, stack, seed=1)]
    table = runner.table
    params["Wy"][:, :h].copy_(torch.randn(params["Wy"][:, :h].shape,
                                          generator=torch.Generator().manual_seed(9)))
    second = runner.count(params, stack, seed=1)
    fresh = runner_case(cfg, n_items, 6)[0].count(params, stack, seed=1)
    assert runner.table is table  # refreshed in place: a graph reads the same buffer
    assert torch.equal(second[0], fresh[0]) and torch.equal(second[1], fresh[1])
    assert not torch.equal(first[1], second[1])


NO_TABLE = {  # name: (step_cfg's arguments, tie mode, subset, on the card, bfloat16 parameters)
    "bfloat16 table": (dict(compute_dtype="bfloat16"), "standard", False, True, True),
    "float32 products": (dict(), "standard", False, True, False),
    "subset": (dict(compute_dtype="bfloat16"), "standard", True, True, False),
    "tiebreaking": (dict(compute_dtype="bfloat16"), "tiebreaking", False, True, False),
    "elementwise": (dict(compute_dtype="bfloat16", final_act="elu-0.5"), "tiebreaking",
                    False, True, False),
    "cpu": (dict(compute_dtype="bfloat16"), "standard", False, False, False),
}


@pytest.mark.parametrize("case", list(NO_TABLE))
def test_no_table_where_the_step_casts_no_float32_table(case, monkeypatch):
    """A table already in bfloat16 (``cast_for_serving``), float32
    products, the subset, ``tiebreaking`` (under a softmax or an
    elementwise activation) and the CPU make no copy and count no
    refresh."""
    kw, mode, subset, card, narrow = NO_TABLE[case]
    monkeypatch.setattr(teval, "_on_card", lambda t: card)
    monkeypatch.setattr(sr, "score_rank_cuda", sr.score_rank_plain)
    cfg = step_cfg(**kw)
    params = step_inputs(cfg, 50)[0]
    if narrow:
        params = gru.map_params(lambda t: t.to(torch.bfloat16), params)
    runner, stack, item_idx = runner_case(cfg, 50, 3, mode, subset)
    teval.reset_table_casts()
    rec, _ = runner.count(params, stack, seed=1, item_idx=item_idx)
    assert runner.table is None and teval.table_casts == {"per_call": 0}
    assert float(rec[-1]) > 0


def fault_cases():
    B, N = 6, 64
    x = torch.zeros(B, N)
    bias = torch.zeros(N, 4)[:, 2]
    tgt = torch.zeros(B, dtype=torch.int32)
    return {
        "float64 logits": (x.double(), bias, 60, tgt, "standard"),
        "transposed logits": (torch.zeros(N, B).T, bias, 60, tgt, "standard"),
        "1-D logits": (x[0], bias, 60, tgt, "standard"),
        "short bias": (x, bias[:-1], 60, tgt, "standard"),
        "int bias": (x, torch.zeros(N, dtype=torch.int32), 60, tgt, "standard"),
        "2-D bias": (x, torch.zeros(N, 1), 60, tgt, "standard"),
        "int64 targets": (x, bias, 60, tgt.long(), "standard"),
        "short targets": (x, bias, 60, tgt[:-1], "standard"),
        "strided targets": (x, bias, 60, torch.zeros(2 * B, dtype=torch.int32)[::2],
                            "standard"),
        "n_items past N": (x, bias, N + 1, tgt, "standard"),
        "no items": (x, bias, 0, tgt, "standard"),
        "tiebreaking": (x, bias, 60, tgt, "tiebreaking"),
        "targets on another device": (x, bias, 60, tgt.to("meta"), "standard"),
        "unknown activation": (x, bias, 60, tgt, "standard", "swish"),
        "elu without its alpha": (x, bias, 60, tgt, "median", "elu"),
    }


@pytest.fixture
def stub_launch(monkeypatch):
    """The card path with its library stubbed: the launches it would make."""
    launched = []
    monkeypatch.setattr(sr, "workspace_bytes", lambda *a: 64)
    monkeypatch.setattr(sr, "_launch", lambda *args: launched.append(args))
    sr.reset_launches()
    yield launched
    sr.reset_launches()


@pytest.mark.parametrize("fault", list(fault_cases()))
def test_card_path_raises_on_what_it_does_not_take(fault, stub_launch):
    with pytest.raises(ValueError):
        sr.score_rank_cuda(*fault_cases()[fault])
    assert stub_launch == [] and sum(sr.launches_by_mode.values()) == 0


@pytest.mark.parametrize("mode", MODES)
def test_card_path_launches_and_counts(mode, stub_launch):
    """One launch and one count a call, in the softmax mode and in the
    elementwise mode (which hands the kernel its activation's code)."""
    x = torch.zeros(6, 64)
    bias = torch.zeros(64, 4, dtype=torch.bfloat16)[:, 2]
    for calls, act in enumerate(("softmax", "selu-1.5-0.25"), 1):
        gt, second = sr.score_rank_cuda(x, bias, 60, torch.zeros(6, dtype=torch.int32), mode,
                                        act)
        assert len(stub_launch) == calls and sr.launches_by_mode[mode] == calls
        assert gt.shape == (6,) and gt.dtype == torch.int32
        assert (second is None) == (mode == "standard")
    assert [args[-1] for args in stub_launch] == [None, (4, 1.5, 0.25)]


# --------------------------------------------------------------------- #
# On the card.

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_counts_close(x, bias, n_items, tgt, mode, exact=False):
    from chip_smoke import _near_target  # the allowance chip_smoke.py's score_rank phase holds

    got = sr.score_rank_cuda(x, bias, n_items, tgt, mode)
    want = sr.score_rank_plain(x, bias, n_items, tgt, mode)
    near = _near_target(x, bias, n_items, tgt)
    report = {}
    for name, g, w in zip(("gt", "second"), got, want):
        if w is None:
            assert g is None
            continue
        diff = (g.long() - w.long()).abs()
        report[name] = (int(diff.sum()), int((diff > 0).sum()))
        if exact:
            assert torch.equal(g.long(), w.long()), name
        else:
            # a lane with no other column within an ulp is exact
            assert bool((diff <= near).all()), (name, diff[diff > near][:8], near[diff > near][:8])
            assert int((diff > 0).sum()) <= int((near > 0).sum()), name
    print(mode, tuple(x.shape), "near columns", int(near.sum()), "off (sum, lanes)", report)
    return report


CARD_SHAPES = [(8, 1_000, 990), (240, 37_120, 36_992), (512, 200_064, 200_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_kernel_matches_plain(shape, mode, seed):
    dev = _card()
    B, N, n_items = shape
    x, bias, tgt = logits_case(B, N, n_items, seed, dev, ties=False, width=640)
    assert_counts_close(x, bias, n_items, tgt, mode)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_planted_ties_are_exact(shape, mode):
    """Logits on a coarse grid (no near ties) with duplicated item rows:
    exact ties alone, which the kernel must count as the plain version
    does."""
    dev = _card()
    B, N, n_items = shape
    x, bias, tgt = logits_case(B, N, n_items, 5, dev, ties=True, width=640)
    x = torch.round(x * 4) / 4
    bias = torch.round(bias * 4) / 4
    x[:, 1:4] = x[:, :1]
    assert_counts_close(x, bias, n_items, tgt, mode, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_recounted_lanes(mode):
    """Lanes the band cannot decide: the target 85, 100 and 200 below the
    max (a subnormal probability of a normal exp, a subnormal exp, a zero),
    a NaN score, an infinite score; again with a bfloat16 bias, and with an
    odd width (the scalar loads)."""
    dev = _card()
    B, N, n_items = 8, 5_000, 4_990
    x, bias, tgt = logits_case(B, N, n_items, 7, dev, ties=False, width=640)
    for r, gap in ((1, 85.0), (2, 100.0), (3, 200.0)):
        x[r, tgt[r]] = x[r].max() - gap
    x[4, 17] = torch.nan
    x[5, 23] = torch.inf
    assert_counts_close(x, bias, n_items, tgt, mode)
    assert_counts_close(x, bias.to(torch.bfloat16), n_items, tgt, mode)
    assert_counts_close(x[:, :4_999].contiguous(), bias[:4_999], 4_990, tgt, mode)


# diginetica's evaluation (512 lanes, 43,008 padded columns, 43,000 real)
# and a ragged width (scalar loads, a partial last tile)
EW_SHAPES = [(512, 43_008, 43_000), (96, 5_003, 4_990)]


def ew_case(B, N, n_items, seed, dev):
    """``logits_case`` with saturated ties, and special scores: a NaN and an
    infinity among a lane's columns, a lane whose target reads -inf (its
    activation -inf under linear and leaky, so the padding columns tie
    with it) and one whose target is NaN."""
    x, bias, tgt = logits_case(B, N, n_items, seed, dev, width=640, saturate=True)
    x[0, 17] = torch.nan
    x[2, 23] = torch.inf
    x[3, tgt[3]] = -torch.inf
    x[5, tgt[5]] = torch.nan
    return x, bias, tgt


@pytest.mark.cuda
@pytest.mark.parametrize("act", ELEMENTWISE)
@pytest.mark.parametrize("shape", EW_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_elementwise_kernel_matches_plain(shape, act):
    """The elementwise mode's counts equal the plain version's lane by lane,
    in every tie mode, with a float32 and a bfloat16 bias: no sum is
    involved, so there is no allowance."""
    dev = _card()
    B, N, n_items = shape
    x, bias, tgt = ew_case(B, N, n_items, 3, dev)
    for b in (bias, bias.to(torch.bfloat16)):
        for mode in MODES:
            got = sr.score_rank_cuda(x, b, n_items, tgt, mode, act)
            want = sr.score_rank_plain(x, b, n_items, tgt, mode, act)
            for name, g, w in zip(("gt", "second"), got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    off = (g.long() != w.long()).nonzero().flatten()
                    assert off.numel() == 0, (act, mode, b.dtype, name, off[:8].tolist(),
                                              g[off[:8]].tolist(), w[off[:8]].tolist())
    eq = sr.score_rank_plain(x, bias, n_items, tgt, "median", act)[1]
    if act.split("-")[0] in SATURATING:
        assert int(eq[1::3].min()) >= len(SATURATED) + 2  # the saturated ties count
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_elementwise_call_does_not_sync():
    dev = _card()
    x, bias, tgt = ew_case(*EW_SHAPES[0], 4, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts = sr.score_rank_cuda(x, bias, EW_SHAPES[0][2], tgt, "median", "elu-1")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = sr.score_rank_plain(x, bias, EW_SHAPES[0][2], tgt, "median", "elu-1")
    assert all(torch.equal(g, w) for g, w in zip(counts, want))


def card_model(final_act, seed=0):
    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.data.loader import build_itemidmap

    import pandas as pd

    rng = np.random.RandomState(seed)
    rows = [(s, f"item_{(7 * s + 3 * k) % 300}", 10 * s + k)
            for s in range(400) for k in range(rng.randint(2, 9))]
    test = pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])
    m = GRU4Rec(step_cfg(final_act=final_act, compute_dtype="bfloat16"))
    m.itemidmap = build_itemidmap(test, "ItemId")
    m.n_items = len(m.itemidmap)
    m.params = gru.init_params(m.config, m.n_items, m.device)
    m.params["Wy"][: m.n_items, 16].copy_(
        torch.randn(m.n_items, generator=torch.Generator(device=m.device).manual_seed(seed),
                    device=m.device) * 0.3)
    return m, test


@pytest.mark.cuda
@pytest.mark.parametrize("final_act", ["softmax", "elu-1"])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_captured_evaluate_calls_once_per_step(mode, final_act):
    import gru4rec_tpu_torch

    _card()
    m, test = card_model(final_act)
    kw = dict(cut_off=[1, 5, 10], batch_size=8, mode=mode)
    sr.reset_launches()
    eager = gru4rec_tpu_torch.evaluate(m, test, _eager=True, **kw)
    steps = sr.launches_by_mode[mode]
    graphs = {}
    got = gru4rec_tpu_torch.evaluate(m, test, _graphs=graphs, **kw)
    torch.cuda.synchronize()
    (runner,) = graphs.values()
    assert steps > 10 and runner.warm + runner.replays == steps
    assert runner.graph.tally["score_rank"] == {mode: 1}
    assert sr.launches_by_mode[mode] == 2 * steps
    assert got == eager


@pytest.mark.cuda
def test_cuda_kept_graph_scores_the_changed_table():
    """A graph kept through ``_graphs`` and replayed after an in-place
    change of ``Wy`` (as ``fit``'s steps change it between validations)
    counts what a standalone call on the changed model counts."""
    import gru4rec_tpu_torch

    _card()
    m, test = card_model("softmax")
    kw = dict(cut_off=[1, 5, 10], batch_size=8, mode="standard")
    graphs = {}
    first = gru4rec_tpu_torch.evaluate(m, test, _graphs=graphs, **kw)
    (runner,) = graphs.values()
    assert runner.graph is not None and runner.table is not None
    h = m.config.layers[-1]
    gen = torch.Generator(device=m.device).manual_seed(9)
    m.params["Wy"][:, :h].copy_(torch.randn(m.params["Wy"][:, :h].shape, generator=gen,
                                            device=m.device))
    got = gru4rec_tpu_torch.evaluate(m, test, _graphs=graphs, **kw)
    assert list(graphs.values()) == [runner]  # replayed, not captured again
    assert got == gru4rec_tpu_torch.evaluate(m, test, **kw)
    assert got != first


@pytest.mark.cuda
def test_cuda_captured_route_with_the_table_matches_eager():
    """The captured fused route and its eager plain version each round the
    table once a call, and count bit for bit alike."""
    import gru4rec_tpu_torch

    _card()
    m, test = card_model("softmax")
    kw = dict(cut_off=[1, 5, 10], batch_size=8, mode="standard")
    teval.reset_table_casts()
    eager = gru4rec_tpu_torch.evaluate(m, test, _eager=True, **kw)
    assert teval.table_casts == {"per_call": 1}
    graphs = {}
    got = gru4rec_tpu_torch.evaluate(m, test, _graphs=graphs, **kw)
    (runner,) = graphs.values()
    assert runner.replays > 10 and teval.table_casts == {"per_call": 2}
    assert runner.table.dtype == torch.bfloat16 and runner.table.is_contiguous()
    assert got == eager


@pytest.mark.cuda
def test_cuda_traced_call_rounds_the_table_once():
    """In a traced call of a kept graph the table's float32 -> bfloat16
    cast (the largest cast kernel: the whole table) runs once, not once
    per replay."""
    import json
    import math
    import os
    import tempfile

    import gru4rec_tpu_torch
    from gru4rec_tpu_torch.utils.profiling import trace

    _card()
    m, test = card_model("softmax")
    kw = dict(cut_off=[1, 5, 10], batch_size=8, mode="standard")
    graphs = {}
    gru4rec_tpu_torch.evaluate(m, test, _graphs=graphs, **kw)  # warm-up and capture
    (runner,) = graphs.values()
    replays = runner.replays
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        trace(lambda: gru4rec_tpu_torch.evaluate(m, test, _graphs=graphs, **kw), 1, path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    steps = runner.replays - replays
    casts = [e for e in events if e.get("cat") == "kernel" and "bfloat16_copy" in e["name"]]

    def threads(e):
        return math.prod(e["args"]["grid"]) * math.prod(e["args"]["block"])

    largest = max(map(threads, casts))
    assert steps > 10 and len(casts) > steps  # the small products' casts, every replay
    assert [threads(e) for e in casts].count(largest) == 1
