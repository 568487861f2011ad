"""The ``diginetica`` configuration of the benchmark (``paramfiles/
diginetica_best.py``: GRU-512, bpr-max, elu-1) and the evaluation route its
elementwise final activation takes, on the CPU at a tiny size (300 items,
GRU-16, batch 8):

* the configuration holds the paramfile's parameters, cut in ``n_epochs``
  alone;
* ``evaluate`` agrees with ``benchmark/reference/gru4rec.py::evaluate`` on
  the benchmark's seeded weights, Recall and MRR at cutoffs 1/5/10/20;
* ``eval_routes`` counts one ``full_eager`` call for elu-1 and one
  ``subset`` call with ``items=``; on the card (``cuda``-marked, skipped
  here; run there with ``python -m pytest --noconftest -m cuda
  tests/test_torch_diginetica_eval.py``) a softmax call counts ``fused``
  and opens no rank span, an elu-1 call counts ``fused_elementwise`` and
  opens the rank span in its eager warm-up steps and at the capture, and
  its captured call gives the Recall and MRR of the eager route
  (``full_eager``);
* the span ``gru4rec.evaluate.rank`` opens once per step on the
  full-catalog eager route and never on the subset;
* the readers ``eval_elementwise.us_per_step`` and
  ``eval_elementwise_roofline`` give nothing on a trace without the span
  and the right time and share on a synthetic one;
* ``benchmark/yardstick/score_bytes.py`` counts one read of the scores.
"""

import copy
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from benchmark import spec  # noqa: E402
from benchmark.jobs import common  # noqa: E402
from benchmark.reference import gru4rec as ref  # noqa: E402
from benchmark.yardstick import counts, generators, score_bytes, tracing, weights  # noqa: E402
from gru4rec_tpu_torch import evaluate  # noqa: E402
from gru4rec_tpu_torch.eval import evaluation  # noqa: E402
from gru4rec_tpu_torch.utils.cuda_graph import WARMUP_STEPS  # noqa: E402

CPU = torch.device("cpu")
CUTOFFS = [1, 5, 10, 20]
SEEDS = [5, 2**31 + 7, 2**33 + 1]
SIZE = {"n_items": 300, "layers": [16], "batch_size": 8}
RANK = "gru4rec.evaluate.rank"


def tiny_cell():
    cell = copy.deepcopy(spec.cell("diginetica.eval"))
    cell.config["n_items"] = SIZE["n_items"]
    cell.config["params"].update(layers=SIZE["layers"], batch_size=SIZE["batch_size"])
    return cell


def tiny_model(seed):
    """The program's model on the benchmark's weights of ``seed``, and the
    weights' seed."""
    cell = tiny_cell()
    wseed = generators.seed32(seed, "weights")
    params = weights.make_params(cell.config, wseed, CPU)
    return cell, common.program_model(cell, params, generators.seed32(seed, "program"), CPU), wseed


def clicks(cell, seed, n=1500):
    c = cell.config
    return generators.eval_sessions(n, int(c["n_items"]), generators.seed32(seed, "clicks"),
                                    c["clicks"]["mean_session_len"], c["clicks"]["zipf"])


def run_evaluate(model, data, **kw):
    with common.quiet():
        return evaluate(model, data, cut_off=CUTOFFS, batch_size=SIZE["batch_size"], **kw)


def test_the_configuration_is_the_paramfiles():
    from gru4rec_tpu_torch import GRU4RecConfig

    conf = {c["name"]: c for c in spec.load_spec()["configs"]}["diginetica"]
    assert conf["reduced"] == ["n_epochs"]
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        config = json.load(f)
    published = GRU4RecConfig.from_parameter_file(
        os.path.join(spec.ROOT, "paramfiles", "diginetica_best.py"))
    for k, v in config["params"].items():
        assert getattr(published, k) == v, k
    assert config["params"]["final_act"] == "elu-1" and config["n_items"] == 43000


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_agrees_with_the_reference(seed):
    cell, model, wseed = tiny_model(seed)
    data = clicks(cell, seed)
    rec, mrr = run_evaluate(model, data)
    items, offsets = generators.sessions_csr(data)
    ref.strict_float32()
    P = weights.flat(weights.make_params(cell.config, wseed, CPU))
    want_rec, want_mrr, n = ref.evaluate(P, items, offsets, SIZE["n_items"], CUTOFFS, "elu-1",
                                         ref.round_bf16)
    assert n == len(items) - (len(offsets) - 1)
    # the same bfloat16 roundings on the CPU: the two differ by float32
    # summation order alone, which moves no rank here
    np.testing.assert_allclose(rec, want_rec, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mrr, want_mrr, rtol=0, atol=1e-6)
    assert rec[-1] > rec[0] > 0


@pytest.mark.parametrize("items", [False, True])
def test_each_call_counts_its_route(items):
    cell, model, _ = tiny_model(SEEDS[0])
    data = clicks(cell, SEEDS[0], 400)
    kw = {"items": np.arange(0, SIZE["n_items"], 3)} if items else {}
    evaluation.reset_eval_routes()
    run_evaluate(model, data, **kw)
    want = dict.fromkeys(evaluation.EVAL_ROUTES, 0)
    want["subset" if items else "full_eager"] = 1
    assert evaluation.eval_routes == want
    evaluation.reset_eval_routes()
    assert set(evaluation.eval_routes.values()) == {0}


def rank_spans(fn):
    """The names of the ``gru4rec.*`` spans ``fn()`` opens under the
    profiler, in order."""
    region = tracing.profile(fn)
    return [e["name"] for e in sorted(region.host, key=lambda e: e["ts"])
            if e.get("cat") == "user_annotation" and e["name"].startswith("gru4rec.")]


@pytest.mark.parametrize("items", [False, True])
def test_the_rank_span_opens_on_the_eager_full_catalog_route_only(items):
    cell, model, _ = tiny_model(SEEDS[1])
    data = clicks(cell, SEEDS[1], 400)
    kw = {"items": np.arange(0, SIZE["n_items"], 3)} if items else {}
    spans = rank_spans(lambda: run_evaluate(model, data, **kw))
    steps = evaluation._eval_schedule(model, data, SIZE["batch_size"], "SessionId", "ItemId",
                                      "Time").n_steps
    assert spans.count(RANK) == (0 if items else steps)
    assert "gru4rec.evaluate.steps" in spans


# --------------------------------------------------------------------- #
# The readers, on synthetic traces.

GEMM = "nvjet_tss_320x128_64x3_1x2_h_bz_coopB_TNT"
ELU = "void at::native::vectorized_elementwise_kernel<4, at::native::elu_kernel>"
COUNT = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<long>>"
CAST = "void at::native::vectorized_elementwise_kernel<8, bfloat16_copy_kernel_cuda>"


def reader(name):
    s = importlib.util.spec_from_file_location(f"m_{name}", spec.metric_path(name))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


def eval_layer(kernels, span=True, steps=4, n_items=43000, batch=512):
    events = [event("user_annotation", tracing.REGION, 0.0, 100_000.0)]
    if span:
        events.append(event("user_annotation", RANK, 10.0, 5.0))
    events += [event("kernel", n, ts, dur) for n, ts, dur in kernels]
    cell = spec.cell("diginetica.eval")
    config = {**cell.config, "n_items": n_items}
    return {"kind": "eval", "region": tracing.Region(events), "config": config,
            "traffic": {**cell.traffic, "batch_size": batch}, "events": 2000, "steps": steps}


def four_steps():
    """Four steps, each a GEMM (200 us), a cast (30), the elu (60) and the
    counts (90): 180 us a step outside the products."""
    ks = []
    for t in range(4):
        base = 1000.0 * t + 100.0
        ks += [(GEMM, base, 200.0), (CAST, base + 210, 30.0), (ELU, base + 250, 60.0),
               (COUNT, base + 320, 90.0)]
    return ks


def test_the_readers_read_the_work_outside_the_products():
    layer = eval_layer(four_steps())
    assert reader("eval_elementwise.us_per_step")(layer) == pytest.approx(180.0)
    bound_s = 512 * 43008 * 4 / 3.35e12
    assert reader("eval_elementwise_roofline")(layer) == pytest.approx(100 * bound_s / 180e-6)


@pytest.mark.parametrize("case", ["no_span", "products_alone", "train", "none"])
def test_the_readers_read_nothing_off_the_route(case):
    layer = {"no_span": lambda: eval_layer(four_steps(), span=False),
             "products_alone": lambda: eval_layer([(GEMM, 100.0, 200.0)]),
             "train": lambda: {**eval_layer(four_steps()), "kind": "train"},
             "none": lambda: None}[case]()
    for name in ("eval_elementwise.us_per_step", "eval_elementwise_roofline"):
        assert reader(name)(layer) is None


def test_score_bytes_is_one_read_of_the_scores():
    assert counts.pad_items(43000) == 43008
    assert score_bytes.score_bytes(512, 43008) == 88_080_384
    assert score_bytes.read_bound_s(512, 43008) * 1e6 == pytest.approx(26.29, abs=0.01)
    assert all(score_bytes.is_product(n) for n in
               (GEMM, "sm90_xmma_gemm_bf16bf16_bf16f32", "cutlass_80_simt_sgemm_128x32"))
    assert not any(score_bytes.is_product(n) for n in (ELU, COUNT, CAST))


# --------------------------------------------------------------------- #
# On the card.

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("final_act", ["softmax", "elu-1"])
def test_card_counts_the_fused_route_for_softmax(final_act):
    dev = _card()
    cell = tiny_cell()
    cell.config["params"]["final_act"] = final_act
    wseed = generators.seed32(SEEDS[0], "weights")
    model = common.program_model(cell, weights.make_params(cell.config, wseed, dev), 7, dev)
    data = clicks(cell, SEEDS[0], 1500)
    evaluation.reset_eval_routes()
    spans = rank_spans(lambda: run_evaluate(model, data))
    route = "fused" if final_act == "softmax" else "fused_elementwise"
    assert evaluation.eval_routes == {**dict.fromkeys(evaluation.EVAL_ROUTES, 0), route: 1}
    # eager warm-up steps and the capture open the span; replays do not
    assert spans.count(RANK) == (0 if route == "fused" else WARMUP_STEPS + 1)
    evaluation.reset_eval_routes()


@pytest.mark.cuda
def test_card_fused_elementwise_matches_the_eager_route(monkeypatch):
    """A captured elu-1 call through the ranking kernel's elementwise mode
    gives the Recall and MRR of the same call with the step forced onto the
    eager route."""
    dev = _card()
    cell = tiny_cell()
    wseed = generators.seed32(SEEDS[1], "weights")
    model = common.program_model(cell, weights.make_params(cell.config, wseed, dev), 7, dev)
    data = clicks(cell, SEEDS[1], 1500)
    evaluation.reset_eval_routes()
    got = run_evaluate(model, data)
    assert evaluation.eval_routes["fused_elementwise"] == 1
    monkeypatch.setattr(evaluation, "_eval_route", lambda *a: "full_eager")
    monkeypatch.setattr(evaluation, "_table_cols", lambda *a: None)
    want = run_evaluate(model, data)
    assert got == want and got[0][-1] > 0
    evaluation.reset_eval_routes()


def test_the_card_tests_stream_is_long_enough_to_capture():
    """The card test's stream takes more steps than the captured step's
    warm-up, so that its call captures."""
    cell = tiny_cell()
    data = clicks(cell, SEEDS[0], 1500)
    steps = evaluation._eval_schedule(
        common.program_model(cell, weights.make_params(cell.config, 1, CPU), 1, CPU), data,
        SIZE["batch_size"], "SessionId", "ItemId", "Time").n_steps
    assert steps > WARMUP_STEPS + 1
