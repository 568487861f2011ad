"""The port's spans and pace counters (``utils/profiling.py``).

* With no profiler, :func:`span` is one shared null context, and ``fit``
  and ``evaluate`` open no ``record_function``.
* Under ``torch.profiler`` the spans of ``fit``, the training chunk,
  ``evaluate`` and ``predict_topk`` carry their names and nest as
  documented: a schedule cache hit has no children; a chunk or a call
  opens as many spans at 4 steps as at 40, but for one
  ``gru4rec.train.sparse_update.<table>`` per item table and eager step
  and one ``gru4rec.evaluate.rank`` per eager full-catalog evaluation step.
* Every ``epoch_stats`` entry and JSONL ``epoch`` event carries the pace
  counters, also under a wrapper of ``make_chunk_fn`` that forwards only the
  chunk function's nine arguments and its ``runner``.
* The ``CountedGraph`` replay adds its tally to the counters bound at
  capture.
* On the card (marked ``cuda``): the graphs' spans (warm-up, capture,
  replay, release) and the device pace counters.
"""

import json
import types

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import gru4rec_tpu_torch  # noqa: E402
import gru4rec_tpu_torch.models.gru4rec as tmodel  # noqa: E402
import gru4rec_tpu_torch.utils.logging as tlog  # noqa: E402
from gru4rec_tpu_torch.utils import cuda_graph, profiling  # noqa: E402

N_ITEMS = 30
PHASES = {"sample", "upload", "issue", "nan_wait", "loss_sync"}

# the spans an eager training step, or the captured one, runs in
STEP_PARENTS = {"gru4rec.train.steps", "gru4rec.train.warmup", "gru4rec.graph.capture"}
# the spans an eager evaluation step, or the captured one, runs in
EVAL_STEP_PARENTS = {"gru4rec.evaluate.steps", "gru4rec.evaluate.warmup",
                     "gru4rec.graph.capture"}
# each span's parent span (None: none), as the program documents them
PARENT = {
    "gru4rec.fit.schedule": {None},
    "gru4rec.fit.nan_check": {None},
    "gru4rec.fit.loss_sync": {None},
    "gru4rec.fit.validate": {None},
    "gru4rec.fit.checkpoint": {None},
    "gru4rec.train.chunk": {None},
    "gru4rec.train.sample": {"gru4rec.train.chunk"},
    "gru4rec.train.upload": {"gru4rec.train.chunk"},
    "gru4rec.train.steps": {"gru4rec.train.chunk"},
    "gru4rec.train.loss": {"gru4rec.train.chunk"},
    "gru4rec.train.warmup": {"gru4rec.train.steps"},
    "gru4rec.train.sparse_update.Wx0": STEP_PARENTS,
    "gru4rec.train.sparse_update.E": STEP_PARENTS,
    "gru4rec.train.sparse_update.Wy": STEP_PARENTS,
    "gru4rec.evaluate": {None, "gru4rec.fit.validate"},
    "gru4rec.evaluate.schedule": {"gru4rec.evaluate"},
    "gru4rec.evaluate.schedule.join": {"gru4rec.evaluate.schedule"},
    "gru4rec.evaluate.schedule.sort": {"gru4rec.evaluate.schedule"},
    "gru4rec.evaluate.schedule.offsets": {"gru4rec.evaluate.schedule"},
    "gru4rec.evaluate.schedule.walk": {"gru4rec.evaluate.schedule"},
    "gru4rec.evaluate.upload": {"gru4rec.evaluate"},
    "gru4rec.evaluate.warmup": {"gru4rec.evaluate"},
    "gru4rec.evaluate.replay": {"gru4rec.evaluate"},
    "gru4rec.evaluate.steps": {"gru4rec.evaluate"},
    "gru4rec.evaluate.fetch": {"gru4rec.evaluate"},
    "gru4rec.evaluate.release": {"gru4rec.evaluate"},
    "gru4rec.evaluate.rank": EVAL_STEP_PARENTS,
    "gru4rec.graph.capture": {"gru4rec.train.steps", "gru4rec.evaluate", "gru4rec.serve"},
    "gru4rec.serve": {None},
    "gru4rec.serve.keep": {"gru4rec.serve"},
    "gru4rec.serve.lookup": {"gru4rec.serve"},
    "gru4rec.serve.upload": {"gru4rec.serve"},
    "gru4rec.serve.step": {"gru4rec.serve"},
    "gru4rec.serve.replay": {"gru4rec.serve"},
    "gru4rec.serve.fetch": {"gru4rec.serve"},
    "gru4rec.serve.idmap": {"gru4rec.serve"},
}


def markov(n_sessions, n_items=N_ITEMS, seed=0):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def model(device="cpu", **kw):
    args = dict(loss="bpr-max", final_act="elu-0.5", layers=[16], batch_size=8,
                n_sample=8, compute_dtype="float32", opt_state_dtype="float32",
                momentum=0.2, chunk_size=16, n_epochs=2, item_pad_multiple=8, seed=3)
    args.update(kw)
    return gru4rec_tpu_torch.GRU4Rec(gru4rec_tpu_torch.GRU4RecConfig(**args), device=device)


def traced(fn, cuda=False):
    """The ``gru4rec.*`` host spans of ``fn()`` under ``torch.profiler``:
    [(name, start, end, parent name or None)], in start order."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(traced.path)
    with open(traced.path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("gru4rec.")),
                   key=lambda s: (s[1], -s[2]))
    out = []
    for i, (name, a, b) in enumerate(spans):
        around = [s for s in spans[:i] if s[1] <= a and b <= s[2]]
        parent = min(around, key=lambda s: s[2] - s[1])[0] if around else None
        out.append((name, a, b, parent))
    return out


@pytest.fixture(autouse=True)
def trace_path(tmp_path):
    traced.path = str(tmp_path / "trace.json")


def assert_nesting(spans):
    for name, _, _, parent in spans:
        assert name in PARENT, name
        assert parent in PARENT[name], (name, parent)


def names(spans):
    return [s[0] for s in spans]


def test_span_off_is_the_shared_null_context():
    assert profiling.span("gru4rec.x") is profiling.span("gru4rec.y") is profiling._OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("gru4rec.x"), torch.profiler.record_function)
    assert profiling.span("gru4rec.x") is profiling._OFF


def test_fit_and_evaluate_record_nothing_with_the_profiler_off(monkeypatch):
    opened = []

    class Counting(torch.profiler.record_function):
        def __init__(self, *a, **kw):
            opened.append(a)
            super().__init__(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    m = model().fit(markov(60), eval_data=markov(20, seed=5))
    gru4rec_tpu_torch.evaluate(m, markov(20, seed=5), batch_size=8)
    m.predict_topk(np.arange(8), np.array(["item_1"] * 8), k=5, batch=8)
    assert len(m.epoch_stats) == 2 and opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        gru4rec_tpu_torch.evaluate(m, markov(20, seed=5), batch_size=8)
    assert ("gru4rec.evaluate",) in opened  # the patch sees the spans when they open


def test_spans_carry_their_names_and_nest(tmp_path):
    valid = markov(20, seed=5)

    def run():
        m = model().fit(markov(60), eval_data=valid, checkpoint_every=1,
                        checkpoint_path=str(tmp_path / "ckpt.npz"))
        gru4rec_tpu_torch.evaluate(m, valid, batch_size=8)
        for _ in range(2):
            m.predict_topk(np.arange(8), np.array(["item_1"] * 8), k=5, batch=8)

    spans = traced(run)
    assert_nesting(spans)
    seen = set(names(spans))
    cpu = {n for n in PARENT if n not in (
        "gru4rec.train.warmup", "gru4rec.graph.capture", "gru4rec.evaluate.warmup",
        "gru4rec.evaluate.replay", "gru4rec.evaluate.release", "gru4rec.serve.upload",
        "gru4rec.serve.replay", "gru4rec.train.sparse_update.E")}
    # the CPU runs every eager path of this one-hot model, and captures nothing
    assert seen == cpu
    # fit's validation memoizes its schedule: the first of its calls builds
    # it, the second hits; the standalone call builds its own
    builds = [n for n in names(spans) if n == "gru4rec.evaluate.schedule.join"]
    assert names(spans).count("gru4rec.evaluate.schedule") == 3 and len(builds) == 2


def test_a_schedule_cache_hit_has_no_children():
    m = model().fit(markov(60))
    cache, valid = {}, markov(20, seed=5)
    gru4rec_tpu_torch.evaluate(m, valid, batch_size=8, _sched_cache=cache)
    spans = traced(lambda: gru4rec_tpu_torch.evaluate(m, valid, batch_size=8,
                                                      _sched_cache=cache))
    assert_nesting(spans)
    assert [s for s in spans if s[3] == "gru4rec.evaluate.schedule"] == []
    assert names(spans).count("gru4rec.evaluate.schedule") == 1


def chunk_inputs(m, data, steps):
    """The first ``steps`` steps of a fitted model's training schedule on
    ``data`` and its sampler table."""
    from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order
    from gru4rec_tpu_torch.data.tools import compute_offset
    from gru4rec_tpu_torch.ops.sampling import build_alias_table

    d = data.copy()
    d["ItemIdx"] = m.itemidmap[d["ItemId"]].values
    offsets = compute_offset(d, "SessionId")
    order = session_order(d, "SessionId", "Time", False, len(offsets) - 1)
    sched = build_schedule(d["ItemIdx"].values.astype(np.int32), offsets, order, 8)
    assert sched.n_steps >= steps
    pop = d.groupby("ItemIdx").size().reindex(range(m.n_items), fill_value=0).values
    samp1 = torch.from_numpy(build_alias_table(pop, m.config.sample_alpha))
    return [a[:steps] for a in (sched.in_idx, sched.out_idx, sched.valid, sched.reset)], samp1


def eval_frame(m, data, steps):
    """The first sessions of ``data`` whose evaluation at batch 8 takes
    ``steps`` to twice as many steps."""
    from gru4rec_tpu_torch.eval.evaluation import _eval_schedule

    for n in range(8, data.SessionId.max() + 1):
        frame = data[data.SessionId < n]
        got = _eval_schedule(m, frame, 8, "SessionId", "ItemId", "Time").n_steps
        if got >= steps:
            assert got < 2 * steps
            return frame
    raise AssertionError(f"no {steps} steps in the data")


@pytest.mark.parametrize("kind", ["chunk", "evaluate"])
def test_no_span_per_step(kind):
    data = markov(200)
    m = model().fit(data, n_epochs=1)
    got = []
    for steps in (4, 40):
        if kind == "chunk":
            fn = tmodel.make_chunk_fn(m.config, m.n_items)
            sched, samp1 = chunk_inputs(m, data, steps)
            logp0 = torch.zeros(m._train_state.params["Wy"].shape[0])
            spans = traced(lambda: fn(m._train_state, *sched, samp1, logp0))
        else:
            frame = eval_frame(m, data, steps)
            spans = traced(lambda: gru4rec_tpu_torch.evaluate(m, frame, batch_size=8))
        assert_nesting(spans)
        per_step = [n for n in names(spans) if n.startswith("gru4rec.train.sparse_update.")
                    or n == "gru4rec.evaluate.rank"]
        if kind == "chunk":  # one-hot: both item tables, once a live step each
            live = int((sched[2].sum(axis=1) > 0).sum())
            assert sorted(per_step) == sorted(["gru4rec.train.sparse_update.Wx0",
                                               "gru4rec.train.sparse_update.Wy"] * live)
        else:  # the CPU ranks every step of the full catalog eagerly
            from gru4rec_tpu_torch.eval.evaluation import _eval_schedule

            n = _eval_schedule(m, frame, 8, "SessionId", "ItemId", "Time").n_steps
            assert per_step == ["gru4rec.evaluate.rank"] * n
        got.append(sorted(n for n in names(spans) if n not in per_step))
    assert got[0] == got[1] and got[0]


def check_pace(stats, chunks_at_most, cuda=False):
    assert set(stats["host_s"]) == PHASES
    assert all(v >= 0.0 for v in stats["host_s"].values())
    assert stats["host_s"]["issue"] > 0.0 and stats["host_s"]["upload"] > 0.0
    if cuda:
        assert stats["device_s"] > 0.0 and 0 <= stats["behind"] <= chunks_at_most
    else:
        assert stats["device_s"] is None and stats["behind"] is None


def test_epochs_carry_the_pace_counters(tmp_path, monkeypatch):
    path = str(tmp_path / "log.jsonl")
    monkeypatch.setattr(tlog, "_default", tlog.EventLogger(path))
    m = model().fit(markov(60))
    tlog._default.close()
    with open(path) as f:
        events = [json.loads(line) for line in f if json.loads(line)["event"] == "epoch"]
    assert len(m.epoch_stats) == len(events) == 2
    for stats, event in zip(m.epoch_stats, events):
        assert {"loss", "seconds", "steps", "events"} <= set(stats)
        chunks = -(-stats["steps"] // m.config.chunk_size)
        check_pace(stats, chunks)
        check_pace(event, chunks)
        assert event["host_s"] == stats["host_s"]
        assert stats["host_s"]["nan_wait"] > 0.0 and stats["host_s"]["sample"] > 0.0


def test_fit_counts_its_pace_under_a_wrapped_chunk_function(monkeypatch):
    """A wrapper that forwards only the chunk function's nine arguments
    and keeps only ``runner`` (as a harness watching ``fit`` does) leaves
    the counters whole: they travel through the training state."""
    real, calls = tmodel.make_chunk_fn, []

    def wrap(cfg, n_items, *args, **kw):
        fn = real(cfg, n_items, *args, **kw)

        def chunk_fn(state, in_c, out_c, valid_c, reset_c, samp1, logp0, neg=None,
                     sr_seeds=None):
            calls.append(len(in_c))
            return fn(state, in_c, out_c, valid_c, reset_c, samp1, logp0, neg, sr_seeds)

        chunk_fn.runner = getattr(fn, "runner", None)
        return chunk_fn

    monkeypatch.setattr(tmodel, "make_chunk_fn", wrap)
    m = model().fit(markov(60))
    assert calls and sum(calls) == sum(e["steps"] for e in m.epoch_stats)
    for stats in m.epoch_stats:
        check_pace(stats, -(-stats["steps"] // m.config.chunk_size))
    assert m._train_state.pace is None  # fit lets go of the last epoch's counters


def test_counted_graph_adds_its_tally_to_the_bound_counters():
    from gru4rec_tpu_torch.ops import mixed_mm
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    sparse_update.reset_launches()
    mixed_mm.reset_launches()
    g = cuda_graph.CountedGraph(types.SimpleNamespace(replay=lambda: None),
                                {"sparse_update": {"K1": 2, "K4": 1}, "mixed_mm": {"forward": 3}})
    for _ in range(5):
        g.replay()
    assert sparse_update.launches_by_mode == {"K1": 10, "K2": 0, "K3": 0, "K4": 5}
    assert mixed_mm.launches_by_mode == {"forward": 15, "backward": 0}
    sparse_update.reset_launches()
    mixed_mm.reset_launches()
    g.replay()  # the counters are reset in place: still bound
    assert sparse_update.launches_by_mode["K1"] == 2 and mixed_mm.launches_by_mode["forward"] == 3
    sparse_update.reset_launches()
    mixed_mm.reset_launches()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_cuda_graph_spans_and_device_pace():
    _card()
    data, valid = markov(200), markov(40, seed=5)
    m = model(device=None, chunk_size=32)
    spans = traced(lambda: m.fit(data, eval_data=valid), cuda=True)
    assert_nesting(spans)
    got = names(spans)
    # the step graph warms up and is captured once in the first chunk; the
    # validation graph once, and kept (no release)
    assert got.count("gru4rec.train.warmup") == 1
    assert [s[3] for s in spans if s[0] == "gru4rec.graph.capture"] == \
        ["gru4rec.train.steps", "gru4rec.evaluate"]
    assert got.count("gru4rec.evaluate.warmup") == 1 and "gru4rec.evaluate.release" not in got
    assert got.count("gru4rec.evaluate.replay") == 2
    for stats in m.epoch_stats:
        check_pace(stats, -(-stats["steps"] // 32), cuda=True)

    spans = traced(lambda: gru4rec_tpu_torch.evaluate(m, valid, batch_size=8), cuda=True)
    assert_nesting(spans)
    # elu-0.5 ranks eagerly: one rank span in each warm-up step and at the capture
    assert [s[3] for s in spans if s[0] == "gru4rec.evaluate.rank"] == \
        ["gru4rec.evaluate.warmup"] * 3 + ["gru4rec.graph.capture"]
    assert [n for n in names(spans) if n.count(".") == 2 and n not in (
            "gru4rec.graph.capture", "gru4rec.evaluate.rank")] == [
        "gru4rec.evaluate.schedule", "gru4rec.evaluate.upload", "gru4rec.evaluate.warmup",
        "gru4rec.evaluate.replay", "gru4rec.evaluate.fetch", "gru4rec.evaluate.release"]

    def serve():
        for _ in range(3):
            m.predict_topk(np.arange(8), np.array(["item_1"] * 8), k=5, batch=8)

    spans = traced(serve, cuda=True)
    assert_nesting(spans)
    got = names(spans)
    assert got.count("gru4rec.serve") == 3 and got.count("gru4rec.graph.capture") == 1
    assert got.count("gru4rec.serve.step") == 1 and got.count("gru4rec.serve.replay") == 2
