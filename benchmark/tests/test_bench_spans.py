"""The readers of the program's spans (``schedule_ms.eval``,
``graph_setup_ms.eval``) on synthetic chrome traces with known spans."""

import importlib.util

import pytest

from benchmark import spec
from benchmark.yardstick import tracing


def reader(name):
    s = importlib.util.spec_from_file_location(f"m_{name}", spec.metric_path(name))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def host(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def op(ts, dur, correlation=None, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if correlation is None else {"correlation": correlation}}


def region(*events, t1=100_000.0):
    return tracing.Region([host(tracing.REGION, 0.0, t1)] + list(events))


def eval_trace(capture=True):
    # one call: schedule 600 ms, warm-up 10 ms, capture 20 ms, release 5 ms
    # (1 ms = 1000 us on the trace's clock); a capture outside the call
    events = [host("gru4rec.evaluate", 100.0, 900_000.0),
              host("gru4rec.evaluate.schedule", 200.0, 600_000.0),
              host("gru4rec.evaluate.schedule.sort", 300.0, 400_000.0),
              host("gru4rec.evaluate.upload", 600_300.0, 1_000.0),
              host("gru4rec.evaluate.replay", 640_000.0, 200_000.0),
              host("gru4rec.evaluate.fetch", 840_000.0, 1_000.0),
              host("gru4rec.graph.capture", 950_000.0, 30_000.0)]
    if capture:
        events += [host("gru4rec.evaluate.warmup", 601_400.0, 10_000.0),
                   host("gru4rec.graph.capture", 611_500.0, 20_000.0),
                   host("gru4rec.evaluate.release", 841_100.0, 5_000.0)]
    return region(*events, op(610_000.0, 1_000.0), t1=1_000_000.0)


def eval_layer(r):
    return {"kind": "eval", "region": r, "steps": 10}


def test_schedule_reads_the_schedule_span_per_call():
    assert reader("schedule_ms.eval")(eval_layer(eval_trace())) == pytest.approx(600.0)


def test_graph_setup_sums_warmup_capture_and_release_inside_the_call():
    read = reader("graph_setup_ms.eval")
    assert read(eval_layer(eval_trace())) == pytest.approx(35.0)
    assert read(eval_layer(eval_trace(capture=False))) == 0.0  # a kept graph


@pytest.mark.parametrize("name", ["schedule_ms.eval", "graph_setup_ms.eval"])
def test_missing_spans(name):
    """No call span: an error where the trace holds other spans of the
    program, no reading where it holds none (a program without spans);
    another kind of run, no reading."""
    read = reader(name)
    other_span = {"kind": "eval", "region": region(host("gru4rec.graph.capture", 10.0, 5.0)),
                  "steps": 4}
    with pytest.raises(RuntimeError, match="no gru4rec.evaluate"):
        read(other_span)
    bare = {"kind": "eval", "region": region(op(10.0, 5.0), host("aten::mm", 10.0, 5.0,
                                                                 cat="cpu_op")), "steps": 4}
    assert read(bare) is None
    assert read({**other_span, "kind": "train"}) is None and read(None) is None
