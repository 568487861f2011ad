"""Evaluation: repeated ``gru4rec_tpu_torch.evaluate`` calls on one held-out
click stream, ranking each next click among the whole catalog (Recall@c
and MRR@c at the traffic's cutoffs and batch, standard ties).

Set-up makes the stream and the weights from the seed and makes one call
(the first builds and loads what the program needs); the window is the
calls that follow, until ``seconds`` have passed, and its rate is every
event those calls ranked over the window's seconds. ``info.call_s`` holds
the count of the window's calls and the min, p25, p50, p75 and max of
their seconds (nearest rank), each call timed from the previous one's end
by the clock read that ends it, so the window does no timing work beyond
that read. With tracing, the window's second call runs under the
profiler, and its time holds the profiler's cost and the reading of its
trace. Every call's recall and MRR are compared with the reference's,
which ranks each session's clicks from its first one.
"""

from __future__ import annotations

from benchmark.jobs import common
from benchmark.reference import gru4rec as ref
from benchmark.yardstick import compare, generators, stats, tracing, weights


def run(cell, run):
    from gru4rec_tpu_torch import evaluate

    c, t, dev = cell.config, cell.traffic, run.device
    n = int(c["n_items"])
    data = generators.eval_sessions(int(t["clicks"]), n, run.stream("clicks"),
                                    c["clicks"]["mean_session_len"], c["clicks"]["zipf"])
    items, offsets = generators.sessions_csr(data)
    events = len(items) - (len(offsets) - 1)
    wseed = run.stream("weights")
    model = common.program_model(cell, weights.make_params(c, wseed, dev),
                                 run.stream("program"), dev)
    kw = {"cut_off": list(t["cutoffs"]), "batch_size": int(t["batch_size"]), "mode": t["mode"]}

    def call():
        with common.quiet():
            return evaluate(model, data, **kw)

    common.reset_peak(dev)
    call()
    run.window = [common.now()]
    results, ends, region = [], [], None
    while True:
        if run.trace and len(results) == 1:
            out = []
            region = tracing.profile(lambda: out.append(call()))
            results.append(out[0])
        else:
            results.append(call())
        ends.append(common.now())
        if ends[-1] - run.window[0] >= run.seconds and len(results) >= 1 + run.trace:
            break
    common.close_window(run)
    peak = common.memory_peak(dev)
    del model
    common.free(dev)

    ref.strict_float32()
    P = weights.flat(weights.make_params(c, wseed, dev))
    rec, mrr, n_ref = ref.evaluate(P, items, offsets, n, t["cutoffs"],
                                   c["params"]["final_act"],
                                   ref.ROUNDINGS[c["program"]["compute_dtype"]])
    if n_ref != events:
        raise RuntimeError(f"the reference ranked {n_ref} events, not {events}")
    bad = [r for r in results if len(r[0]) != len(t["cutoffs"]) or len(r[1]) != len(t["cutoffs"])]
    numbers = compare.eval_numbers([r for r in results if r not in bad], (rec, mrr))
    seconds = run.window[1] - run.window[0]
    layer = None
    if region is not None:
        layer = {"kind": "eval", "region": region, "config": c, "traffic": t,
                 "events": events, "steps": ref.count_steps(offsets, int(t["batch_size"]))}
    return {"metrics": {"eval_events_per_s": stats.rate(events * len(results), seconds),
                        "setup_s": run.setup_s()},
            "attempted": len(results), "failed": len(bad), "memory_peak_bytes": peak,
            "numbers": numbers, "layer": layer,
            "info": {"calls": len(results), "events_per_call": events,
                     "call_s": stats.summary([b - a for a, b in zip(run.window[:1] + ends, ends)]),
                     "recall": results[0][0], "mrr": results[0][1],
                     "reference_recall": rec, "reference_mrr": mrr}}
