"""Serving: a closed loop of one caller, each call ``GRU4Rec.predict_topk``
of ``k`` items for ``lanes`` live sessions.

Each lane is a live session that sends its next click every call; a lane
whose session ends takes its next session (``generators.lane_streams``),
and the program's keep mask resets it. The stream is made from the seed,
long enough for ``max_calls_per_s`` calls a second (a faster program ends
its window at the stream's end). Set-up makes the first
``warmup_calls`` calls; the window is the calls that follow until
``seconds`` have passed, each timed on the host from the call until its
result is on the host. With tracing, ``traced_calls`` calls after
``traced_after`` run under the profiler, each in a span of its own.

Once the window has closed, ``checked_calls`` calls drawn from the seed
among the window's are compared with the reference, which runs each lane's
session from its first click: every served item's score, and its place.
"""

from __future__ import annotations

import numpy as np

from benchmark.jobs import common
from benchmark.reference import gru4rec as ref
from benchmark.yardstick import compare, generators, stats, tracing, weights


def positions(sids: np.ndarray) -> np.ndarray:
    """Each (call, lane)'s click position within its session."""
    T = len(sids)
    change = np.ones_like(sids, dtype=bool)
    change[1:] = sids[1:] != sids[:-1]
    start = np.maximum.accumulate(np.where(change, np.arange(T)[:, None], 0), axis=0)
    return np.arange(T)[:, None] - start


def stream(cell, run):
    """``(items, offsets, session ids, item ids)``: the sessions and the
    calls' (calls, lanes) arrays."""
    c, t = cell.config, cell.traffic
    cap = int(run.seconds * t["max_calls_per_s"]) + int(t["warmup_calls"])
    data = generators.eval_sessions(int(cap * int(t["lanes"]) * 1.1), int(c["n_items"]),
                                    run.stream("clicks"), c["clicks"]["mean_session_len"],
                                    c["clicks"]["zipf"])
    items, offsets = generators.sessions_csr(data)
    return (items, offsets, *generators.lane_streams(items, offsets, int(t["lanes"])))


def sample(cell, run, sids, end):
    """The checked calls, drawn from the seed among the window's calls
    ``[warmup_calls, end)``, and their queries: each lane's session and
    prefix length."""
    warm = int(cell.traffic["warmup_calls"])
    rng = np.random.default_rng(run.stream("sample"))
    sel = np.sort(rng.choice(np.arange(warm, end),
                             size=min(int(cell.traffic["checked_calls"]), end - warm),
                             replace=False))
    return sel, sids[sel].reshape(-1), positions(sids)[sel].reshape(-1) + 1


def run(cell, run):
    c, t, dev = cell.config, cell.traffic, run.device
    n, lanes, k = int(c["n_items"]), int(t["lanes"]), int(t["k"])
    warm = int(t["warmup_calls"])
    items, offsets, sids, iids = stream(cell, run)
    T = len(sids)
    wseed = run.stream("weights")
    model = common.program_model(cell, weights.make_params(c, wseed, dev),
                                 run.stream("program"), dev)
    served_ids = np.zeros((T, lanes, k), dtype=np.int64)
    served = np.zeros((T, lanes, k), dtype=np.float32)
    lat = []

    def call(i, span=None):
        t0 = common.now()
        if span is None:
            ids, scores = model.predict_topk(sids[i], iids[i], k=k, batch=lanes)
        else:
            with span():
                ids, scores = model.predict_topk(sids[i], iids[i], k=k, batch=lanes)
        lat.append(common.now() - t0)
        served_ids[i], served[i] = ids, scores

    common.reset_peak(dev)
    region = None
    with common.quiet():
        for i in range(warm):
            call(i)
        lat.clear()
        run.window = [common.now()]
        i = warm
        while i < T:
            if run.trace and i == warm + int(t["traced_after"]):
                m = min(int(t["traced_calls"]), T - i)
                region = tracing.profile(
                    lambda: [call(j, tracing.call_span) for j in range(i, i + m)])
                i += m
            else:
                call(i)
                i += 1
            if common.now() - run.window[0] >= run.seconds:
                break
    common.close_window(run)
    peak = common.memory_peak(dev)
    del model
    common.free(dev)

    sel, q_sess, q_len = sample(cell, run, sids, i)
    got = served_ids[sel].reshape(-1, k)
    bad = int(((got < 0) | (got >= n)).any(axis=1).sum())
    ref.strict_float32()
    P = weights.flat(weights.make_params(c, wseed, dev))
    ref_at, ref_best, _ = ref.serve_scores(
        P, items, offsets[q_sess], q_len, n, k, c["params"]["final_act"],
        ref.ROUNDINGS[c["program"]["compute_dtype"]], np.clip(got, 0, n - 1))
    numbers = compare.serve_numbers(served[sel].reshape(-1, k), ref_at, ref_best)
    if bad:
        numbers = {name: float("inf") for name in numbers}
    layer = None
    if region is not None:
        layer = {"kind": "serve", "region": region, "config": c, "traffic": t}
    return {"metrics": {"serve_p50_ms": stats.percentile(lat, 50) * 1e3,
                        "serve_p95_ms": stats.percentile(lat, 95) * 1e3,
                        "setup_s": run.setup_s()},
            "attempted": len(lat), "failed": bad, "memory_peak_bytes": peak,
            "numbers": numbers, "layer": layer,
            "info": {"calls": len(lat), "stream_calls": T, "checked_queries": len(q_len)}}
