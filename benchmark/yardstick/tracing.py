"""One profiled region of a run, read from ``torch.profiler``'s trace.

:func:`busy_ms` and :data:`HOST_LAUNCHES` are frozen copies of
``gru4rec_tpu_torch/utils/profiling.py``'s: the device's busy time is the
union of its operations' intervals, and a host launch is a CUDA API call
that puts work on a stream.

:func:`profile` runs a function under the profiler inside a span of the
benchmark's own (:data:`REGION`), with a device synchronisation at its
end, and returns a :class:`Region`: the device operations, the host's
launches and events, and any spans named :data:`CALL` inside it (one per
serving call). The chrome trace goes to a temporary file under ``TMPDIR``
that is deleted once read.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
from collections import defaultdict

REGION = "benchmark.region"
CALL = "benchmark.call"

# CUDA API calls (runtime and low-level) that issue work to a stream
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cuMemcpyAsync",
                 "cuMemsetD8Async", "cuMemsetD32Async", "cudaLaunchCooperativeKernel")

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_US = 2.0   # idle gaps shorter than this are summed, not attributed
LOOKBACK = 512       # host events searched back for the one running in a gap
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def busy_ms(ops) -> float:
    """Length of the union of the ops' [ts, ts + dur) intervals (us), in ms."""
    total, end = 0.0, -1.0
    for ts, dur in sorted((k["ts"], k["dur"]) for k in ops):
        if ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total / 1e3


def union(intervals):
    """The sorted, disjoint union of ``[(start, end), ...]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clipped_us(merged, lo: float, hi: float) -> float:
    """Length of the part of a disjoint union that lies in ``[lo, hi)``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def innermost_held(events, a: float, b: float) -> dict:
    """The time (us) of ``[a, b)`` in which each event was the innermost one
    running (the shortest of those running), by name, of ``events`` that
    start inside it, sorted by start."""
    cuts = sorted({a, b} | {min(b, t) for h in events for t in (h["ts"], h["ts"] + h["dur"])})
    held = defaultdict(float)
    running, j = [], 0  # a heap of (dur, index) of the events begun so far
    for lo, hi in zip(cuts, cuts[1:]):
        while j < len(events) and events[j]["ts"] <= lo:
            heapq.heappush(running, (events[j]["dur"], j))
            j += 1
        # an event that ends before hi ended by lo (its end is a cut)
        while running and events[running[0][1]]["ts"] + running[0][0] < hi:
            heapq.heappop(running)
        if running:
            held[events[running[0][1]]["name"]] += hi - lo
    return held


class Region:
    """The events of one profiled region (times in us, the trace's clock)."""

    def __init__(self, events):
        regions = [e for e in events if e.get("name") == REGION and "dur" in e]
        if not regions:
            raise RuntimeError("the trace holds no benchmark region")
        r = max(regions, key=lambda e: e["dur"])
        self.t0, self.t1 = float(r["ts"]), float(r["ts"] + r["dur"])

        def inside(e):
            return self.t0 <= e["ts"] < self.t1 and "dur" in e

        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and inside(e)]
        self.launches_by_name = defaultdict(int)
        for e in self.host:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in HOST_LAUNCHES:
                self.launches_by_name[e["name"]] += 1
        self.launches = sum(self.launches_by_name.values())
        self.calls = sorted((float(e["ts"]), float(e["ts"] + e["dur"]))
                            for e in events if e.get("name") == CALL and inside(e))
        self.merged = union((float(k["ts"]), float(k["ts"] + k["dur"])) for k in self.device)

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_ms(self.device) / 1e3

    def kernel_time_s(self, match) -> tuple:
        """(seconds, count) of the kernels whose name satisfies ``match``."""
        ks = [k for k in self.kernels if match(k["name"])]
        return sum(k["dur"] for k in ks) / 1e6, len(ks)

    def call_times(self):
        """[(wall s, device busy s)] of each :data:`CALL` span."""
        return [((b - a) / 1e6, clipped_us(self.merged, a, b) / 1e6) for a, b in self.calls]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device, each by the innermost host event that was
        running when the gap began. A gap that begins while no host event
        runs (the region's opening gap, before the program's first span)
        is split among the host events by the time each was the innermost
        one running in it; ``(no host event)`` keeps the time in which none
        ran."""
        by_op = defaultdict(float)
        for k in self.device:
            by_op[k["name"]] += k["dur"] / 1e6
        gaps = []
        last = self.t0
        for s, e in self.merged + [[self.t1, self.t1]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        by_host = defaultdict(float)
        host = sorted((h for h in self.host if h.get("name") != REGION),
                      key=lambda e: e["ts"])
        starts = [h["ts"] for h in host]
        for a, b in gaps:
            if b - a < SHORT_GAP_US:
                by_host[f"(gaps under {SHORT_GAP_US} us)"] += (b - a) / 1e6
                continue
            i = bisect.bisect_right(starts, a)
            running = [h for h in host[max(0, i - LOOKBACK):i] if a < h["ts"] + h["dur"]]
            if running:
                by_host[min(running, key=lambda h: h["dur"])["name"]] += (b - a) / 1e6
                continue
            held = innermost_held(host[i:bisect.bisect_left(starts, b)], a, b)
            held["(no host event)"] += (b - a) - sum(held.values())
            for name, us in held.items():
                if us > 0:
                    by_host[name] += us / 1e6

        def first(d):
            return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": first(by_op), "idle_gaps": first(by_host)}


def profile(fn) -> Region:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities) in a
    :data:`REGION` span that ends with a device synchronisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _profile(activities=activities) as prof:
        with record_function(REGION):
            fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Region(events)


def call_span():
    """A :data:`CALL` span around one call, for :meth:`Region.call_times`."""
    from torch.profiler import record_function

    return record_function(CALL)
