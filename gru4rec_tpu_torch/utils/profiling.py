"""What the port measures of itself: spans on the profiler's clock, per-epoch
pace counters kept in every run, and the reading of one ``torch.profiler``
trace.

* :func:`span`: a ``torch.profiler.record_function`` while a profiler
  records, else one shared null context (about 0.3 us a use on a CPU,
  against 10-16 us for an idle ``record_function``). The spans are
  host events (``user_annotation``) in the same trace as the kernels, so
  a gap of the device falls inside the span that was running. They open
  per call, per chunk and per phase; per step only around an item table's
  row update (``gru4rec.train.sparse_update.<table>``) and an evaluation
  step's eager full-catalog ranking (``gru4rec.evaluate.rank``), on eager
  steps and at a capture, never on a replay. Their names are listed in README.md.
* :class:`Pace`: one ``fit`` epoch's host seconds by phase, the stream
  time of its chunks' steps and the chunks whose device was behind the
  host, with no profiler (``epoch_stats`` and the JSONL ``epoch`` event).
* :func:`trace`: where a call's time goes on the card, from one trace: the
  launches the host issued, the device's busy time, and its operations.
  Used by the measurement scripts (``scripts/profile_torch_step.py``,
  ``scripts/profile_eval_torch.py``) and ``chip_smoke.py``. Traces only a
  CUDA device; the tracer drops records now and then, so counts from one
  window can fall short by a few.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` around a ``with`` block: a
    ``record_function`` while a profiler records, else a shared null
    context that costs next to nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


PACE_PHASES = ("sample", "upload", "issue", "nan_wait", "loss_sync")


class Pace:
    """One ``fit`` epoch's pace, counted with no profiler.

    ``host_s``: seconds of host wall time (``time.perf_counter``) in each
    of :data:`PACE_PHASES`: the chunks' negative draws, their uploads,
    their step loops (``issue``), the lagged NaN checks' waits and the
    epoch's loss read-back. On a CUDA device, besides, each chunk's step
    loop records a timing event before its first step and after its last
    (``device_s``: the sum of the stream times between each pair, read
    once the epoch's loss has synced; it includes any time the stream
    waited for the host, so it equals the device's busy time only while
    the launch queue stays non-empty), and an event before its last live
    step, queried once when the host leaves the loop: ``behind`` counts
    the chunks whose device had not reached that event, that is, was still
    more than a step behind the host. ``issue`` below ``device_s`` says the
    host ran ahead of the device; ``behind`` near 0 says the device kept up
    at the end of each chunk. Off a CUDA device both are None."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.host_s = dict.fromkeys(PACE_PHASES, 0.0)
        self.behind = 0
        self._pairs = []  # (start, end) timing events of each chunk's steps
        self._start = self._mark = None
        self._since = 0.0

    def add(self, phase: str, since: float) -> None:
        """Count the host time from ``since`` (``time.perf_counter``) to now."""
        self.host_s[phase] += time.perf_counter() - since

    def begin_steps(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._mark = None
        self._since = time.perf_counter()

    def before_last_step(self) -> None:
        if self.cuda:
            self._mark = torch.cuda.Event()
            self._mark.record()

    def end_steps(self) -> None:
        self.add("issue", self._since)
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pairs.append((self._start, end))
            if self._mark is not None and not self._mark.query():
                self.behind += 1

    def read(self) -> dict:
        """``{host_s, device_s, behind}``; on a CUDA device, after the
        epoch's work has synced."""
        device_s = None
        if self.cuda:
            device_s = sum(a.elapsed_time(b) for a, b in self._pairs) / 1e3
        return {"host_s": dict(self.host_s), "device_s": device_s,
                "behind": self.behind if self.cuda else None}

# CUDA API calls (runtime and low-level) that issue work to a stream
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cuMemcpyAsync",
                 "cuMemsetD8Async", "cuMemsetD32Async", "cudaLaunchCooperativeKernel")


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


def trace(fn, per: int, path=None) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities, a
    synchronisation at the end) and read its trace, per ``per`` units of
    work (steps or calls): ``host_launches`` (CUDA API calls that put work
    on a stream) and ``host_launches_by_call``, ``device_busy_ms`` (the
    union of kernels, copies and fills), ``kernels``, ``device_copies``,
    ``kernel_window_ms`` (first kernel start to last kernel end), and
    ``by_name``: {kernel name: [device ms, runs]}, largest first. ``path``
    keeps the chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        out = path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(out)
        with open(out) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")
              and "dur" in e]
    if not kernels:
        raise RuntimeError("the profiler recorded no CUDA kernel")
    launches = defaultdict(int)
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in HOST_LAUNCHES:
            launches[e["name"]] += 1
    by_name = defaultdict(lambda: [0.0, 0])
    for k in kernels:
        by_name[k["name"]][0] += k["dur"] / 1e3
        by_name[k["name"]][1] += 1
    window = max(k["ts"] + k["dur"] for k in kernels) - min(k["ts"] for k in kernels)
    return {
        "host_launches": sum(launches.values()) / per,
        "host_launches_by_call": {k: v / per for k, v in sorted(launches.items())},
        "device_busy_ms": busy_ms(kernels + copies) / per,
        "kernels": len(kernels) / per,
        "device_copies": len(copies) / per,
        "kernel_window_ms": window / 1e3 / per,
        "by_name": {n: [v[0] / per, v[1] / per]
                    for n, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])},
    }
