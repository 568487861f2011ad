"""Where a call's time goes on the card, from one ``torch.profiler`` trace:
the launches the host issued, the device's busy time, and its operations.

Used by the measurement scripts (``scripts/profile_torch_step.py``,
``scripts/profile_torch_serving.py``, ``scripts/profile_eval_torch.py``)
and ``chip_smoke.py``. Traces only a CUDA device; the tracer drops records
now and then, so counts from one window can fall short by a few.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

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
    import torch
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
