"""Run one cell of the benchmark once, on one NVIDIA GPU:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of stdout is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, then ``card`` (``nvidia-smi`` at the start
and just after the window) and ``info`` (what the job saw; ``cold_build``
is true in a run that built one of the program's libraries, whose
``setup_s`` holds the build), and last ``checks``: every number
compared, with its limit. The same numbers end stderr.

Exits non-zero and prints no result without a CUDA device (or with fewer
than the cell asks for), and when the process has loaded JAX, flax or the
JAX package by the end. Build and kernel caches stay inside the checkout:
the program's nvcc / g++ builds in ``gru4rec_tpu_torch/_build/``, any
Triton, PyTorch-extension or CUDA JIT cache under ``.bench_cache/``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

from benchmark import spec
from benchmark.jobs import common

FORBIDDEN = ("jax", "jaxlib", "flax", "gru4rec_tpu")


def process_start() -> float:
    """When this process started, on ``time.perf_counter``'s clock."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - age


def keep_caches_inside(root: str) -> None:
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def built(build_dir: str) -> set:
    """The program's libraries already built in the checkout."""
    if not os.path.isdir(build_dir):
        return set()
    return {f for f in os.listdir(build_dir) if f.endswith(".so")}


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``gru4rec_tpu_torch`` is not ``gru4rec_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def read_layer(cell, layer) -> dict:
    """Each per-layer metric of the cell that its reader finds in ``layer``."""
    out = {}
    for m in cell.per_layer:
        s = importlib.util.spec_from_file_location(f"benchmark_metric_{m['name']}",
                                                   spec.metric_path(m["name"]))
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        value = mod.read(layer) if layer is not None else None
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell, run) -> dict:
    job = importlib.import_module(f"benchmark.jobs.{cell.traffic['kind']}")
    return job.run(cell, run)


def result(cell, run, outcome, kind_name: str, extra=None) -> dict:
    """The result line from a job's outcome."""
    checks = {}
    for name, value in outcome["numbers"].items():
        if name not in cell.limits:
            raise KeyError(f"no limit for {name!r} in limits/{cell.name}.json")
        checks[name] = {"value": value, "limit": cell.limits[name]}
    correct = outcome["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    layer = outcome["layer"]
    if run.trace:
        metrics = read_layer(cell, layer)
    else:
        metrics = {}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome["metrics"][m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": kind_name, "count": cell.chips,
              "memory_peak_bytes": outcome["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device}
    if run.trace and layer is not None:
        region = layer["region"]
        device["busy_s"] = region.busy_s
        device["window_s"] = region.wall_s
        line["breakdown"] = region.breakdown()
    line.update(extra or {})
    line["info"] = dict(outcome["info"])
    if run.trace and layer is not None:
        line["info"]["launches_by_name"] = dict(layer["region"].launches_by_name)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    keep_caches_inside(spec.ROOT)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from gru4rec_tpu_torch.ops.kernels import build

    build.BUILD_DIR = os.path.join(spec.ROOT, "gru4rec_tpu_torch", "_build")
    libraries = built(build.BUILD_DIR)
    run = common.Run(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=device, t_start=t_start)
    before = common.card_state()
    outcome = execute(cell, run)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: the benchmark runs without JAX",
              file=sys.stderr)
        return 4
    new = sorted(built(build.BUILD_DIR) - libraries)
    outcome["info"].update(cold_build=bool(new), built=new)
    line = result(cell, run, outcome, torch.cuda.get_device_name(0),
                  {"card": {"before": before, "after_window": run.card_after}})
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
