"""Fresh-process runs of the port's benchmark harnesses, in turns, on the card.

    python3 scripts/bench_runs_torch.py [--runs 3] [--out chiprun_out/bench_runs]

Runs ``python -m gru4rec_tpu_torch.bench`` and ``python -m
gru4rec_tpu_torch.bench_scaling`` alternately, ``--runs`` times each, each
run a fresh process from the root of the checkout (so every bench run pays
its own epoch 1, and its children their own builds: the first run's fit also
builds the kernels into ``gru4rec_tpu_torch/_build/``). Prints the card's
``nvidia-smi`` name and power limit, one JSON line per run (the harness's
result lines and its ``{"fit": ...}`` records: per-epoch seconds and
events), and a summary per harness and width: every value, the median and
the spread ((max - min) / median). Each run's stderr goes to ``--out``.
Exits non-zero when a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
TIMEOUT = 1500  # seconds for one run


def _run(module, out_dir, tag):
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", module], capture_output=True, text=True,
                         timeout=TIMEOUT, cwd=ROOT)
    with open(os.path.join(out_dir, f"{tag}.stderr"), "w") as f:
        f.write(res.stderr)
    if res.returncode != 0:
        raise SystemExit(f"{tag}: exit {res.returncode}\n{res.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    fits = [json.loads(ln)["fit"] for ln in res.stderr.splitlines() if ln.startswith('{"fit"')]
    return {"run": tag, "lines": lines, "fits": [
        {k: f.get(k) for k in ("devices", "launches")} | {
            "epoch_seconds": [e["seconds"] for e in f["epochs"]],
            "epoch_events": [e["events"] for e in f["epochs"]]} for f in fits],
        "seconds": time.time() - t0}


def _summary(name, values):
    med = statistics.median(values)
    return {"summary": name, "values": values, "median": med,
            "spread": (max(values) - min(values)) / med}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "bench_runs"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line

    print(json.dumps({"nvidia_smi": nvidia_smi_line()}), flush=True)
    bench, scaling = [], {}
    for i in range(args.runs):
        rec = _run("gru4rec_tpu_torch.bench", args.out, f"bench{i}")
        print(json.dumps(rec), flush=True)
        bench.append(rec["lines"][-1])
        rec = _run("gru4rec_tpu_torch.bench_scaling", args.out, f"scaling{i}")
        print(json.dumps(rec), flush=True)
        for row in rec["lines"]:
            scaling.setdefault(row["devices"], []).append(row["value"])
    print(json.dumps(_summary("bench value", [b["value"] for b in bench])))
    for key in ("epoch1_warm_s", "epoch1_cold_s"):
        print(json.dumps(_summary(f"bench {key}", [b[key] for b in bench])))
    for d, values in sorted(scaling.items()):
        print(json.dumps(_summary(f"bench_scaling devices {d}", values)))
    print(json.dumps({"nvidia_smi": nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
