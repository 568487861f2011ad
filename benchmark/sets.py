"""Runs of cells, one process each in turn, and the spread of their metrics:

    python3 -m benchmark.sets --out <file.jsonl> [--seconds 51] [--trace 1] \\
        <cell>:<seed>[,<seed>...] [<cell>:<seed>...]

Each run is ``python3 -m benchmark.run`` in a process of its own; its exit
code, wall seconds, result line and the end of its stderr are appended to
``--out``. At the end, for each cell and metric: the values in run order,
the median, and the spread (the distance between the first and third
quartiles of ``statistics.quantiles(values, n=4)`` over the median), and
every compared number's largest reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from benchmark import spec

TIMEOUT_S = 1500  # a first run in a checkout builds the kernels


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, default=spec.load_spec()["run_seconds"])
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("runs", nargs="+", help="<cell>:<seed>[,<seed>...]")
    args = p.parse_args(argv)
    plan = [(cell, int(seed)) for run in args.runs
            for cell, seeds in [run.split(":")] for seed in seeds.split(",")]
    lines = {}
    with open(args.out, "a") as out:
        for cell, seed in plan:
            cmd = [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                   str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t0 = time.time()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S)
                rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
            except subprocess.TimeoutExpired as e:
                rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
                stdout = stdout if isinstance(stdout, str) else stdout.decode()
                stderr = stderr if isinstance(stderr, str) else stderr.decode()
            wall = time.time() - t0
            line = None
            if stdout.strip():
                try:
                    line = json.loads(stdout.strip().splitlines()[-1])
                except json.JSONDecodeError:
                    line = None
            rec = {"cell": cell, "seed": seed, "trace": args.trace, "rc": rc,
                   "wall_s": wall, "result": line, "stderr_tail": stderr[-3000:]}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            brief = {k: (v["value"] if isinstance(v, dict) else v)
                     for k, v in ((line or {}).get("metrics") or {}).items()}
            print(json.dumps({"cell": cell, "seed": seed, "rc": rc, "wall_s": round(wall, 1),
                              "correct": (line or {}).get("correct"), "metrics": brief,
                              "checks": {k: v["value"] for k, v in
                                         ((line or {}).get("checks") or {}).items()}}),
                  flush=True)
            if line is None:
                print(stderr[-2000:], flush=True)
            lines.setdefault(cell, []).append(line)
    for cell, results in lines.items():
        ok = [r for r in results if r]
        names = sorted({m for r in ok for m in r["metrics"]})
        summary = {"cell": cell, "runs": len(results), "correct": sum(bool(r["correct"]) for r in ok)}
        for m in names:
            vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
            summary[m] = {"values": vals, "median": statistics.median(vals), "spread": spread(vals)}
        for c in sorted({c for r in ok for c in r["checks"]}):
            summary["max_" + c] = max(r["checks"][c]["value"] for r in ok if c in r["checks"])
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
