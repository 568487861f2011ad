"""Device time per call of the row-sparse kernels, and of build variants of them.

Times one checkout's wrappers of one CUDA source on one CUDA device: 64
back-to-back calls on distinct index sets, under ``torch.profiler`` after a
warm-up run.

* ``--source sparse_update`` (the default): ``sparse_update.fused_update``
  at the shapes of ``chip_smoke.py``'s ``kernel_timing`` (K1, K2, K3 and K1
  on the one-hot ``Wy`` at their main paths' settings, K4 on the one-hot
  ``Wx0``);
* ``--source proto_adagrad``: the adagrad prototypes
  ``proto_adagrad.merged_adagrad`` (P1) and ``proto_adagrad.v3_adagrad``
  (P2) at the measurement scripts' shapes (``proto_measure.MERGED_SHAPES``
  for P1, ``V3_SHAPES`` and RetailRocket for P2, the scripts' own draws);
  ``--only P1`` or ``--only P2`` times one of them.

Prints the card's ``nvidia-smi`` line, then one JSON line per round and
build: for each shape ``call_us``, the device time of every operation the
wrapper issues per call (the mean over the launches the tracer recorded of
each operation it saw once per call: a sort feed, a fill, a memset and
kernels alike), ``kernel_us``, the source's own kernels alone, ``step_us``,
the wrapper's time per call (CUDA events, median of 6 runs), and ``ops``,
the records per operation name.

``--root`` names the checkout whose package (and ``chip_smoke.py``) is
imported (default: this script's), so the same script times a parent commit
unpacked elsewhere. ``--variants FILE`` names a JSON object
{name: [[old, new], ...]} of builds of the source to time in turns, each the
checkout's source with those text substitutions, compiled with the
package's ``nvcc`` flags and swapped in for the built library. Variants are
for measurement only: an ablation may compute wrong results, and none is
checked here. ``scripts/sparse_update_variants.json`` and
``scripts/proto_adagrad_variants.json`` hold the design alternatives and
ablations that PERF.md reports. Needs one CUDA device:

    python3 scripts/sparse_update_timing_torch.py --rounds 2
    python3 scripts/sparse_update_timing_torch.py --source proto_adagrad --rounds 2 \
        --variants scripts/proto_adagrad_variants.json
    python3 /path/to/this/scripts/sparse_update_timing_torch.py \
        --root /path/to/parent/checkout --label parent
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

# each source's own kernels, by a substring of their names in the trace; the
# first P2 design's record kernel and memset count as P2's own
KERNELS = {"K": ("sparse_update_kernel",), "P1": ("merged_adagrad_kernel",),
           "P2": ("v3_adagrad_kernel", "v3_items_kernel", "Memset")}


def build_variants(build, source, path):
    """{name: loaded library} of the variants of ``csrc/<source>.cu`` in
    the JSON file ``path``, one ``nvcc`` process each, all started
    together."""
    with open(path) as f:
        variants = json.load(f)
    with open(os.path.join(build.CSRC_DIR, source + ".cu")) as f:
        text = f.read()
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            src = src.replace(old, new)
        stem = os.path.join(tmp, f"v{len(procs)}")
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[name] = (stem + ".so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def sparse_update_calls(pm):
    """{shape: (kernel names, call(s))} of K1-K4 at ``kernel_timing``'s shapes."""
    import numpy as np
    import torch

    import chip_smoke as c
    from gru4rec_tpu_torch.models.gru import pad_cols, pad_items
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    rng = np.random.RandomState(0)
    steps = pm.STEPS
    n_rows, d = pad_items(c.N_ITEMS, 128), pad_cols(224 + 1)
    rsc = pad_items(c.RSC15_ITEMS, 128)
    flagship = c._index_sets(rng, c.N_ITEMS, 2 * 80 + 2048, 80, steps)
    onehot = np.stack([c._lane_set(rng, c.RSC15_ITEMS, 32) for _ in range(steps)])
    wy = np.stack([np.concatenate([c._lane_set(rng, c.RSC15_ITEMS, 32),
                                   rng.randint(0, c.RSC15_ITEMS, 2048).astype(np.int32)])
                   for _ in range(steps)])
    shapes = {"K1": ("adagrad", 0.4, "bfloat16", n_rows, d, flagship),
              "K2": ("adagrad", 0.4, "bfloat16_sr", n_rows, d, flagship),
              "K3": ("adam", 0.4, "bfloat16_sr", n_rows, d, flagship),
              "K4": ("adagrad", 0.3, "bfloat16", rsc, 300, onehot),
              "K1 onehot Wy": ("adagrad", 0.3, "bfloat16", rsc, 128, wy)}
    calls = {}
    for key, (adapt, momentum, sd, rows, width, sets) in shapes.items():
        opt, table, _, _, st = c._make_case(adapt, momentum, 0.0, sd, rows, width, sets[0],
                                            seed=99)
        idxs = torch.from_numpy(sets).to(c.DEVICE)
        gen = torch.Generator(device=c.DEVICE)
        gen.manual_seed(7)
        gs = torch.randn((steps, sets.shape[1], width), generator=gen, device=c.DEVICE) * 0.1
        sr = c.SR_SEED if opt.sr_active(st) else None
        calls[key] = (KERNELS["K"], (
            lambda opt, table, st, idxs, gs, sr: lambda s: sparse_update.fused_update(
                opt, table, idxs[s], gs[s], st, sr_seed=sr))(opt, table, st, idxs, gs, sr))
    return calls


def proto_adagrad_calls(pm, only):
    """{"P1 <shape>" / "P2 <shape>": (kernel names, call(s))} at the
    measurement scripts' shapes."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import proto_adagrad

    shapes = {"P1": [(name, n, d, K, None) for name, n, d, K in pm.MERGED_SHAPES],
              "P2": list(pm.V3_SHAPES) + [("retailrocket", 37120, 225, 2208, None)]}
    calls = {}
    for kernel, rows in shapes.items():
        if only and kernel != only:
            continue
        for name, n, d, K, pool in rows:
            idx, g, table, acc = pm.draw(n, d, K, pool=pool, acc_floor=0.1 if pool else 0.0)
            if kernel == "P1":
                merged = torch.cat([table, acc], dim=1)
                del table, acc
                call = (lambda m, idx, g: lambda s: proto_adagrad.merged_adagrad(
                    m, idx[s], g[s], pm.LR))(merged, idx, g)
            else:
                call = (lambda t, a, idx, g: lambda s: proto_adagrad.v3_adagrad(
                    t, a, idx[s], g[s], pm.LR))(table, acc, idx, g)
            shape = f"{kernel} {name} {n}x{d} K={K}" + (f" pool={pool}" if pool else "")
            calls[shape] = (KERNELS[kernel], call)
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--source", choices=("sparse_update", "proto_adagrad"),
                    default="sparse_update")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", choices=("P1", "P2"), default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from gru4rec_tpu_torch.ops.kernels import build, proto_adagrad, proto_measure as pm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build.build([args.source])
    builds = {args.label: build.load(args.source)}
    if args.variants:
        builds = build_variants(build, args.source, args.variants)  # the variants alone
    calls = (sparse_update_calls(pm) if args.source == "sparse_update"
             else proto_adagrad_calls(pm, args.only))

    card = pm.nvidia_smi_line()
    print(card, flush=True)
    for rnd in range(args.rounds):
        for name, lib in builds.items():
            build._LIBS[args.source] = lib
            if hasattr(proto_adagrad, "persistent_grid"):
                proto_adagrad.persistent_grid.cache_clear()  # a variant may size it anew
            row = {"build": name, "round": rnd, "card": card}
            for shape, (names, call) in calls.items():
                times = pm.device_times(call)
                own = [v for k, v in times.items() if any(n in k for n in names)]
                per_call = [v for v in times.values() if v[1] >= pm.STEPS - pm.STEPS // 16]
                row[shape] = {"call_us": sum(v[0] / v[1] for v in per_call),
                              "kernel_us": sum(v[0] / v[1] for v in own),
                              "step_us": pm.steps_us(call),
                              "ops": {k[:60]: v[1] for k, v in times.items()}}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
