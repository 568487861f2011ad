"""Device time per call of the row-sparse update, and of build variants of it.

Times ``sparse_update.fused_update`` of one checkout on one CUDA device at
the shapes of ``chip_smoke.py``'s ``kernel_timing`` (K1, K2, K3 and K1 on
the one-hot ``Wy`` at their main paths' settings, K4 on the one-hot
``Wx0``): 64 back-to-back calls on distinct index sets, under
``torch.profiler`` after a warm-up run. Prints one JSON line per round and
build: for each shape ``call_us``, the device time of every operation the
wrapper issues per call (each operation's mean over the launches the tracer
recorded), ``kernel_us``, the row-sparse kernel's alone, and ``ops``, the
records per operation name.

``--root`` names the checkout whose package and ``chip_smoke.py`` are
imported (default: this script's), so the same script times a parent
commit unpacked elsewhere. ``--variants FILE`` names a JSON object
{name: [[old, new], ...]} of builds of ``csrc/sparse_update.cu`` to time
in turns, each the checkout's source with those text substitutions,
compiled with the package's ``nvcc`` flags and swapped in for the built
library. Variants
are for measurement only: an ablation may compute wrong results, and none
is checked here. ``scripts/sparse_update_variants.json`` holds the design
alternatives and ablations that PERF.md reports. Needs one CUDA device:

    python3 scripts/sparse_update_timing_torch.py --rounds 2
    python3 scripts/sparse_update_timing_torch.py --rounds 3 \
        --variants scripts/sparse_update_variants.json
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    import chip_smoke as c
    from gru4rec_tpu_torch.models.gru import pad_cols, pad_items
    from gru4rec_tpu_torch.ops.kernels import build, proto_measure as pm, sparse_update

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    build.build()
    builds = {args.label: build.load("sparse_update")}
    if args.variants:
        with open(args.variants) as f:
            variants = json.load(f)
        src_path = os.path.join(build.CSRC_DIR, "sparse_update.cu")
        tmp = tempfile.mkdtemp()
        procs = {}
        with open(src_path) as f:
            source = f.read()
        for name, subs in variants.items():
            src = source
            for old, new in subs:
                if old not in src:
                    raise SystemExit(f"{name}: {old!r} is not in the source")
                src = src.replace(old, new)
            cu, so = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
            with open(cu, "w") as f:
                f.write(src)
            procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                                                stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
        builds = {}  # the variants alone, each built like the package
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {name}:\n{log}")
            builds[name] = ctypes.CDLL(so)

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
        calls[key] = (lambda opt, table, st, idxs, gs, sr: lambda s: sparse_update.fused_update(
            opt, table, idxs[s], gs[s], st, sr_seed=sr))(opt, table, st, idxs, gs, sr)

    card = pm.nvidia_smi_line()
    for rnd in range(args.rounds):
        for name, lib in builds.items():
            build._LIBS["sparse_update"] = lib
            row = {"build": name, "round": rnd, "card": card}
            for key, call in calls.items():
                times = pm.device_times(call)
                kernel = [v for k, v in times.items() if "sparse_update_kernel" in k]
                row[key] = {"call_us": sum(v[0] / v[1] for v in times.values()),
                            "kernel_us": kernel[0][0] / kernel[0][1] if kernel else None,
                            "ops": {k[:60]: v[1] for k, v in times.items()}}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
