"""The measurement paths of the adagrad prototypes P1 and P2 on one card.

PyTorch counterparts of ``scripts/proto_merged_kernel.py`` (P1 "merged"
against "separate") and ``scripts/proto_v3_kernel.py`` (P2 "v3" against
"v2"), at those scripts' own shapes and index draws. The baseline of both
is the port's row-sparse kernel, ``sparse_update.fused_update`` with
adagrad, momentum 0, no L2 and a float32 accumulator. All four variants
are sort-free and one device operation per call: each kernel dedups the
raw indices itself in the same way (the head of a run sums its gradient
rows in ascending raw position). So "separate" against "merged" compares
only the two layouts (two rows against one contiguous ``[t | a]`` span),
and "v2" against "v3" only a grid over all K positions against a loop over
the real rows: the comparisons are like for like.
Each variant runs ``STEPS`` updates back to back on the stream (the card's
counterpart of the scripts' ``lax.scan``); a step is one wrapper call.
``us_per_step`` is the median over ``REPS`` runs of CUDA events around the
``STEPS`` steps; one more run under ``torch.profiler``, after a warm-up
run, gives the device time per call of the variant's one kernel
(``KERNEL_NAMES``), a mean over the launches the tracer recorded, and
raises if any other operation ran once per call.
Data is made on the card from a seeded ``torch.Generator`` (rees46's 64
gradient steps are 332 MB). A measurement needs a CUDA device and raises
without one.

Run through ``scripts/proto_merged_kernel_torch.py`` and
``scripts/proto_v3_kernel_torch.py``, or ``chip_smoke.py``'s ``proto``
phase; ``scripts/sparse_update_timing_torch.py --source proto_adagrad``
times the whole call of P1 and P2 in any checkout and in build variants.
``exact_adagrad`` gives the kernels' results bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from collections import defaultdict

import numpy as np
import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.models.gru4rec import resolve_device
from gru4rec_tpu_torch.ops.kernels import proto_adagrad, sparse_update
from gru4rec_tpu_torch.train.optimizers import make_optimizer

LR = 0.05
STEPS, REPS = 64, 6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
RTOL, ATOL = 1e-6, 1e-7    # the scripts' own tolerances

# (name, n_rows, d, K): scripts/proto_merged_kernel.py:123-126
MERGED_SHAPES = (("diginetica", 43136, 513, 2304), ("rees46", 200064, 513, 2544),
                 ("yoochoose", 37120, 481, 2144), ("retailrocket", 37120, 225, 2208))
# (name, n_rows, d, K, pool): scripts/proto_v3_kernel.py:252-255
V3_SHAPES = (("rees46", 200064, 513, 2528, 1500), ("diginetica", 43136, 513, 2304, 1800),
             ("yoochoose", 37120, 481, 2144, 1700),
             ("uniform-distinct", 200064, 513, 2528, 2500))

# the one device operation of each variant's call, by a substring of its
# name in the profiler's trace; every variant is sort-free, so the profiler
# must see no other operation once per call
KERNEL_NAMES = {"separate": ("sparse_update_kernel",), "v2": ("sparse_update_kernel",),
                "merged": ("merged_adagrad_kernel",), "v3": ("v3_adagrad_kernel",)}
SORT_FREE = tuple(KERNEL_NAMES)  # whose trace must hold KERNEL_NAMES alone


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def adagrad_optimizer():
    """The baseline's optimizer: adagrad, momentum 0, no L2, f32 state."""
    return make_optimizer(GRU4RecConfig(adapt="adagrad", momentum=0.0, lmbd=0.0,
                                        learning_rate=LR, opt_state_dtype="float32"))


def draw(n_rows, d, K, pool=None, steps=STEPS, seed=0, acc_floor=0.0):
    """On the card: ``steps`` index sets (K, int32, below ``n_rows - 8``:
    uniform as in P1's script, or from a ``pool`` of distinct rows as in
    P2's), gradient rows N(0, 0.01^2), table N(0, 1), accumulator
    |N(0, 1)| + ``acc_floor``."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if pool is None:
        idx = torch.randint(0, n_rows - 8, (steps, K), generator=gen, device=dev)
    else:
        rows = torch.randperm(n_rows - 8, generator=gen, device=dev)[:pool]
        idx = rows[torch.randint(0, pool, (steps, K), generator=gen, device=dev)]
    g = torch.randn((steps, K, d), generator=gen, device=dev) * 0.01
    table = torch.randn((n_rows, d), generator=gen, device=dev)
    acc = torch.randn((n_rows, d), generator=gen, device=dev).abs() + acc_floor
    return idx.to(torch.int32), g, table, acc


def distinct_rows(idx, n_rows):
    """Distinct real rows of each index set (rows of ``idx``), as a list."""
    s = torch.sort(torch.where((idx >= 0) & (idx < n_rows), idx.long(), -1), dim=1).values
    heads = torch.ones_like(s, dtype=torch.bool)
    heads[:, 1:] = s[:, 1:] != s[:, :-1]
    return ((heads & (s >= 0)).sum(dim=1)).tolist()


def bound_us(K, d, distinct):
    """Least time for one update, by bytes: K indices and K gradient rows
    read once, each distinct row's table and accumulator row read and
    written once (16 d bytes), over the card's memory rate; the mean over
    the index sets ``distinct`` counts."""
    nbytes = K * 4 + K * d * 4 + float(np.mean(distinct)) * 16 * d
    return nbytes / HBM_BYTES_PER_S * 1e6, nbytes


def steps_us(step, steps=STEPS, reps=REPS):
    """Median over ``reps`` of CUDA-event time per step of ``step(s)`` run
    for s in range(steps) back to back, after one warm-up run."""
    times = []
    for r in range(reps + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for s in range(steps):
            step(s)
        b.record()
        b.synchronize()
        if r:
            times.append(a.elapsed_time(b) * 1e3 / steps)
    return float(np.median(times))


def device_times(step, steps=STEPS, tries=4, names=None):
    """{kernel name: [device us, launches]} of one run of ``steps`` steps
    under ``torch.profiler``, after a warm-up run of the same steps whose
    records are dropped. The tracer loses records now and then: on the
    card it kept 55 of 64 calls in one window and none in another
    (PERF.md). So a window whose most frequent operation it recorded fewer
    than ``steps - steps // 16`` times is traced again, up to ``tries``
    windows; the last one is returned, and if no window recorded a kernel
    this raises. It also once recorded 69 launches of a kernel called 64
    times: with ``names`` (the operations that run once per step, as
    :func:`kernel_us` takes them) a window is traced again unless it
    recorded each of them ``steps`` -/+ ``steps // 16`` times."""
    slack = steps // 16

    def whole(times):
        if names is None:
            return max(v[1] for v in times.values()) >= steps - slack
        return all(abs(sum(v[1] for k, v in times.items() if n in k) - steps) <= slack
                   for n in names)

    for _ in range(tries):
        times = _window(step, steps)
        if times and whole(times):
            break
    if not times:
        raise RuntimeError(f"the profiler recorded no CUDA kernel in {tries} windows")
    return times


def _window(step, steps):
    """{kernel name: [device us, launches]} of one traced window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for _ in range(2):  # warm-up, then the recorded run
                for s in range(steps):
                    step(s)
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memset") and "dur" in e:
            by_name[e["name"]][0] += float(e["dur"])
            by_name[e["name"]][1] += 1
    return dict(by_name)


def ops_per_call(times, launches):
    """The distinct device operations that the profiler saw at least once
    per call (``launches`` less ``launches // 16``, for dropped records)."""
    return sum(v[1] >= launches - launches // 16 for v in times.values())


def kernel_us(times, names, launches, exclusive=False):
    """Device us per launch of a wrapper's own operations: the sum over
    ``names`` of the mean time of the operations whose names contain it.
    Each must have run once per launch: raises if the profiler saw one of
    them outside ``launches`` -/+ ``launches // 16`` times, which allows
    for a record the tracer dropped and catches an operation that ran
    twice per launch or not at all. ``exclusive``: also raises if an
    operation that ``names`` does not list ran once per launch, so the sum
    is the whole call's device time."""
    slack = launches // 16
    if exclusive:
        other = [k for k, v in times.items()
                 if v[1] >= launches - slack and not any(n in k for n in names)]
        if other:
            raise RuntimeError(f"operations besides {names} ran once per call: {other}")
    us = 0.0
    for name in names:
        hits = [v for k, v in times.items() if name in k]
        n = sum(v[1] for v in hits)
        if not n or abs(n - launches) > slack:
            raise RuntimeError(f"{name}: the profiler saw {n} launches, expected "
                               f"{launches}; the trace holds {sorted(times)}")
        us += sum(v[0] for v in hits) / n
    return us


def exact_adagrad(table, acc, idx, g, lr=LR):
    """What P1 and P2 compute, bit for bit, in numpy float32: new (table,
    acc) arrays after one update of the numpy arrays given. Each distinct
    real row's gradient rows are summed from 0 in ascending raw position
    (``np.add.at``), then ``a += g * g; t -= lr * (g / sqrt(a + eps))``,
    each operation rounded once and the square root correctly, as the
    kernels' ``sqrtf`` is. PyTorch's CPU float32 ``sqrt`` need not be
    correctly rounded, so the torch-op plain versions may differ from this
    in the last bit of the table (never of the accumulator)."""
    t, a = table.copy(), acc.copy()
    idx = np.asarray(idx).astype(np.int64)
    keep = (idx >= 0) & (idx < t.shape[0])
    rows, inv = np.unique(idx[keep], return_inverse=True)
    gs = np.zeros((rows.size, t.shape[1]), np.float32)
    np.add.at(gs, inv, g[keep])
    an = a[rows] + gs * gs
    t[rows] = t[rows] - np.float32(lr) * (gs / np.sqrt(an + np.float32(sparse_update.EPSILON)))
    a[rows] = an
    return t, a


def assert_close(name, got, want):
    """The scripts' check: rtol 1e-6 / atol 1e-7; returns the max abs error."""
    err = (got - want).abs()
    bad = int((err > ATOL + RTOL * want.abs()).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} elements beyond rtol {RTOL} / atol {ATOL}, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def record(head, variant, step, distinct, d, card):
    """``head`` (the script's keys before ``variant``) plus this variant's
    times, its bound and the card: ``kernel_us_per_launch`` is the device
    time of the whole call, the variant's one kernel (``KERNEL_NAMES``;
    ``kernel_us`` raises if any other operation ran once per call),
    ``ops_per_call`` counts the distinct operations of a step (1),
    ``ops_us_per_step`` gives each by name."""
    times = device_times(step, names=KERNEL_NAMES[variant])
    bus, nbytes = bound_us(head["K"], d, distinct)
    return {**head, "variant": variant, "us_per_step": steps_us(step),
            "kernel_us_per_launch": kernel_us(times, KERNEL_NAMES[variant], STEPS,
                                              exclusive=variant in SORT_FREE),
            "ops_per_call": ops_per_call(times, STEPS),
            "device_us_per_step": sum(v[0] for v in times.values()) / STEPS,
            "ops_us_per_step": {k[:60]: v[0] / STEPS for k, v in times.items()},
            "ops_launches": {k[:60]: v[1] for k, v in times.items()},
            "bound_us": bus, "bytes": nbytes, "card": card}


def v3_layout(K, d, distinct):
    """P2's launch at K positions and width ``d`` on this card: its grid
    capacity ``v3_grid``, the raw positions per block ``v3_tile``, the
    blocks launched, and the mean distinct rows (``distinct``) per block
    and per warp."""
    grid = proto_adagrad.persistent_grid(torch.cuda.current_device(), d)
    tile = proto_adagrad.v3_tile(K, grid)
    blocks = -(-K // tile)
    rows = float(np.mean(distinct))
    return {"v3_grid": grid, "v3_tile": tile, "v3_blocks": blocks,
            "v3_items_per_block": rows / blocks,
            "v3_items_per_warp": rows / (blocks * proto_adagrad.v3_warps())}


def measure_merged(name, n_rows, d, K, card):
    """P1's path: "separate" (table and acc, the port's row-sparse kernel)
    and "merged" (P1 on the [t | a] buffer) on the same draw; one step of
    each checked against the other first. Returns the two records."""
    idx, g, table, acc = draw(n_rows, d, K)
    opt = adagrad_optimizer()
    t_s, a_s = table.clone(), acc.clone()
    merged = torch.cat([table, acc], dim=1)
    sparse_update.fused_update(opt, t_s, idx[0], g[0], {"acc": a_s})
    proto_adagrad.merged_adagrad(merged, idx[0], g[0], LR)
    assert_close("merged table", merged[:, :d], t_s)
    assert_close("merged acc", merged[:, d:], a_s)

    distinct = distinct_rows(idx, n_rows)
    head = {"shape": f"{n_rows}x{d}", "K": K, "dataset": name}
    st = {"acc": a_s}
    return [
        record(head, "separate",
                lambda s: sparse_update.fused_update(opt, t_s, idx[s], g[s], st),
                distinct, d, card),
        record(head, "merged",
                lambda s: proto_adagrad.merged_adagrad(merged, idx[s], g[s], LR),
                distinct, d, card),
    ]


def measure_v3(name, n_rows, d, K, pool, card):
    """P2's path: "v2" (the port's row-sparse kernel) and "v3" (P2) on the
    same pooled draw; two steps of each checked against the other first.
    Returns the two records."""
    idx, g, table, acc = draw(n_rows, d, K, pool=pool, acc_floor=0.1)
    opt = adagrad_optimizer()
    t2, a2, t3, a3 = table.clone(), acc.clone(), table, acc
    st = {"acc": a2}
    for s in range(2):
        sparse_update.fused_update(opt, t2, idx[s], g[s], st)
        proto_adagrad.v3_adagrad(t3, a3, idx[s], g[s], LR)
    assert_close("v3 table", t3, t2)
    assert_close("v3 acc", a3, a2)

    distinct = distinct_rows(idx, n_rows)
    head = {"shape": name, "K": K, "pool": pool, "n_rows": n_rows, "d": d,
            **v3_layout(K, d, distinct)}
    return [
        record(head, "v2",
                lambda s: sparse_update.fused_update(opt, t2, idx[s], g[s], st),
                distinct, d, card),
        record(head, "v3",
                lambda s: proto_adagrad.v3_adagrad(t3, a3, idx[s], g[s], LR),
                distinct, d, card),
    ]
