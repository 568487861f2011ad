"""Device-memory budget of the port's training state, and the largest catalog that trains on one card.

PyTorch counterpart of ``scripts/measure_hbm_budget.py``, at its
configuration: GRU-512, batch 240, 2048 negatives, cross-entropy with a
softmax head and logq, constrained embedding, chunks of 64 steps; adagrad
and adam, each with ``opt_state_dtype`` float32, bfloat16 and
bfloat16_sr. The case for ``bfloat16_sr`` is memory: it stores the
freeze-prone state slots in bfloat16 and so should raise the largest
catalog that trains on one card. Three modes:

  table      per (adapt, opt_state_dtype): bytes of the parameters and
             the optimizer state per item and fixed, the slope between the
             port's real initialised ``TrainState`` at two small catalogs
             on the CPU (the layout is linear in the catalog); the run's
             per-item buffers (alias table, logp0) beside them; and the
             fixed buffers of a captured step, read from one ``try`` at the
             smaller catalog on the card: the step graph's pool and the
             capture stream's cuBLAS workspace ("not measured" without a
             card).
  try N A D  on the card: the training state for ``n_items=N``,
             ``adapt=A``, ``opt_state_dtype=D`` allocated there (zeros in
             the real layout: only the footprint decides), one chunk of 64
             steps through the captured step; prints one JSON line with
             ``ok`` / ``oom``, ``torch.cuda.max_memory_reserved``, the
             pool's and the workspace's bytes.
  boundary [A ...]
             per (adapt, opt_state_dtype), ``try`` subprocesses up a x1.25
             ladder of catalogs from 80% of the table's prediction for the
             card's memory (``nvidia-smi``) until one fails, then two
             halvings of that last bracket; prints the largest passing and
             the smallest failing catalog. Each probe is
             a process of its own, so one that runs out of memory leaves
             the next a clean card.

    python3 scripts/measure_hbm_budget_torch.py table
    python3 scripts/measure_hbm_budget_torch.py try 1000000 adam bfloat16_sr
    python3 scripts/measure_hbm_budget_torch.py boundary [adagrad|adam ...]

Every line carries the card's ``nvidia-smi`` name and power limit where
one is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

HIDDEN = 512
BATCH = 240        # the rees46 published batch
N_SAMPLE = 2048
CHUNK = 64
ADAPTS = ("adagrad", "adam")
DTYPES = ("float32", "bfloat16", "bfloat16_sr")
TABLE_ITEMS = (16_000, 48_000)  # the two catalogs of the slope
LADDER = 1.25
BISECT_STEPS = 2   # halvings of the ladder's last bracket (x1.25 -> about x1.06)
TRY_TIMEOUT = 600  # seconds for one probe
# A catalog for the shapes of a probe's state: its padded row count is no
# other dimension of the state, so the item-dimensioned leaves are the
# ones with this many rows.
DECOY_ITEMS = 3307


def make_cfg(n_items, adapt, osd):
    from gru4rec_tpu_torch.config import GRU4RecConfig

    return GRU4RecConfig(
        loss="cross-entropy", final_act="softmax", layers=[HIDDEN],
        batch_size=BATCH, n_sample=N_SAMPLE, sample_alpha=0.5, logq=1.0,
        learning_rate=0.05, adapt=adapt, constrained_embedding=True,
        chunk_size=CHUNK, opt_state_dtype=osd,
        dropout_p_embed=0.0, dropout_p_hidden=0.0,
    )


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_bytes(tree) -> int:
    from gru4rec_tpu_torch.utils.cuda_graph import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def state_bytes(n_items, adapt, osd):
    """(parameter bytes, optimizer-state bytes) of the port's real
    initialised training state at this catalog, on the CPU."""
    from gru4rec_tpu_torch.train.step import init_train_state

    st = init_train_state(make_cfg(n_items, adapt, osd), n_items, "cpu")
    return tree_bytes(st.params), tree_bytes(st.opt_state)


def uniform_alias_table(n_items: int) -> np.ndarray:
    """``ops/sampling.py::build_alias_table`` of a uniform popularity (any
    alpha): acceptance 1.0 and every item its own alias. The same array
    without Vose's host loop, which takes seconds at tens of millions of
    items; the footprint is what a probe needs."""
    return np.stack([np.ones(n_items, np.float32).view(np.int32),
                     np.arange(n_items, dtype=np.int32)], axis=1)


def run_bytes(n_items: int) -> int:
    """The run's catalog-sized buffers besides the state: the alias table
    and ``logp0`` (one float per padded row)."""
    from gru4rec_tpu_torch.models.gru import pad_items

    n_pad = pad_items(n_items, make_cfg(n_items, "adagrad", "float32").item_pad_multiple)
    return uniform_alias_table(n_items).nbytes + 4 * n_pad


def smi_line():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def card_memory_bytes():
    """The card's memory from ``nvidia-smi`` (MiB), without a CUDA context
    in this process; None without a card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.total",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return int(out.stdout.split()[0]) * 2**20


def slopes(adapt, osd, items=None):
    """Bytes per item and fixed bytes of the parameters, the optimizer
    state and the run's buffers, from two real catalogs (``TABLE_ITEMS``
    unless ``items`` names others)."""
    a, b = items or TABLE_ITEMS
    (pa, oa), (pb, ob) = state_bytes(a, adapt, osd), state_bytes(b, adapt, osd)
    ra, rb = run_bytes(a), run_bytes(b)
    p_slope, o_slope, r_slope = ((y - x) / (b - a) for x, y in ((pa, pb), (oa, ob), (ra, rb)))
    return {"param_bytes_per_item": p_slope, "opt_bytes_per_item": o_slope,
            "run_bytes_per_item": r_slope,
            "total_bytes_per_item": p_slope + o_slope + r_slope,
            "param_fixed_bytes": pa - p_slope * a, "opt_fixed_bytes": oa - o_slope * a,
            "run_fixed_bytes": ra - r_slope * a}


def probe(n_items, adapt, osd):
    """One ``try`` subprocess: its JSON record, or an ``error`` record when
    it printed none (a crash or a timeout)."""
    cmd = [sys.executable, os.path.abspath(__file__), "try", str(n_items), adapt, osd]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=TRY_TIMEOUT)
    except subprocess.TimeoutExpired:
        return {"result": "error", "n_items": n_items, "adapt": adapt,
                "opt_state_dtype": osd, "detail": f"timed out after {TRY_TIMEOUT} s"}
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        return {"result": "error", "n_items": n_items, "adapt": adapt,
                "opt_state_dtype": osd, "detail": out.stderr[-400:]}
    return json.loads(lines[-1])


def table():
    """One JSON line per (adapt, opt_state_dtype); the fixed buffers of a
    captured step from a probe on the card, or "not measured"."""
    card = smi_line()
    fixed = {"graph_pool_bytes": "not measured", "capture_workspace_bytes": "not measured"}
    if card is not None:
        rec = probe(TABLE_ITEMS[0], "adagrad", "float32")
        if rec["result"] != "ok":
            raise RuntimeError(f"the probe of the fixed buffers failed: {rec}")
        fixed = {"graph_pool_bytes": rec["pool_bytes"],
                 "capture_workspace_bytes": rec["workspace_bytes"]}
    memory = card_memory_bytes()
    rows = []
    for adapt in ADAPTS:
        for osd in DTYPES:
            s = slopes(adapt, osd)
            fixed_bytes = s["param_fixed_bytes"] + s["opt_fixed_bytes"] + s["run_fixed_bytes"]
            row = {"adapt": adapt, "opt_state_dtype": osd, "hidden": HIDDEN, "batch": BATCH,
                   **s, **fixed,
                   "rees46_200k_bytes": s["total_bytes_per_item"] * 200_000 + fixed_bytes}
            if memory is not None and card is not None:
                # the state and the run's buffers alone: activations, the
                # allocator's slack and the CUDA context are not in it
                room = memory - fixed_bytes - fixed["graph_pool_bytes"] \
                    - fixed["capture_workspace_bytes"]
                row["card_memory_bytes"] = memory
                row["predicted_max_items"] = int(room / s["total_bytes_per_item"])
            row["card"] = card
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def workspace_bytes(dev) -> int:
    """The device bytes that the first matrix products on the capture
    stream leave allocated: the workspaces cuBLAS and cuBLASLt keep for
    that stream for the life of the process. Read in a fresh process, the
    same products having run on the default stream first (a product, and
    one with a bias, in float32 and bfloat16: the kinds a step runs)."""
    import torch

    from gru4rec_tpu_torch.utils.cuda_graph import capture_stream, run_on

    a = torch.ones(256, 256, device=dev)
    b = torch.ones(256, device=dev)

    def products():
        for dt in (torch.float32, torch.bfloat16):
            x, bias = a.to(dt), b.to(dt)
            (x @ x).sum()
            torch.addmm(bias, x, x).sum()

    products()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    run_on(capture_stream(dev), products)
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev) - before


def zeros_state(cfg, n_items, dev):
    """A training state in the real layout for ``n_items``, allocated on
    ``dev`` as zeros: the shapes and dtypes of a real initialisation at
    ``DECOY_ITEMS``, every item-dimensioned leaf grown to the catalog's
    padded rows (a real initialisation at tens of millions of items would
    take minutes of host work and says nothing more about the footprint)."""
    import torch

    from gru4rec_tpu_torch.models.gru import init_hidden, pad_items
    from gru4rec_tpu_torch.train.step import TrainState, init_train_state, make_generator

    decoy = init_train_state(make_cfg(DECOY_ITEMS, cfg.adapt, cfg.opt_state_dtype),
                             DECOY_ITEMS, "cpu")
    decoy_pad = pad_items(DECOY_ITEMS, cfg.item_pad_multiple)
    n_pad = pad_items(n_items, cfg.item_pad_multiple)

    def alloc(t):
        shape = tuple(t.shape)
        if shape and shape[0] == decoy_pad:
            shape = (n_pad,) + shape[1:]
        return torch.zeros(shape, dtype=t.dtype, device=dev)

    return TrainState(_tree_map(alloc, decoy.params), _tree_map(alloc, decoy.opt_state),
                      init_hidden(cfg, cfg.batch_size, dev), make_generator(cfg.seed, dev))


def try_one(n_items, adapt, osd) -> int:
    """The state on the card and one chunk through the captured step; one
    JSON line. Exit 0 for ``ok`` and ``oom``, 1 otherwise."""
    import torch

    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.models.gru4rec import resolve_device
    from gru4rec_tpu_torch.ops.kernels import sparse_update
    from gru4rec_tpu_torch.train.step import make_chunk_fn

    dev = resolve_device("cuda")  # the card, float32 products as fit has them
    cfg = make_cfg(n_items, adapt, osd)
    rec = {"n_items": n_items, "adapt": adapt, "opt_state_dtype": osd,
           "workspace_bytes": workspace_bytes(dev)}
    rng = np.random.RandomState(0)
    sched = (rng.randint(0, n_items, (CHUNK, BATCH)).astype(np.int32),
             rng.randint(0, n_items, (CHUNK, BATCH)).astype(np.int32),
             np.ones((CHUNK, BATCH), bool), rng.rand(CHUNK, BATCH) < 0.18)
    try:
        state = zeros_state(cfg, n_items, dev)
        rec["state_bytes"] = tree_bytes(state.params) + tree_bytes(state.opt_state)
        samp1 = torch.from_numpy(uniform_alias_table(n_items)).to(dev)
        logp0 = torch.zeros(pad_items(n_items, cfg.item_pad_multiple), device=dev)
        fn = make_chunk_fn(cfg, n_items)
        sparse_update.reset_launches()
        loss, events = fn(state, *sched, samp1, logp0)
        loss = float(loss)
        torch.cuda.synchronize(dev)
        rec.update(result="ok" if np.isfinite(loss) else "nonfinite", loss=loss,
                   events=events, pool_bytes=fn.runner.pool_bytes,
                   warmup_steps=fn.runner.warm, replays=fn.runner.replays,
                   launches={k: v for k, v in sparse_update.launches_by_mode.items() if v})
    except RuntimeError as exc:  # torch.cuda.OutOfMemoryError is one
        msg = str(exc)
        oom = isinstance(exc, torch.cuda.OutOfMemoryError) or "out of memory" in msg.lower() \
            or "ALLOC_FAILED" in msg
        rec.update(result="oom" if oom else "error", detail=msg[:300])
    rec.update(max_memory_reserved=torch.cuda.max_memory_reserved(dev),
               max_memory_allocated=torch.cuda.max_memory_allocated(dev), card=smi_line())
    print(json.dumps(rec), flush=True)
    return 0 if rec["result"] in ("ok", "oom") else 1


def boundary(adapts):
    """The ladder per (adapt, opt_state_dtype); one ``oom_boundary`` line
    each. A probe that neither passes nor runs out of memory ends its
    ladder with the verdict ``error``."""
    memory = card_memory_bytes()
    if memory is None:
        raise SystemExit("boundary needs a card (nvidia-smi found none)")
    card = smi_line()
    out = []
    for adapt in adapts:
        for osd in DTYPES:
            s = slopes(adapt, osd)
            fixed_bytes = s["param_fixed_bytes"] + s["opt_fixed_bytes"] + s["run_fixed_bytes"]
            n = int((memory - fixed_bytes) / s["total_bytes_per_item"] * 0.8)
            n -= n % 128
            last_ok, first_bad, verdict, tries = None, None, None, []

            def run(n):
                rec = probe(n, adapt, osd)
                tries.append({k: rec.get(k) for k in ("n_items", "result",
                                                      "max_memory_reserved")})
                print(json.dumps(rec), flush=True)
                return rec["result"]

            while first_bad is None:
                verdict = run(n)
                if verdict == "ok":
                    last_ok = n
                    n = int(n * LADDER)
                    n -= n % 128
                else:
                    first_bad = n
            # halve the last step's bracket BISECT_STEPS times
            for _ in range(BISECT_STEPS if verdict == "oom" and last_ok else 0):
                mid = (last_ok + first_bad) // 2
                mid -= mid % 128
                if mid in (last_ok, first_bad):
                    break
                result = run(mid)
                if result == "ok":
                    last_ok = mid
                elif result == "oom":
                    first_bad = mid
                else:
                    verdict = result
                    break
            row = {"metric": "oom_boundary", "adapt": adapt, "opt_state_dtype": osd,
                   "hidden": HIDDEN, "batch": BATCH, "largest_ok_n_items": last_ok,
                   "smallest_failing_n_items": first_bad, "boundary_verdict": verdict,
                   "total_bytes_per_item": s["total_bytes_per_item"],
                   "card_memory_bytes": memory, "tries": tries, "card": card}
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def main(argv) -> int:
    mode = argv[1] if len(argv) > 1 else "table"
    if mode == "table":
        table()
        return 0
    if mode == "try":
        return try_one(int(argv[2]), argv[3], argv[4])
    if mode == "boundary":
        boundary(argv[2:] or list(ADAPTS))
        return 0
    raise SystemExit(f"unknown mode {mode!r}; use table, try N A D or boundary")


if __name__ == "__main__":
    sys.exit(main(sys.argv))
