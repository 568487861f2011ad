"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives ``gru4rec_tpu_torch`` only (no JAX):

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compiles every CUDA source of the port with ``nvcc``, and the
   host schedule builder with ``g++``, all at once;
3. kernel  — holds the fused row-sparse update kernel against its plain
   PyTorch version on the card in each of its modes (K1-K4, module doc of
   ``ops/kernels/sparse_update.py``): every optimizer x momentum x L2 x
   state dtype at the flagship shape (table 36,992 x 256, K = 2,208 pop^0.4
   indices with duplicates and sentinels) and at the unaligned widths 225
   and 300; the stochastic-rounding mode (``bfloat16_sr``, adagrad and adam
   x momentum x L2, a slow-v1 adam, widths 300, 128 and 12) with the stored bf16
   state bit-equal on rows touched once and within one bf16 ulp elsewhere;
   the edges of the kernel's in-kernel dedup (int64 indices, K = 9,000, a
   run longer than the kernel lists, the last row, a padding row, width
   513) and one call under
   ``torch.cuda.set_sync_debug_mode("error")``; then times each main path's
   update at its shape over 64 back-to-back calls on distinct index sets
   (``kernel_timing``, one line per mode and path, K1 three times): the device
   time per call of every operation the wrapper issues (``ms``, from
   ``torch.profiler``; ``ops_per_call`` of them, the kernel alone), the
   wrapper's and the plain version's time per call (CUDA events);
4. reference — the training slice on the card against the same slice on
   the CPU at a small size, step by step;
5. train   — ``GRU4Rec.fit`` of the RetailRocket flagship config (GRU-224,
   batch 80, bpr-max/elu-0.5, 2048 pop^0.4 alias negatives, constrained
   embedding, adagrad + momentum 0.4) for one epoch on synthetic
   RetailRocket-shaped data, then ``evaluate`` on held-out sessions, with
   the kernel's launch counters read around that run;
6. train_sr_control — the same with ``opt_state_dtype="bfloat16_sr"``
   but adagrad's bf16 accumulator stored round-to-nearest (no SR; K1 with
   bf16 state): the reading that ``train_sr``'s limit must exclude;
7. train_sr — the same with stochastic rounding (K2): its loss within 2%
   of the train phase's, its summed ``Wy`` accumulator within
   ``SR_ACC_REL_LIMIT`` of the train phase's float32 one, the control's
   outside that limit;
8. train_adam_sr — the flagship with adam (learning rate 0.001) and
   ``bfloat16_sr`` state (K3 on the full-width ``Wy``);
9. train_onehot — the RSC15 config of ``param_samples/rsc15_bpr-max.py``
   (GRU-100, one-hot input, batch 32, 2048 uniform negatives, adagrad +
   momentum 0.3) for one epoch on synthetic sessions over RSC15's 37,483
   items (K4 on ``Wx0``, K1 on ``Wy``);
10. learn  — the markov-chain drive of the verify recipe through the port,
   which must reach recall@1 >= 0.9;
11. learn_sr — the same chain with adam, an embedding of 12 and
   ``bfloat16_sr`` state (K3 on ``E`` and ``Wy``), recall@1 >= 0.9;
12. proto   — the adagrad prototypes P1 (merged ``[t | a]`` layout) and P2
   (block-local loop over the real rows, ``cp.async`` ring) of
   ``ops/kernels/proto_adagrad.py``, both sort-free and one operation per
   call: each against its plain version at a small shape and at every
   published shape of its script with the last row touched, and at the
   edges of the in-kernel dedup (K = 1, one run over all K, all sentinels,
   int64 indices, K = 9,000 with a 40-position run and a padding row) and
   of the access paths (16-, 8- and 4-byte rows: width 256, a row-sliced
   base off 16 bytes), there against the plain version on the CPU and bit
   for bit against ``proto_measure.exact_adagrad``; both wrappers under
   ``torch.cuda.set_sync_debug_mode("error")``; then the measurement paths
   of ``scripts/proto_merged_kernel_torch.py`` and
   ``scripts/proto_v3_kernel_torch.py`` (one line per shape and variant,
   each one operation per call) and each kernel's whole-call timing at the
   RetailRocket shape;
13. serve   — serving on the train phase's fitted flagship model after
   ``scripts/measure_serving.py``: ``predict_topk`` (k = 20) at batch 1, 64
   and 256 (warm median ms per call, device ms per call, events/s),
   ``predict_next_batch`` once at batch 512; top-k against the full score
   frame, a changed session's lane against a fresh lane, and
   ``cast_for_serving("bfloat16")``;
14. checkpoint — ``savemodel(include_optimizer=True)`` of that model and
   ``loadmodel`` on the card (archive bytes, save and load seconds; equal
   top-k scores bit for bit), then ``fit(retrain=True)`` of the loaded
   model on data with 500 unseen items (the tables grow; K1 once per step);
15. resume  — the markov chain with adagrad and ``bfloat16_sr`` state (K2):
   a run resumed from a training checkpoint against two uninterrupted runs
   (``resume_diff <= repeat_diff``), with a ``profile_dir`` trace; in-fit
   validation with ``early_stop_patience`` and ``keep_best``;
16. cli     — ``python -m gru4rec_tpu_torch.cli.run`` as subprocesses: the
   flagship trained, saved and evaluated from TSV files, the archive
   loaded and evaluated to the same ``PRIMARY METRIC:``, and a NaN run
   that exits 2;
17. scheduler — the native schedule builder (``data/_native_scheduler.py``,
   ``csrc/scheduler.cpp`` built by ``g++``) against the numpy builder on the
   train phase's split and on a RetailRocket-length split of 750,000 events:
   equal arrays, and the median ms of 5 builds each. Every training phase
   (``train`` to ``learn_sr``, and ``resume``) prints ``native_schedules``
   and ``numpy_schedules``, the schedules built each way while it ran: none
   by numpy;
18. legacy_eval — on the train phase's flagship model and test split,
   ``evaluate_sessions_batch`` (the ``predict_next_batch`` path) against
   ``evaluate`` (recall and MRR @20 within 0.03), ``Pop`` and ``ItemKNN``
   through ``evaluate_sessions``; seconds and events/s of each evaluator,
   and the device memory peak of ``evaluate``;
19. paropt  — ``python -m gru4rec_tpu_torch.cli.paropt``: a random search
   of two trials over the flagship's learning rate and momentum, then the
   final run of the best at @1, 5, 20; ``-tf`` reaches every child (one
   JSONL ``epoch`` event each);
20. mesh    — the (data, model) mesh of ``gru4rec_tpu_torch/parallel/``
   over ``torch.distributed``, in three parts. ``mesh_shard_kernel``: K1
   and K2 on the flagship ``Wy`` and K4 on the RSC15 ``Wx0``, cut into 2
   and 4 row-shards as a mesh's model ranks hold them, each shard's call
   on its rows with local indices and ``sr_seed=(seed, r0)``: bit-equal to
   the whole-table call (``r0`` and ``max_abs_err`` per shard).
   ``mesh_1x1``: ``fit(mesh=make_mesh(1, 1))`` of the flagship over NCCL
   on ``cuda:0`` for the train phase's epoch: loss, every parameter and
   optimizer leaf, and Recall/MRR@1/5/20 of ``evaluate(mesh=)`` bit-equal
   to the train phase's; K1 once per step; ``predict_topk(mesh=)`` at batch
   1, 64 and 256 equal to the single-device call (warm median ms per call
   of both in turns, the mesh call's device ms, events/s).
   ``mesh_2x2_shared_card``: four ranks that the script spawns
   (``chip_smoke.py --mesh-rank <rank> <port> <dir>``), all on ``cuda:0``
   over gloo, which the script names (NCCL takes one rank per card): the
   flagship at full width for the train split's first 300 steps through
   the distributed chunk function, with float32 products and state (the
   JAX package's mesh parity settings) and once with ``bfloat16_sr``
   state, against one device over the same steps: loss within rtol 1e-4,
   ``Wy`` within rtol 2e-4 / atol 1e-6, Recall@20 of ``evaluate(mesh=)``
   within 1e-3, the SR run's summed ``Wy`` accumulator within
   ``SR_ACC_REL_LIMIT`` of the float32 run's; K1 (K2) once per step on
   every rank; each rank's ``(di, mi, r0)``. A rank that fails or times
   out fails the phase;
21. published — the nine published configurations, loaded through the
   port's harnesses (``examples/reproduce_published.load_config`` on the
   six paramfile copies, ``examples/rsc15/run_rsc15.CONFIGS``) at their
   published width, loss, ``logq``, dropout, momentum and batch, cut to one
   epoch: each trains on ``synth_split`` at its dataset's catalog (every
   item in training, so at least twice the catalog in events: rees46's
   200,000 items on 400,000, the other paramfiles on 100,000, the rsc15
   family on 74,966 at RSC15's session length) and is evaluated at batch
   512 @1/5/10/20: a finite loss, K1 once per step (and K4 for the one-hot
   configurations), the row-sparse updates at the shapes ``train/step.py``
   gives them, evaluation seconds and events/s, the memory peak; then
   ``published_learn``: each for three
   epochs at full width on the markov chain, Recall@5 >= 0.9 (>= 0.5 for
   the one-hot bpr-max configuration, which learns that chain slowly in
   both packages);
22. examples — ``python -m gru4rec_tpu_torch.examples.<name>`` as
   subprocesses: the quickstart (exit 0), ``reproduce_published
   retailrocket`` with the paramfile as published on a synthetic split of
   30,000 events (exit 1, ``PARITY FAIL``, a report of 8 finite metrics),
   ``rsc15.preprocess`` on synthetic raw clicks (four TSVs);
23. kernels — one JSON line per the port's kernel table (K1-K4, K1 on the
   one-hot ``Wy``, K1 on rees46's ``Wy``, P1, P2).

Every phase prints one JSON line; a failed check raises, and the script
then exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SENTINEL = 2**31 - 1
DEVICE = "cuda"

# RetailRocket-shaped synthetic data (bench.py::synth_data), cut in length
N_ITEMS = 36_968
N_EVENTS = 100_000
MEAN_SESSION_LEN = 5.5
# RSC15: the 37,483 training items and 31.6M clicks / 7.97M sessions that
# Hidasi et al. (ICLR 2016, section 4.1) report, at the same event count
RSC15_ITEMS = 37_483
RSC15_MEAN_SESSION_LEN = 3.97
# the published datasets' training catalogs (scripts/measure_shapes.py:37-52;
# RSC15's from Hidasi et al., as above)
PUBLISHED_ITEMS = {"retailrocket": 36_968, "rees46": 200_000, "diginetica": 43_000,
                   "yoochoose": 37_000, "coveo": 10_000, "rsc15": RSC15_ITEMS}
SR_SEED = (0x2545F491, 0)  # (seed, row offset) of the kernel phase's SR cases

ATOL_F32, RTOL_F32 = 1e-6, 1e-5   # duplicate sums are added in another order
BF16_REL = 2.0**-7                # one bfloat16 ulp, relative, at most
SR_LOSS_REL_LIMIT = 0.02  # train_sr's epoch loss against train's, relative
# train_sr's summed Wy accumulator against train's (float32), relative: set
# between the SR reading and the round-to-nearest control's (PERF.md)
SR_ACC_REL_LIMIT = 3e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def synth_split(seed=0, n_items=N_ITEMS, mean_len=MEAN_SESSION_LEN, n_events=N_EVENTS):
    """bench.py::synth_data's generator at ``n_events`` events, split into train
    (the first 90% of sessions) and test (the rest). Item ids that the zipf
    draw missed in train overwrite random repeated train events, so all
    ``n_items`` items are in the training catalog (the tables are full
    width)."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    n_sessions = int(n_events / mean_len)
    lens = 2 + rng.geometric(1.0 / (mean_len - 2.0), size=n_sessions)
    total = int(lens.sum())
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = 1.0 / ranks**0.8
    p /= p.sum()
    items = rng.choice(n_items, size=total, p=p).astype(np.int64)
    n_train = int(lens[: n_sessions * 9 // 10].sum())
    _, first = np.unique(items[:n_train], return_index=True)
    repeats = np.setdiff1d(np.arange(n_train), first)  # not an item's only event
    missing = np.setdiff1d(np.arange(n_items), items[:n_train])
    items[rng.choice(repeats, size=len(missing), replace=False)] = missing
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    data = pd.DataFrame(
        {"SessionId": sess, "ItemId": items, "Time": np.arange(total, dtype=np.int64)}
    )
    return data.iloc[:n_train], data.iloc[n_train:]


def markov(n_sessions, n_items=60, seed=0):
    """The verify recipe's learnable chain: next = (7*i+3) % n."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(3, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


# bench.py::_flagship_cfg, cut to one epoch
FLAGSHIP = dict(loss="bpr-max", final_act="elu-0.5", hidden_act="tanh",
                layers=[224], batch_size=80, n_sample=2048, sample_alpha=0.4,
                bpreg=1.95, learning_rate=0.05, momentum=0.4,
                dropout_p_embed=0.0, dropout_p_hidden=0.0,
                constrained_embedding=True, n_epochs=1, chunk_size=512)


def flagship_cfg(**kw):
    from gru4rec_tpu_torch import GRU4RecConfig

    return GRU4RecConfig(**{**FLAGSHIP, **kw})


def rsc15_cfg(**kw):
    """param_samples/rsc15_bpr-max.py, cut from 10 epochs to one."""
    from gru4rec_tpu_torch import GRU4RecConfig

    args = dict(layers=[100], loss="bpr-max", final_act="elu-0.5", hidden_act="tanh",
                adapt="adagrad", n_epochs=1, batch_size=32, dropout_p_embed=0.0,
                dropout_p_hidden=0.0, learning_rate=0.2, momentum=0.3,
                sample_alpha=0.0, n_sample=2048, bpreg=1.0,
                constrained_embedding=False, chunk_size=512)
    args.update(kw)
    return GRU4RecConfig(**args)


# --------------------------------------------------------------------- #
def phase_device():
    import torch

    from gru4rec_tpu_torch.ops.kernels.proto_measure import nvidia_smi_line

    line = nvidia_smi_line()
    print(line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": line, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build():
    from gru4rec_tpu_torch.ops.kernels import build

    t0 = time.time()
    names = (*build.SOURCES, *build.HOST_SOURCES)
    build.build(names)
    for name in names:
        build.load(name)
    emit({"phase": "build", "sources": list(names), "seconds": time.time() - t0})


def _index_sets(rng, n_items, K, B, n, alpha=0.4):
    """``n`` sets of K = 2B + n_sample indices shaped like one
    constrained-mode step each: 2B lane indices (a few masked to the
    sentinel) then pop^alpha alias draws."""
    from gru4rec_tpu_torch.ops.sampling import build_alias_table

    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    pop = np.maximum((1e6 / ranks**0.8).astype(np.int64), 1)
    packed = build_alias_table(pop, alpha)
    p = pop / pop.sum()
    n_neg = K - 2 * B
    sets = []
    for _ in range(n):
        slot = rng.randint(0, n_items, n_neg)
        prob = packed[slot, 0].view(np.float32)
        neg = np.where(rng.rand(n_neg) < prob, slot, packed[slot, 1])
        lanes = rng.choice(n_items, size=2 * B, p=p)
        lanes[rng.choice(2 * B, size=B // 8, replace=False)] = SENTINEL
        sets.append(np.concatenate([lanes, neg]).astype(np.int32))
    return np.stack(sets)


def _lane_set(rng, n_items, B):
    """B one-hot input indices of one step: popularity-weighted lanes, a few
    masked to the sentinel (the ``X_scatter`` of ``Wx0``)."""
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = 1.0 / ranks**0.8
    lanes = rng.choice(n_items, size=B, p=p / p.sum())
    lanes[rng.choice(B, size=max(B // 8, 1), replace=False)] = SENTINEL
    return lanes.astype(np.int32)


def _edge_index(rng, n_rows, K, run):
    """K indices for the dedup's edges: uniform rows, one row (the last)
    at ``run`` random positions, five sentinels and a padding row
    (``n_rows + 3``, dropped as the sentinel is)."""
    idx = rng.randint(0, n_rows, K).astype(np.int64)
    pos = rng.permutation(K)
    idx[pos[:run]] = n_rows - 1
    idx[pos[run:run + 5]] = SENTINEL
    idx[pos[run + 5]] = n_rows + 3
    return idx


def _make_case(adapt, momentum, lmbd, state_dtype, n_rows, d, idx, seed,
               adapt_params=()):
    import torch

    from gru4rec_tpu_torch import GRU4RecConfig
    from gru4rec_tpu_torch.train.optimizers import make_optimizer

    cfg = GRU4RecConfig(adapt=adapt, momentum=momentum, lmbd=lmbd,
                        learning_rate=1.0 if adapt == "adadelta" else 0.05,
                        opt_state_dtype=state_dtype, adapt_params=list(adapt_params))
    opt = make_optimizer(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    table = torch.randn((n_rows, d), generator=gen, device=DEVICE)
    st = opt.init_state(table, sparse=True)
    for k, v in st.items():
        # nontrivial state; adam's count block holds small integers (under
        # SR as base-256 limbs in lanes 0..2, the other lanes zero)
        if k == "acc2" and adapt == "adam":
            v[:, :2 * d].copy_(torch.rand((n_rows, 2 * d), generator=gen, device=DEVICE))
            if opt.sr_active(st):
                v[:, 2 * d:].zero_()
                for lane, top in ((0, 256), (1, 3)):
                    v[:, 2 * d + lane].copy_(torch.randint(
                        0, top, (n_rows,), generator=gen, device=DEVICE))
            else:
                cnt = torch.randint(0, 6, (n_rows, 1), generator=gen, device=DEVICE)
                v[:, 2 * d:].copy_(cnt.expand(n_rows, v.shape[1] - 2 * d))
        else:
            v.copy_(torch.rand(v.shape, generator=gen, device=DEVICE) * 0.3)
    g = torch.randn((len(idx), d), generator=gen, device=DEVICE) * 0.1
    return opt, table, torch.from_numpy(idx).to(DEVICE), g, st


def _onehot_wy_sets(rng, n_items, B, n_sample, n):
    """``n`` index sets of the one-hot path's ``Wy`` update: B lanes (a few
    masked to the sentinel) then ``n_sample`` uniform negatives
    (``sample_alpha`` 0)."""
    return np.stack([np.concatenate([_lane_set(rng, n_items, B),
                                     rng.randint(0, n_items, n_sample).astype(np.int32)])
                     for _ in range(n)])


def _compare(name, a, b):
    """Max abs error of ``a`` (kernel) against ``b`` (plain); raises beyond
    tolerance: float32 rtol/atol, bfloat16 one ulp."""
    import torch

    af, bf = a.float(), b.float()
    err = (af - bf).abs()
    if a.dtype == torch.bfloat16:
        tol = BF16_REL * torch.maximum(af.abs(), bf.abs())
    else:
        tol = ATOL_F32 + RTOL_F32 * bf.abs()
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} elements beyond tolerance, "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def _bits_equal(a, b):
    import torch

    return a.contiguous().view(torch.int16) == b.contiguous().view(torch.int16)


def _kernel_vs_plain(opt, table, idx_t, g, st):
    """One call of the kernel and one of its plain version from the same
    inputs. Every tensor within tolerance (``_compare``); rows no index
    touches bit-identical. Stochastically rounded state (SR seed
    ``SR_SEED``): bit-equal on the rows touched exactly once, within one
    bf16 ulp on rows with duplicate indices (the plain version's
    ``index_add_`` sums those in atomic order, which may flip a rounding
    decision), adam's limb counts exact and lanes 3.. zero. Returns the max
    abs error, the bit-equal share of the SR state's touched entries (None
    without SR) and the launch mode."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import sparse_update

    n_rows, d = table.shape
    sr_seed = SR_SEED if opt.sr_active(st) else None
    t_k, st_k = table.clone(), {k: v.clone() for k, v in st.items()}
    t_p, st_p = table.clone(), {k: v.clone() for k, v in st.items()}
    before = dict(sparse_update.launches_by_mode)
    sparse_update.fused_update(opt, t_k, idx_t, g, st_k, sr_seed=sr_seed)
    opt.apply_sparse_plain(t_p, idx_t, g, st_p, sr_seed=sr_seed)
    torch.cuda.synchronize()
    mode = [m for m in sparse_update.MODES
            if sparse_update.launches_by_mode[m] != before[m]]
    if mode != [sparse_update.mode_of(opt.adapt, d, sr_seed is not None)]:
        raise AssertionError(f"launch counted as {mode}")
    counts = torch.bincount(idx_t[idx_t < n_rows].long(), minlength=n_rows)
    touched, once = counts > 0, counts == 1
    errs = {"table": _compare("table", t_k, t_p)}
    share = None
    for k in st:
        a, b = st_k[k], st_p[k]
        if sr_seed is not None and k in ("acc", "acc2"):
            if k == "acc2":  # adam: limbs exact, then [acc | meang]
                if not torch.equal(a[:, 2 * d:], b[:, 2 * d:]) or bool(a[:, 2 * d + 3:].any()):
                    raise AssertionError("adam limb counts differ")
                a, b = a[:, :2 * d], b[:, :2 * d]
            eq = _bits_equal(a, b)
            if not bool(eq[once].all()):
                raise AssertionError(f"{k}: SR state differs on rows touched once")
            share = float(eq[touched].float().mean())
        errs[k] = _compare(k, a, b)
    for name, a, b in [("table", t_k, table)] + [(k, st_k[k], st[k]) for k in st]:
        if not torch.equal(a[~touched], b[~touched]):
            raise AssertionError(f"kernel changed untouched rows of {name}")
    return max(errs.values()), share, mode[0]


def phase_kernel():
    """Kernel against plain version in every mode and combination."""
    from gru4rec_tpu_torch.models.gru import pad_cols, pad_items

    rng = np.random.RandomState(0)
    n_items, B, n_sample = N_ITEMS, 80, 2048
    n_rows, d = pad_items(n_items, 128), pad_cols(224 + 1)
    K = 2 * B + n_sample
    idx = _index_sets(rng, n_items, K, B, 1)[0]
    adapts = ("adagrad", "rmsprop", "adadelta", "adam")
    cases = []  # (adapt, momentum, lmbd, opt_state_dtype, width, adapt_params)
    for adapt in adapts:
        for momentum in (0.0, 0.4):
            for lmbd in (0.0, 0.01):
                for sd in ("float32", "bfloat16"):
                    cases.append((adapt, momentum, lmbd, sd, d, ()))
    for adapt in adapts:
        cases.append((adapt, 0.4, 0.01, "bfloat16", 225, ()))
        for sd in ("float32", "bfloat16"):
            cases.append((adapt, 0.4, 0.01, sd, 300, ()))
    for adapt in ("adagrad", "adam"):
        for momentum in (0.0, 0.4):
            for lmbd in (0.0, 0.01):
                cases.append((adapt, momentum, lmbd, "bfloat16_sr", d, ()))
        for width in (300, 128, 12):
            cases.append((adapt, 0.4, 0.01, "bfloat16_sr", width, ()))
    cases.append(("adam", 0.4, 0.01, "bfloat16_sr", d, (0.995, 0.999)))
    cases = [c + ("flagship",) for c in cases]
    # the edges of the in-kernel dedup: int64 indices; K = 9,000 (nine
    # rounds of the dedup pass) with the last row at 40 positions (past the
    # 32 further positions a run head lists), at the vector (256) and
    # scalar (513) widths
    idxs = {"flagship": idx, "flagship_int64": idx.astype(np.int64),
            "edges": _edge_index(rng, n_rows, 9000, 40)}
    cases += [("adagrad", 0.4, 0.01, "bfloat16", d, (), "flagship_int64"),
              ("adam", 0.4, 0.0, "bfloat16_sr", d, (), "flagship_int64"),
              ("adagrad", 0.4, 0.0, "bfloat16", d, (), "edges"),
              ("adadelta", 0.4, 0.01, "float32", 513, (), "edges"),
              ("adam", 0.4, 0.01, "bfloat16_sr", 513, (), "edges")]
    results = []
    for ci, (adapt, momentum, lmbd, sd, width, ap, iname) in enumerate(cases):
        opt, table, idx_t, g, st = _make_case(adapt, momentum, lmbd, sd, n_rows,
                                              width, idxs[iname], seed=ci, adapt_params=ap)
        err, share, mode = _kernel_vs_plain(opt, table, idx_t, g, st)
        case = {"mode": mode, "adapt": adapt, "momentum": momentum, "lmbd": lmbd,
                "opt_state_dtype": sd, "d": width, "adapt_params": list(ap),
                "indices": f"{iname} ({str(idx_t.dtype).replace('torch.', '')}, "
                           f"K {len(idx_t)})",
                "state": {k: str(v.dtype).replace("torch.", "") for k, v in st.items()},
                "max_abs_err": err}
        if share is not None:
            case["sr_bit_equal_share"] = share
        results.append(case)
    emit({"phase": "kernel", "n_rows": n_rows, "K": K, "cases": results})
    _no_sync_call(n_rows, d, idx)


def _no_sync_call(n_rows, d, idx):
    """One wrapper call under ``torch.cuda.set_sync_debug_mode("error")``:
    the wrapper must issue no host synchronisation."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import sparse_update

    opt, table, idx_t, g, st = _make_case("adagrad", 0.4, 0.0, "bfloat16", n_rows, d,
                                          idx, seed=5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sparse_update.fused_update(opt, table, idx_t, g, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "kernel_no_sync", "mode": "K1", "sync_debug_mode": "error",
          "passed": True})


def _row_bytes(opt, st, d, sr):
    """Bytes that the update of one distinct row must read and write: its
    table row, velocity row and state row, each read and written once, but
    of adam's 128-lane count block only the lanes that carry the count: one
    lane read and all 128 written (each holds the count), or under SR the
    three limb lanes read and written (the other lanes stay 0)."""
    row = 2 * d * 4
    for k, v in st.items():
        es = v.element_size()
        if k == "acc2" and opt.adapt == "adam":
            read, written = (3, 3) if sr else (1, v.shape[1] - 2 * d)
            row += (4 * d + read + written) * es
        else:
            row += 2 * v.shape[1] * es
    return row


# every device operation fused_update issues per call, by a substring of
# its name in the profiler's trace: the kernel alone
CALL_OPS = ("sparse_update_kernel",)


def phase_kernel_timing():
    """Each main path's update at its shape and settings: one
    kernel-vs-plain check, then ``STEPS`` back-to-back calls on as many
    distinct index sets (``ops/kernels/proto_measure.py``): under
    ``torch.profiler`` the device time per call of every operation the
    wrapper issues (``ms``: ``CALL_OPS``, and the profiler must see no
    other operation once per call; so ``ops_per_call`` is 1 and ``ms`` is
    the kernel's own time); the CUDA-event time per call of
    the wrapper (``step_ms``) and of the plain version (``plain_ms``),
    medians over runs; and the byte bound, averaged over the index sets: the
    K indices and gradient rows read once, plus ``_row_bytes`` for each
    distinct row. Returns {key: timing}, keyed by mode, "K1 onehot Wy"
    for K1 on the one-hot path's ``Wy`` and "K1 rees46 Wy" for K1 without
    a velocity on rees46's ``Wy`` (the published phase's largest update:
    200,064 rows, width ``pad_cols(512 + 1)``, K = 2 * 240 + 2,048
    positions, pop^0.5 negatives)."""
    import torch

    from gru4rec_tpu_torch.models.gru import pad_cols, pad_items
    from gru4rec_tpu_torch.ops.kernels import proto_measure, sparse_update

    rng = np.random.RandomState(0)
    B, steps = 80, proto_measure.STEPS
    n_rows, d = pad_items(N_ITEMS, 128), pad_cols(224 + 1)
    K = 2 * B + 2048
    flagship = _index_sets(rng, N_ITEMS, K, B, steps)
    rsc_rows = pad_items(RSC15_ITEMS, 128)
    onehot = np.stack([_lane_set(rng, RSC15_ITEMS, 32) for _ in range(steps)])
    onehot_wy = _onehot_wy_sets(rng, RSC15_ITEMS, 32, 2048, steps)
    rees46 = _index_sets(rng, PUBLISHED_ITEMS["rees46"], 2 * 240 + 2048, 240, steps,
                         alpha=0.5)
    rows = {  # key: (mode, main path, adapt, momentum, state dtype, n_rows, d, index sets)
        "K1": ("K1", "train: flagship Wy", "adagrad", 0.4, "bfloat16", n_rows, d, flagship),
        "K2": ("K2", "train_sr: flagship Wy", "adagrad", 0.4, "bfloat16_sr", n_rows, d,
               flagship),
        "K3": ("K3", "train_adam_sr: flagship Wy", "adam", 0.4, "bfloat16_sr", n_rows, d,
               flagship),
        "K4": ("K4", "train_onehot: RSC15 Wx0", "adagrad", 0.3, "bfloat16", rsc_rows, 3 * 100,
               onehot),
        "K1 onehot Wy": ("K1", "train_onehot: Wy", "adagrad", 0.3, "bfloat16", rsc_rows,
                         128, onehot_wy),
        "K1 rees46 Wy": ("K1", "published: rees46 Wy", "adagrad", 0.0, "bfloat16",
                         pad_items(PUBLISHED_ITEMS["rees46"], 128), pad_cols(512 + 1), rees46),
    }
    out = {}
    for key, (mode, path, adapt, momentum, sd, rows_n, width, sets) in rows.items():
        opt, table, idx_t, g, st = _make_case(adapt, momentum, 0.0, sd, rows_n, width,
                                              sets[0], seed=99)
        err, share, got_mode = _kernel_vs_plain(opt, table, idx_t, g, st)
        if got_mode != mode:
            raise AssertionError(f"{mode} case launched as {got_mode}")
        sr_seed = SR_SEED if opt.sr_active(st) else None
        Kn = sets.shape[1]
        idxs = torch.from_numpy(sets).to(DEVICE)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(7)
        gs = torch.randn((steps, Kn, width), generator=gen, device=DEVICE) * 0.1
        kern = lambda s: sparse_update.fused_update(opt, table, idxs[s], gs[s], st,
                                                    sr_seed=sr_seed)
        plain = lambda s: opt.apply_sparse_plain(table, idxs[s], gs[s], st, sr_seed=sr_seed)
        times = proto_measure.device_times(kern, steps=steps, names=CALL_OPS)
        ms = proto_measure.kernel_us(times, CALL_OPS, steps, exclusive=True) / 1e3
        step_ms = proto_measure.steps_us(kern) / 1e3
        plain_ms = proto_measure.steps_us(plain, reps=3) / 1e3
        U = float(np.mean(proto_measure.distinct_rows(idxs, rows_n)))
        bytes_moved = (Kn * 4 + Kn * width * 4   # indices, gradient rows
                       + U * _row_bytes(opt, st, width, sr_seed is not None))
        out[key] = {"path": path, "adapt": adapt, "momentum": momentum,
                    "opt_state_dtype": sd, "n_rows": rows_n, "d": width, "K": Kn,
                    "index_sets": steps, "distinct_rows": U, "ms": ms,
                    "ops_per_call": proto_measure.ops_per_call(times, steps),
                    "ops": {k[:60]: v for k, v in times.items()},
                    "step_ms": step_ms, "plain_ms": plain_ms,
                    "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
                    "bytes": bytes_moved, "max_abs_err": err,
                    "sr_bit_equal_share": share}
        emit({"phase": "kernel_timing", "mode": mode, **out[key]})
    return out


def phase_reference():
    """The training slice on the card against the same slice on the CPU at
    a small size (60 items, layers [32], batch 8, 16 injected negatives,
    compute and state float32, masked and reset lanes): per-step loss within
    rtol 1e-4, final weights within atol 1e-5."""
    import torch

    from gru4rec_tpu_torch import GRU4RecConfig
    from gru4rec_tpu_torch.models.gru4rec import resolve_device
    from gru4rec_tpu_torch.train import step as tstep

    n_items, B, T = 60, 8, 40
    cfg = GRU4RecConfig(loss="bpr-max", final_act="elu-0.5", layers=[32],
                        batch_size=B, n_sample=16, constrained_embedding=True,
                        momentum=0.4, compute_dtype="float32",
                        opt_state_dtype="float32", chunk_size=1)
    rng = np.random.RandomState(0)
    sched = [rng.randint(0, n_items, (T, B)).astype(np.int32),
             rng.randint(0, n_items, (T, B)).astype(np.int32),
             np.ones((T, B), bool), rng.rand(T, B) < 0.2]
    sched[2][T // 2:, B // 2:] = False
    neg = torch.from_numpy(rng.randint(0, n_items, (T, 16)).astype(np.int32))
    runs = []
    for dev in ("cpu", resolve_device(DEVICE)):
        state = tstep.init_train_state(cfg, n_items, dev)
        chunk_fn = tstep.make_chunk_fn(cfg, n_items)
        samp1 = torch.zeros(1, device=dev)
        logp0 = torch.zeros(128, device=dev)
        losses = [float(chunk_fn(state, *(a[t:t + 1] for a in sched), samp1, logp0,
                                 neg=neg[t:t + 1])[0]) for t in range(T)]
        runs.append((np.array(losses), state.params["Wy"].cpu()))
    (l_cpu, w_cpu), (l_dev, w_dev) = runs
    loss_err = float(np.max(np.abs(l_dev - l_cpu) / np.abs(l_cpu)))
    w_err = float((w_dev - w_cpu).abs().max())
    emit({"phase": "reference", "steps": T, "loss_max_rel_err": loss_err,
          "Wy_max_abs_err": w_err})
    if not (loss_err <= 1e-4 and w_err <= 1e-5):
        raise AssertionError(f"card and CPU disagree: loss {loss_err}, Wy {w_err}")


@contextlib.contextmanager
def _schedules():
    """Counts the schedules built natively (``_native_scheduler.calls``, set
    to 0 on entry) and by the numpy builder while the block runs; the counts
    are in the yielded dict after the block."""
    from gru4rec_tpu_torch.data import _native_scheduler, scheduler

    numpy_build = scheduler._build_schedule_numpy
    counts = {"native_schedules": 0, "numpy_schedules": 0}

    def counted(*args, **kw):
        counts["numpy_schedules"] += 1
        return numpy_build(*args, **kw)

    _native_scheduler.reset_calls()
    scheduler._build_schedule_numpy = counted
    try:
        yield counts
    finally:
        scheduler._build_schedule_numpy = numpy_build
        counts["native_schedules"] = _native_scheduler.calls


def _check_schedules(phase, counts, expected):
    """Every schedule of the phase was built natively, ``expected`` of them
    (or at least one where ``expected`` is None)."""
    native = counts["native_schedules"]
    if counts["numpy_schedules"] or native < 1 or (expected is not None
                                                   and native != expected):
        raise AssertionError(f"{phase}: schedules {counts}, expected {expected} "
                             f"native and none by numpy")


@contextlib.contextmanager
def _updates(on):
    """With ``on``, counts the row-sparse updates by table shape, K and
    state (slot: dtype) while the block runs, in the yielded dict; each
    goes on to ``sparse_update.fused_update``, which counts its launch."""
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    counts = {}
    fused = sparse_update.fused_update

    def counted(opt, table, idx, g, st, sr_seed=None):
        state = ",".join(f"{k}:{str(v.dtype).replace('torch.', '')}" for k, v in st.items())
        key = f"{tuple(table.shape)} K={idx.shape[0]} {state}"
        counts[key] = counts.get(key, 0) + 1
        return fused(opt, table, idx, g, st, sr_seed=sr_seed)

    if on:
        sparse_update.fused_update = counted
    try:
        yield counts
    finally:
        sparse_update.fused_update = fused


def _train(phase, cfg, train, test, smi_line, per_step, cut_off=(1, 5, 20), extra=None):
    """``GRU4Rec.fit`` for one epoch then ``evaluate``, with the kernel's
    launch counters set to 0 just before and read just after. ``per_step``
    = {mode: launches per step} that the path must show (every other mode
    none). With ``extra`` (a dict of fields for the record), the record
    also holds ``evaluate``'s seconds and events/s, the device memory peak
    of the run and ``updates``: the table shape, K and state of the
    row-sparse updates by count (``_updates``). Returns the phase's JSON
    record and the fitted model."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec, evaluate
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    model = GRU4Rec(cfg, device=DEVICE)
    details = {}
    if extra is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sparse_update.reset_launches()
    with _schedules() as schedules, _updates(extra is not None) as updates:
        model.fit(train)
        t_eval = time.perf_counter()
        rec, mrr = evaluate(model, test, cut_off=list(cut_off), batch_size=512)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t_eval
    by_mode = dict(sparse_update.launches_by_mode)
    if extra is not None:
        n_eval = int((test.groupby("SessionId").size() - 1).sum())
        details = {**extra, "eval_events": n_eval, "eval_seconds": t_eval,
                   "eval_events_per_s": n_eval / t_eval,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "updates": updates}
    # fit builds one schedule per epoch in a random order, else one for all
    # epochs; evaluate one
    _check_schedules(phase, schedules,
                     (cfg.n_epochs if cfg.train_random_order else 1) + 1)

    steps = sum(e["steps"] for e in model.epoch_stats)
    stats = model.epoch_stats[-1]
    if not math.isfinite(stats["loss"]):
        raise AssertionError(f"{phase}: training loss is not finite: {stats['loss']}")
    for m in sparse_update.MODES:
        if by_mode[m] != per_step.get(m, 0) * steps:
            raise AssertionError(f"{phase}: {m} launched {by_mode[m]} times over "
                                 f"{steps} steps, expected {per_step.get(m, 0)} per step")
    for v in rec + mrr:
        if not (0.0 <= v <= 1.0):
            raise AssertionError(f"{phase}: metric out of range: {rec} {mrr}")
    tables = {"Wy": model.params["Wy"]}
    tables.update({"E": model.params["E"]} if "E" in model.params else {})
    if not cfg.constrained_embedding and not cfg.embedding:
        tables["Wx0"] = model.params["Wx"][0]
    for name, t in tables.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{phase}: non-finite weights in {name}")
    names = [f"@{c}" for c in cut_off]
    record = {"phase": phase, "n_items": model.n_items, "train_events": len(train),
              "tables": {k: list(v.shape) for k, v in tables.items()},
              "opt_state": {k: {s: str(v.dtype).replace("torch.", "") for s, v in st.items()}
                            for k, st in model._train_state.opt_state["sparse"].items()},
              "acc_sums": {k: float(st["acc"].double().sum())
                           for k, st in model._train_state.opt_state["sparse"].items()
                           if "acc" in st},
              "steps": steps, "events": stats["events"], "loss": stats["loss"],
              "seconds": stats["seconds"],
              "events_per_s": stats["events"] / stats["seconds"],
              "recall": dict(zip(names, rec)), "mrr": dict(zip(names, mrr)),
              "launches": by_mode, **schedules, **details, "card": smi_line}
    emit(record)
    return record, model


def phase_train(smi_line):
    """The flagship (K1 on Wy, once per step). Returns the record and the
    fitted model, which the serve and checkpoint phases use."""
    train, test = synth_split()
    rec, model = _train("train", flagship_cfg(), train, test, smi_line, {"K1": 1})
    if rec["n_items"] != N_ITEMS:
        raise AssertionError(f"catalog is {rec['n_items']} items, not {N_ITEMS}")
    return rec, model


def phase_train_sr_control(smi_line):
    """The control of train_sr's loss check: the flagship with bfloat16_sr
    state but adagrad's bf16 accumulator stored round-to-nearest. With
    ``Optimizer.sr_active`` reporting False the state keeps its bf16 layout
    and the kernel runs its non-SR mode (K1) on it, once per step."""
    from gru4rec_tpu_torch.train.optimizers import Optimizer

    train, test = synth_split()
    sr_active = Optimizer.sr_active
    Optimizer.sr_active = lambda self, st: False
    try:
        rec, _ = _train("train_sr_control", flagship_cfg(opt_state_dtype="bfloat16_sr"),
                     train, test, smi_line, {"K1": 1})
    finally:
        Optimizer.sr_active = sr_active
    if rec["opt_state"]["Wy"]["acc"] != "bfloat16":
        raise AssertionError(f"control state is not bfloat16: {rec['opt_state']}")
    return rec


def phase_train_sr(smi_line, ref, control):
    """Path A: the flagship with bfloat16_sr state (K2 on Wy, once per
    step), on the train phase's data, seed and negatives, against ``ref``
    (the train phase: bfloat16 velocity, float32 acc) and ``control`` (its
    accumulator stored round-to-nearest): the loss within 2% of ref's; the
    summed Wy accumulator within ``SR_ACC_REL_LIMIT`` of ref's, where
    stochastic rounding keeps it unbiased, and the control's outside that
    limit, since round-to-nearest drops the small increments of large
    sums."""
    train, test = synth_split()
    rec, _ = _train("train_sr", flagship_cfg(opt_state_dtype="bfloat16_sr"), train, test,
                 smi_line, {"K2": 1})

    def rel(a, b):
        return abs(a - b) / abs(b)

    out = {"phase": "train_sr_vs_train", "loss": rec["loss"], "train_loss": ref["loss"],
           "control_loss": control["loss"],
           "loss_rel_diff": rel(rec["loss"], ref["loss"]),
           "control_loss_rel_diff": rel(control["loss"], ref["loss"]),
           "acc_sum": rec["acc_sums"]["Wy"], "train_acc_sum": ref["acc_sums"]["Wy"],
           "control_acc_sum": control["acc_sums"]["Wy"],
           "acc_rel_diff": rel(rec["acc_sums"]["Wy"], ref["acc_sums"]["Wy"]),
           "control_acc_rel_diff": rel(control["acc_sums"]["Wy"], ref["acc_sums"]["Wy"]),
           "loss_limit": SR_LOSS_REL_LIMIT, "acc_limit": SR_ACC_REL_LIMIT}
    emit(out)
    if out["loss_rel_diff"] > SR_LOSS_REL_LIMIT:
        raise AssertionError(f"bfloat16_sr loss {rec['loss']} is "
                             f"{out['loss_rel_diff']:.3g} off {ref['loss']}")
    if out["acc_rel_diff"] > SR_ACC_REL_LIMIT:
        raise AssertionError(f"bfloat16_sr accumulator sum is {out['acc_rel_diff']:.3g} "
                             f"off the float32 one")
    if out["control_acc_rel_diff"] <= SR_ACC_REL_LIMIT:
        raise AssertionError(f"the round-to-nearest control's accumulator sum is only "
                             f"{out['control_acc_rel_diff']:.3g} off: the limit separates "
                             f"nothing")
    return rec


def phase_train_adam_sr(smi_line):
    """The flagship with adam and bfloat16_sr state (K3 on the full-width
    Wy, once per step), on the train phase's data: the adam + SR table size
    that the JAX package sends to its compact kernel. Adam takes a learning
    rate of 0.001: at the flagship's 0.05 it does not learn (PERF.md)."""
    train, test = synth_split()
    cfg = flagship_cfg(adapt="adam", learning_rate=0.001, opt_state_dtype="bfloat16_sr")
    return _train("train_adam_sr", cfg, train, test, smi_line, {"K3": 1})[0]


def phase_train_onehot(smi_line):
    """Path B: param_samples/rsc15_bpr-max.py on RSC15-shaped sessions (K4 on
    the 300-wide Wx0, K1 on the 128-wide Wy, each once per step)."""
    train, test = synth_split(seed=1, n_items=RSC15_ITEMS, mean_len=RSC15_MEAN_SESSION_LEN)
    rec, _ = _train("train_onehot", rsc15_cfg(), train, test, smi_line, {"K4": 1, "K1": 1})
    n_pad = rec["tables"]["Wy"][0]
    if rec["n_items"] != RSC15_ITEMS or rec["tables"]["Wx0"] != [n_pad, 300] or \
            rec["tables"]["Wy"] != [n_pad, 128]:
        raise AssertionError(f"unexpected RSC15 tables {rec['tables']} for "
                             f"{rec['n_items']} items")
    return rec


def phase_learn():
    from gru4rec_tpu_torch import GRU4Rec, evaluate

    m = GRU4Rec(loss="bpr-max", layers=[64], batch_size=32, n_sample=64,
                n_epochs=3, constrained_embedding=True, device=DEVICE)
    with _schedules() as schedules:
        m.fit(markov(800))
        rec, mrr = evaluate(m, markov(100, seed=5), cut_off=[1, 5, 20], batch_size=32)
    emit({"phase": "learn", "recall": rec, "mrr": mrr, **schedules})
    _check_schedules("learn", schedules, 2)
    if rec[0] < 0.9:
        raise AssertionError(f"markov recall@1 {rec[0]} < 0.9")


def learn_sr_cfg():
    """The JAX package's SR end-to-end test config (tests/test_sr_state.py):
    adam, an embedding of 12, bfloat16_sr state, on the markov chain."""
    from gru4rec_tpu_torch import GRU4RecConfig

    return GRU4RecConfig(loss="cross-entropy", final_act="softmax", layers=[64],
                         batch_size=32, n_sample=64, sample_alpha=0.5,
                         learning_rate=0.08, adapt="adam", embedding=12, n_epochs=3,
                         chunk_size=32, item_pad_multiple=16,
                         opt_state_dtype="bfloat16_sr", dropout_p_hidden=0.0,
                         dropout_p_embed=0.0, seed=11)


def phase_learn_sr(smi_line):
    """adam + SR state (K3 on E and Wy, twice per step): recall@1 >= 0.9."""
    rec, _ = _train("learn_sr", learn_sr_cfg(), markov(800), markov(100, seed=5), smi_line,
                 {"K3": 2})
    if rec["tables"]["E"][1] != 12 or rec["opt_state"]["E"]["acc2"] != "bfloat16":
        raise AssertionError(f"unexpected E table / state {rec['tables']} {rec['opt_state']}")
    if rec["recall"]["@1"] < 0.9:
        raise AssertionError(f"adam + bfloat16_sr markov recall@1 {rec['recall']} < 0.9")
    return rec


def _offset_copy(x, offset):
    """``x`` copied into a buffer whose base lies ``offset`` elements past
    an aligned allocation (a row-sliced table's base when ``offset`` is not
    a multiple of 4)."""
    import torch

    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


def _proto_vs_plain(kernel, idx, g, table, acc, offset=0, plain_on_cpu=False):
    """One call of P1 or P2 (``kernel``) and one of its plain version from
    the same inputs, the kernel's tables ``offset`` floats off an aligned
    base: table and accumulator within the scripts' rtol 1e-6 / atol 1e-7,
    rows no index touches bit-identical. The plain version runs on the card,
    where ``index_add_`` sums duplicates with atomics in no fixed order, or
    with ``plain_on_cpu`` on copies on the CPU, where it sums them in index
    order as the kernel does: then the accumulator must equal the plain
    version's bit for bit, and table and accumulator must equal
    ``proto_measure.exact_adagrad`` bit for bit (the sum order of a stable
    sort, a correctly rounded square root). Returns the max abs error, the
    access width in bytes that the kernel took for its rows and, with
    ``plain_on_cpu``, the count of table elements off the plain version's
    (its CPU square root's last bits), else None."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import proto_adagrad, proto_measure

    n, d = table.shape
    pdev = "cpu" if plain_on_cpu else table.device
    pidx, pg, ptable, pacc = (x.to(pdev) for x in (idx, g, table, acc))
    before = proto_adagrad.launches_by_mode[kernel]
    if kernel == "P1":
        m_p = torch.cat([ptable, pacc], dim=1)
        m_k = _offset_copy(torch.cat([table, acc], dim=1), offset)
        width = proto_adagrad.access_width(m_k)
        proto_adagrad.merged_adagrad(m_k, idx, g, proto_measure.LR)
        proto_adagrad.merged_adagrad_plain(m_p, pidx, pg, proto_measure.LR)
        m_k = m_k.to(pdev)
        pairs = [(m_k[:, :d], m_p[:, :d], ptable), (m_k[:, d:], m_p[:, d:], pacc)]
    else:
        t_k, a_k = _offset_copy(table, offset), _offset_copy(acc, offset)
        t_p, a_p = ptable.clone(), pacc.clone()
        width = proto_adagrad.access_width(t_k, a_k, g)
        proto_adagrad.v3_adagrad(t_k, a_k, idx, g, proto_measure.LR)
        proto_adagrad.v3_adagrad_plain(t_p, a_p, pidx, pg, proto_measure.LR)
        pairs = [(t_k.to(pdev), t_p, ptable), (a_k.to(pdev), a_p, pacc)]
    torch.cuda.synchronize()
    if proto_adagrad.launches_by_mode[kernel] != before + 1:
        raise AssertionError(f"{kernel} did not launch")
    touched = torch.zeros(n, dtype=torch.bool, device=pdev)
    touched[pidx[(pidx >= 0) & (pidx < n)].long()] = True
    errs = []
    for name, (k, p, orig) in zip(("table", "acc"), pairs):
        errs.append(proto_measure.assert_close(f"{kernel} {name}", k, p))
        if not torch.equal(k[~touched], orig[~touched]):
            raise AssertionError(f"{kernel} changed untouched rows of {name}")
    if not plain_on_cpu:
        return max(errs), width, None
    if not torch.equal(pairs[1][0], pairs[1][1]):
        raise AssertionError(f"{kernel} acc is not bit-equal to the CPU plain version's")
    exact = proto_measure.exact_adagrad(ptable.numpy(), pacc.numpy(), pidx.numpy(), pg.numpy())
    for name, (k, _, _), want in zip(("table", "acc"), pairs, exact):
        if not np.array_equal(k.numpy(), want):
            raise AssertionError(f"{kernel} {name}: {int((k.numpy() != want).sum())} elements "
                                 f"not bit-equal to the exact reference")
    return max(errs), width, int((pairs[0][0] != pairs[0][1]).sum())


def _proto_edges(pm):
    """The edges of P1's and P2's in-kernel dedup and access paths: (case,
    n_rows, d, K raw indices as a numpy array, index dtype, base offset in
    floats)."""
    import torch

    rng = np.random.RandomState(5)
    rr = pm.draw(37120, 225, 2208, steps=1, seed=11)[0][0].cpu().numpy()
    rr[:2] = 37119
    return [
        ("K=1", 1000, 225, np.array([999]), torch.int32, 0),
        ("one run over all K", 37120, 225, np.full(2208, 7), torch.int32, 0),
        ("all sentinels", 1000, 225, np.full(40, SENTINEL), torch.int32, 0),
        ("int64 indices", 37120, 225, rr, torch.int64, 0),
        ("K=9000, a 40-position run of the last row, a padding row", 37120, 225,
         _edge_index(rng, 37120, 9000, 40), torch.int64, 0),
        ("K=9000, a 40-position run of the last row, a padding row", 43136, 513,
         _edge_index(rng, 43136, 9000, 40), torch.int32, 0),
        ("even width: 16-byte accesses", 37120, 256, rr, torch.int32, 0),
        ("row-sliced base, 4 bytes off 16", 37120, 256, rr, torch.int32, 1),
        ("row-sliced base, 8 bytes off 16", 37120, 256, rr, torch.int32, 2),
        ("row-sliced base, odd width", 37120, 225, rr, torch.int32, 1),
    ]


def _proto_no_sync(pm):
    """P1 and P2 wrapper calls, int32 and int64 indices, under
    ``torch.cuda.set_sync_debug_mode("error")``: no host synchronisation."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import proto_adagrad

    idx, g, table, acc = pm.draw(37120, 225, 2208, steps=1)
    merged = torch.cat([table, acc], dim=1)
    calls = [lambda i: proto_adagrad.merged_adagrad(merged, i, g[0], pm.LR),
             lambda i: proto_adagrad.v3_adagrad(table, acc, i, g[0], pm.LR)]
    for call in calls:  # the first calls load the library and size the grid
        call(idx[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call(idx[0])
            call(idx[0].long())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "proto_no_sync", "kernels": ["P1", "P2"], "indices": ["int32", "int64"],
          "sync_debug_mode": "error", "passed": True})


def _one_op(rec, where):
    if rec["ops_per_call"] != 1:
        raise AssertionError(f"{where}: {rec['ops_per_call']} operations per call, "
                             f"not 1: {rec['ops_launches']}")


def phase_proto(smi_line):
    """The adagrad prototypes P1 and P2 (``ops/kernels/proto_adagrad.py``):
    each against its plain version at a small shape and at every published
    shape of both scripts, with the last row touched twice and four
    sentinels, and at the edges of their in-kernel dedup and access paths
    (``_proto_edges``); P1 and P2 calls under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation);
    then both measurement paths (``scripts/proto_*_torch.py``), one line per
    shape and variant, with the launch counters set to 0 just before and
    read just after, every variant one operation per call; and, for the
    kernels line, each kernel's device time per call (the whole call, one
    operation), wrapper time, plain version's time and byte bound over 64
    back-to-back calls at the RetailRocket shape (P1's draw: P1 and the
    port's row-sparse kernel ``separate`` from P1's measurement path, P2
    timed here on the same inputs). Returns {kernel: timing}."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import proto_adagrad, proto_measure as pm

    shapes = [("small", 72, 225, 40, None)] + [s + (None,) for s in pm.MERGED_SHAPES] \
        + list(pm.V3_SHAPES)
    err = {k: 0.0 for k in proto_adagrad.MODES}
    cases = []
    for ci, (name, n, d, K, pool) in enumerate(shapes):
        idx, g, table, acc = pm.draw(n, d, K, pool=pool, steps=1, seed=ci)
        idx, g = idx[0].clone(), g[0]
        idx[:2] = n - 1
        idx[-4:] = SENTINEL
        for kernel in proto_adagrad.MODES:
            e, width, _ = _proto_vs_plain(kernel, idx, g, table, acc)
            err[kernel] = max(err[kernel], e)
            cases.append({"kernel": kernel, "shape": name, "n_rows": n, "d": d, "K": K,
                          "pool": pool, "access_bytes": width, "max_abs_err": e})
    for ci, (name, n, d, raw, dtype, offset) in enumerate(_proto_edges(pm)):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(100 + ci)
        table = torch.randn((n, d), generator=gen, device=DEVICE)
        acc = torch.rand((n, d), generator=gen, device=DEVICE)
        g = torch.randn((len(raw), d), generator=gen, device=DEVICE) * 0.1
        idx = torch.from_numpy(raw.astype(np.int64)).to(DEVICE, dtype)
        for kernel in proto_adagrad.MODES:
            # the plain version on the CPU: a long run's atomic sum on the
            # card lands outside the tolerance by order alone
            e, width, off = _proto_vs_plain(kernel, idx, g, table, acc, offset,
                                            plain_on_cpu=True)
            err[kernel] = max(err[kernel], e)
            cases.append({"kernel": kernel, "shape": f"edge: {name}", "n_rows": n, "d": d,
                          "K": len(raw), "indices": str(dtype).replace("torch.", ""),
                          "base_offset_bytes": 4 * offset, "access_bytes": width,
                          "max_abs_err": e, "bit_equal_exact": True,
                          "table_elems_off_plain": off})
    widths = {(c["kernel"], c["access_bytes"]) for c in cases}
    if not {("P1", 16), ("P1", 8), ("P1", 4), ("P2", 16), ("P2", 8), ("P2", 4)} <= widths:
        raise AssertionError(f"an access width was not exercised: {sorted(widths)}")
    emit({"phase": "proto", "cases": cases})
    _proto_no_sync(pm)

    proto_adagrad.reset_launches()
    merged_recs = {}
    for shape in pm.MERGED_SHAPES:
        for rec in pm.measure_merged(*shape, smi_line):
            emit({"phase": "proto_merged", **rec})
            _one_op(rec, f"proto_merged {rec['dataset']} {rec['variant']}")
            merged_recs[rec["dataset"], rec["variant"]] = rec
    for shape in pm.V3_SHAPES:
        for rec in pm.measure_v3(*shape, smi_line):
            emit({"phase": "proto_v3", **rec})
            _one_op(rec, f"proto_v3 {rec['shape']} {rec['variant']}")
    launches = dict(proto_adagrad.launches_by_mode)
    if not all(launches.values()):
        raise AssertionError(f"a prototype kernel was not launched: {launches}")

    # P1 and the separate layout were timed on this draw by measure_merged
    name, n, d, K = next(s for s in pm.MERGED_SHAPES if s[0] == "retailrocket")
    idx, g, table, acc = pm.draw(n, d, K)
    merged = torch.cat([table, acc], dim=1)
    distinct = pm.distinct_rows(idx, n)
    p2 = pm.record({"shape": f"{n}x{d}", "K": K, "dataset": name}, "v3",
                   lambda s: proto_adagrad.v3_adagrad(table, acc, idx[s], g[s], pm.LR),
                   distinct, d, smi_line)
    recs = {"P1": merged_recs[name, "merged"], "P2": p2,
            "separate": merged_recs[name, "separate"]}
    plain = {
        "P1": lambda s: proto_adagrad.merged_adagrad_plain(merged, idx[s], g[s], pm.LR),
        "P2": lambda s: proto_adagrad.v3_adagrad_plain(table, acc, idx[s], g[s], pm.LR),
    }
    out = {}
    for kernel, rec in recs.items():
        _one_op(rec, f"proto_timing {kernel}")
        out[kernel] = {"launches": launches.get(kernel), "max_abs_err": err.get(kernel),
                       "ms": rec["kernel_us_per_launch"] / 1e3,
                       "ops_per_call": rec["ops_per_call"],
                       "step_ms": rec["us_per_step"] / 1e3,
                       "plain_ms": pm.steps_us(plain[kernel], reps=3) / 1e3
                       if kernel in plain else None,
                       "bound_ms": rec["bound_us"] / 1e3, "bytes": rec["bytes"],
                       "device_ms_per_step": rec["device_us_per_step"] / 1e3}
    emit({"phase": "proto_timing", "shape": name, "n_rows": n, "d": d, "K": K,
          **pm.v3_layout(K, d, distinct), "card": smi_line, **out})
    return out


# --------------------------------------------------------------------- #
# serving, checkpoints, resume and the CLI (scripts/measure_serving.py's
# protocol for the serving numbers)
SERVE_K = 20
SERVE_BATCHES = (1, 64, 256)
SERVE_REPS = 50
RETRAIN_NEW_ITEMS = 500
RETRAIN_EVENTS = 20_000
_SESSION_IDS = itertools.count(10**9, 10**6)


def _fresh_sessions(batch):
    """Session ids that no lane has seen: every lane starts fresh."""
    return next(_SESSION_IDS) + np.arange(batch)


def _serving_twin(model):
    """A second model holding copies of ``model``'s weights and catalog."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.models.gru import map_params

    twin = GRU4Rec(model.config, device=DEVICE)
    twin.params = map_params(torch.clone, model.params)
    twin.itemidmap, twin.n_items = model.itemidmap, model.n_items
    return twin


def phase_serve(model, smi_line):
    """Serving on the train phase's fitted flagship model (36,968 items,
    GRU-224, constrained embedding), after ``scripts/measure_serving.py``:
    ``predict_topk`` at k = 20 and batch 1, 64 and 256 — the warm median
    host ms per call (a call ends with the host fetch of its ids and
    scores), the device ms per call (``torch.profiler``: every operation of
    the call, summed over the calls the tracer kept, per call) and events/s
    over the timed calls; ``predict_next_batch`` once at batch 512. Checks:
    the top-k ids are the argsort of ``predict_next_batch``'s scores where
    the scores are distinct; a lane whose session changed scores as a fresh
    lane does; ``cast_for_serving("bfloat16")`` gives finite scores."""
    from gru4rec_tpu_torch.ops.kernels.proto_measure import device_times

    t_phase = time.time()
    rng = np.random.RandomState(0)
    n = model.n_items
    # requests carry ids of the catalog's own dtype (int64 here), as in
    # scripts/measure_serving.py: an object array would take pandas' slow
    # lookup path (scripts/profile_torch_serving.py --id-dtype object)
    catalog = model.itemidmap.index.values
    vocab = np.asarray(catalog, dtype=object)

    def items(batch):
        return catalog[rng.randint(0, n, batch)]

    out = {"phase": "serve", "n_items": n, "k": SERVE_K, "reps": SERVE_REPS}
    for batch in SERVE_BATCHES:
        sess = _fresh_sessions(batch)
        calls = [items(batch) for _ in range(SERVE_REPS)]
        model.predict_topk(sess, calls[-1], k=SERVE_K, batch=batch)  # warm-up
        wall = []
        for x in calls:
            t0 = time.perf_counter()
            model.predict_topk(sess, x, k=SERVE_K, batch=batch)
            wall.append(time.perf_counter() - t0)
        dev = device_times(
            lambda s: model.predict_topk(sess, calls[s], k=SERVE_K, batch=batch),
            steps=SERVE_REPS)
        ms = float(np.median(wall)) * 1e3
        device_ms = sum(v[0] for v in dev.values()) / SERVE_REPS / 1e3
        out[f"topk_batch{batch}"] = {
            "ms": ms, "device_ms": device_ms, "device_share": device_ms / ms,
            "events_per_s": batch * SERVE_REPS / sum(wall), "device_ops": len(dev)}
    sess, x = _fresh_sessions(512), items(512)
    model.predict_next_batch(sess, x, batch=512)  # warm-up at this width
    t0 = time.perf_counter()
    model.predict_next_batch(sess, items(512), batch=512)
    out["next_batch_batch512_ms"] = (time.perf_counter() - t0) * 1e3

    # top-k against the full score frame, both from fresh lanes
    B = 64
    x = items(B)
    scores = model.predict_next_batch(_fresh_sessions(B), x, batch=B).values.T
    ids, sc = model.predict_topk(_fresh_sessions(B), x, k=SERVE_K, batch=B)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :SERVE_K]
    want = np.take_along_axis(scores, order, axis=1)
    # ids are compared where a score is apart from its neighbours by more
    # than the tolerance (torch.topk may order ties either way)
    gaps = np.diff(want, axis=1)
    apart = gaps < -(ATOL_F32 + RTOL_F32 * np.abs(want[:, 1:]))
    distinct = np.ones(want.shape, dtype=bool)
    distinct[:, 1:] &= apart
    distinct[:, :-1] &= apart
    out["topk_vs_frame"] = {"max_abs_err": float(np.abs(sc - want).max()),
                            "distinct_share": float(distinct.mean())}
    if not (np.allclose(sc, want, rtol=RTOL_F32, atol=ATOL_F32) and distinct.any()
            and np.array_equal(ids[distinct], vocab[order][distinct])):
        raise AssertionError(f"predict_topk disagrees with predict_next_batch: "
                             f"{out['topk_vs_frame']}")

    # a changed session resets its lane only
    s1, x1, x2 = _fresh_sessions(B), items(B), items(B)
    model.predict_next_batch(s1, x1, batch=B)
    s2 = s1.copy()
    s2[5] = _fresh_sessions(1)[0]
    cont = model.predict_next_batch(s2, x2, batch=B).values
    fresh = model.predict_next_batch(_fresh_sessions(B), x2, batch=B).values
    out["lane_reset"] = {"changed_lane_err": float(np.abs(cont[:, 5] - fresh[:, 5]).max()),
                         "kept_lane_diff": float(np.abs(cont[:, 0] - fresh[:, 0]).max())}
    if not (np.allclose(cont[:, 5], fresh[:, 5], rtol=RTOL_F32, atol=ATOL_F32)
            and not np.allclose(cont[:, 0], fresh[:, 0], rtol=RTOL_F32, atol=ATOL_F32)):
        raise AssertionError(f"lane reset: {out['lane_reset']}")

    # bfloat16 serving weights, on a copy
    cast = _serving_twin(model).cast_for_serving("bfloat16")
    x = items(B)
    ids_b, sc_b = cast.predict_topk(_fresh_sessions(B), x, k=SERVE_K, batch=B)
    ids_f, sc_f = model.predict_topk(_fresh_sessions(B), x, k=SERVE_K, batch=B)
    out["bfloat16"] = {"Wy_dtype": str(cast.params["Wy"].dtype).replace("torch.", ""),
                       "finite": bool(np.isfinite(sc_b).all()),
                       "top1_agree": float(np.mean(ids_b[:, 0] == ids_f[:, 0])),
                       "max_rel_diff_top1": float(np.max(np.abs(sc_b[:, 0] - sc_f[:, 0])
                                                         / np.abs(sc_f[:, 0])))}
    if not out["bfloat16"]["finite"] or out["bfloat16"]["Wy_dtype"] != "bfloat16":
        raise AssertionError(f"bfloat16 serving: {out['bfloat16']}")
    out.update(seconds=time.time() - t_phase, card=smi_line)
    emit(out)


def _retrain_split(train):
    """The first ``RETRAIN_EVENTS`` training events, with
    ``RETRAIN_NEW_ITEMS`` of their items renamed to ids the catalog lacks."""
    part = train.iloc[:RETRAIN_EVENTS].copy()
    vals = part["ItemId"].values.copy()
    chosen = np.sort(np.random.RandomState(2).choice(
        np.unique(vals), size=RETRAIN_NEW_ITEMS, replace=False))
    hit = np.isin(vals, chosen)
    vals[hit] = N_ITEMS + np.searchsorted(chosen, vals[hit])
    part["ItemId"] = vals
    return part


def phase_checkpoint(model, smi_line):
    """``savemodel(include_optimizer=True)`` of the train phase's flagship
    model, ``loadmodel`` on the card: the ``predict_topk`` scores of both
    from fresh lanes equal bit for bit, and the optimizer leaves too; then
    ``fit(retrain=True)`` of the loaded model for one epoch on training
    data with ``RETRAIN_NEW_ITEMS`` unseen items: the tables grow, K1
    launches once per step (counts set to 0 just before, read just after),
    the weights stay finite."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.io.checkpoint import flatten_opt_state
    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.npz")
        t0 = time.perf_counter()
        model.savemodel(path, include_optimizer=True)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = GRU4Rec.loadmodel(path, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    x = model.itemidmap.index.values[np.random.RandomState(3).randint(0, model.n_items, 64)]
    sess = _fresh_sessions(64)
    ids_a, sc_a = model.predict_topk(sess, x, k=SERVE_K, batch=64)
    ids_b, sc_b = loaded.predict_topk(sess, x, k=SERVE_K, batch=64)
    scores_equal = (np.array_equal(sc_a.view(np.uint32), sc_b.view(np.uint32))
                    and np.array_equal(ids_a, ids_b))
    leaves = list(zip(flatten_opt_state(model._train_state.opt_state),
                      flatten_opt_state(loaded._train_state.opt_state)))
    leaves_equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in leaves)
    if not (scores_equal and leaves_equal and loaded._train_state.step
            == model._train_state.step):
        raise AssertionError(f"the reloaded model differs: scores equal {scores_equal}, "
                             f"optimizer leaves equal {leaves_equal}")

    train, _ = synth_split()
    data = _retrain_split(train)
    rows_before = loaded.params["Wy"].shape[0]
    sparse_update.reset_launches()
    loaded.fit(data, retrain=True, n_epochs=1)
    torch.cuda.synchronize()
    by_mode = dict(sparse_update.launches_by_mode)
    steps = loaded.epoch_stats[-1]["steps"]
    n_total = N_ITEMS + RETRAIN_NEW_ITEMS
    rows = pad_items(n_total, loaded.config.item_pad_multiple)
    acc = loaded._train_state.opt_state["sparse"]["Wy"]["acc"]
    out = {"phase": "checkpoint", "archive_bytes": nbytes, "save_s": save_s,
           "load_s": load_s, "opt_leaves": len(leaves), "topk_bit_equal": scores_equal,
           "retrain": {"events": len(data), "new_items": RETRAIN_NEW_ITEMS,
                       "n_items": loaded.n_items, "Wy_rows": [rows_before, rows],
                       "steps": steps, "loss": loaded.epoch_stats[-1]["loss"],
                       "launches": by_mode},
           "seconds": time.time() - t_phase, "card": smi_line}
    emit(out)
    if not (loaded.n_items == n_total and loaded.params["Wy"].shape[0] == rows > rows_before
            and acc.shape[0] == rows):
        raise AssertionError(f"the tables did not grow to {n_total} items: {out['retrain']}")
    if by_mode != {m: (steps if m == "K1" else 0) for m in sparse_update.MODES}:
        raise AssertionError(f"retrain launched {by_mode} over {steps} steps")
    if not (bool(torch.isfinite(loaded.params["Wy"]).all())
            and math.isfinite(loaded.epoch_stats[-1]["loss"])):
        raise AssertionError("retrain left non-finite weights")


def resume_cfg():
    """The verify recipe's markov drive with adagrad and ``bfloat16_sr``
    state (K2 on Wy), three epochs: a run resumed after the first profiles
    its second epoch, the third."""
    from gru4rec_tpu_torch import GRU4RecConfig

    return GRU4RecConfig(loss="bpr-max", layers=[64], batch_size=32, n_sample=64,
                         n_epochs=3, constrained_embedding=True, adapt="adagrad",
                         opt_state_dtype="bfloat16_sr")


def _max_diff(a, b):
    """The largest absolute difference between the tensors of two trees
    (dicts and lists of tensors) of the same layout."""
    from gru4rec_tpu_torch.io.checkpoint import flatten_opt_state

    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(flatten_opt_state(a), flatten_opt_state(b)))


def _state(model):
    """A model's parameters and optimizer state, as one tree."""
    return [model.params, model._train_state.opt_state]


def phase_resume(smi_line):
    """Exact resume across a training checkpoint, on the markov chain with
    SR state (K2): two uninterrupted runs (their difference is
    ``repeat_diff``), one epoch with ``checkpoint_every=1`` then
    ``resume=`` for the rest, which also writes a ``profile_dir`` trace
    (its difference from the uninterrupted run is ``resume_diff``; K2
    launches once per resumed step); ``resume_diff <= repeat_diff``. Then
    ``eval_data`` with ``early_stop_patience`` and ``keep_best``: the kept
    parameters equal those of the best epoch's run."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    t_phase = time.time()
    train, valid = markov(800), markov(100, seed=5)

    def run(**kw):
        return GRU4Rec(resume_cfg(), device=DEVICE).fit(train, **kw)

    with _schedules() as schedules:
        straight = [run(), run()]
        repeat_diff = _max_diff(*map(_state, straight))
        with tempfile.TemporaryDirectory() as tmp:
            ck, prof = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "profile")
            first = run(n_epochs=1, checkpoint_every=1, checkpoint_path=ck)
            sparse_update.reset_launches()
            resumed = run(resume=ck, profile_dir=prof)
            torch.cuda.synchronize()
            by_mode = dict(sparse_update.launches_by_mode)
            traces = {f: os.path.getsize(os.path.join(prof, f)) for f in os.listdir(prof)}
        resume_diff = _max_diff(_state(resumed), _state(straight[0]))
        steps = sum(e["steps"] for e in resumed.epoch_stats)

        kept = run(eval_data=valid, eval_metric="mrr", early_stop_patience=1,
                   keep_best=True)
        mrrs = [v["mrr"] for v in kept.valid_stats]
        best = 1 + int(np.argmax(mrrs))  # the first of equal scores, as fit() keeps
        ref = {1: first, 2: run(n_epochs=2), 3: straight[0]}[best]
        keep_diff = _max_diff(kept.params, ref.params)
    out = {"phase": "resume", "repeat_diff": repeat_diff, "resume_diff": resume_diff,
           "losses": [e["loss"] for e in straight[0].epoch_stats],
           "resumed_losses": [e["loss"] for e in resumed.epoch_stats],
           "resumed_steps": steps, "launches": by_mode, "trace_bytes": traces,
           "valid_mrr": mrrs, "best_epoch": best, "keep_best_diff": keep_diff,
           **schedules, "seconds": time.time() - t_phase, "card": smi_line}
    emit(out)
    if by_mode != {m: (steps if m == "K2" else 0) for m in sparse_update.MODES}:
        raise AssertionError(f"the resumed run launched {by_mode} over {steps} steps")
    if not resume_diff <= repeat_diff:
        raise AssertionError(f"resume_diff {resume_diff} > repeat_diff {repeat_diff}")
    if list(traces) != ["trace_epoch3.json"] or not all(traces.values()):
        raise AssertionError(f"profile_dir holds {traces}")
    if not (kept.valid_stats and keep_diff <= repeat_diff):
        raise AssertionError(f"keep_best kept parameters {keep_diff} off epoch {best}'s")
    _check_schedules("resume", schedules, None)


def _param_string(params):
    return ",".join(f"{k}={'/'.join(map(str, v)) if isinstance(v, list) else v}"
                    for k, v in params.items())


def _cli(args, env):
    """``python -m gru4rec_tpu_torch.cli.run`` in a subprocess from the
    checkout's root: (result, seconds, PRIMARY METRIC or None)."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "gru4rec_tpu_torch.cli.run", *args],
                         capture_output=True, text=True, timeout=600, env=env,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    pm = [ln for ln in res.stdout.splitlines() if ln.startswith("PRIMARY METRIC:")]
    return res, time.time() - t0, (float(pm[-1].split(":")[1]) if pm else None)


def phase_cli(smi_line):
    """The CLI on the card, as subprocesses: the flagship parameter string
    on the flagship split written to TSV, training, saving and evaluating
    (``-s model.npz -t test.tsv -m 1 5 20 -lpm``); ``-l model.npz`` on the
    archive, which must print the same ``PRIMARY METRIC:``; a markov run
    with ``learning_rate=nan``, which must exit 2 and dump its state to
    ``GRU4REC_TPU_NAN_DUMP`` (a temporary path, so nothing lands in the
    working directory)."""
    t_phase = time.time()
    train, test = synth_split()
    with tempfile.TemporaryDirectory() as tmp:
        train_p, test_p, markov_p, model_p, dump = (
            os.path.join(tmp, f) for f in ("train.tsv", "test.tsv", "markov.tsv",
                                           "model.npz", "nan_dump.npz"))
        train.to_csv(train_p, sep="\t", index=False)
        test.to_csv(test_p, sep="\t", index=False)
        markov(800).to_csv(markov_p, sep="\t", index=False)
        env = {**os.environ, "GRU4REC_TPU_NAN_DUMP": dump}
        fit, fit_s, fit_pm = _cli([train_p, "-ps", _param_string(FLAGSHIP), "-s", model_p,
                                   "-t", test_p, "-m", "1", "5", "20", "-lpm"], env)
        load, load_s, load_pm = _cli([model_p, "-l", "-t", test_p, "-m", "1", "5", "20",
                                      "-lpm"], env)
        nan, nan_s, _ = _cli([markov_p, "-ps", "loss=bpr-max,layers=64,batch_size=32,"
                              "n_sample=64,n_epochs=1,constrained_embedding=True,"
                              "learning_rate=nan"], env)
        dumped = os.path.exists(dump)
    out = {"phase": "cli", "train_rc": fit.returncode, "train_s": fit_s,
           "train_primary_metric": fit_pm, "load_rc": load.returncode, "load_s": load_s,
           "load_primary_metric": load_pm, "nan_rc": nan.returncode, "nan_s": nan_s,
           "nan_dumped": dumped, "seconds": time.time() - t_phase, "card": smi_line}
    emit(out)
    for name, res, rc in (("train", fit, 0), ("load", load, 0), ("nan", nan, 2)):
        if res.returncode != rc:
            raise AssertionError(f"cli {name} exited {res.returncode}, not {rc}:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    if fit_pm is None or fit_pm != load_pm:
        raise AssertionError(f"PRIMARY METRIC {fit_pm} after training, {load_pm} loaded")
    if not dumped or "training diverged" not in nan.stdout:
        raise AssertionError(f"the NaN run did not report or dump:\n{nan.stdout[-3000:]}")
    if os.path.exists("gru4rec_nan_dump.npz"):
        raise AssertionError("a NaN dump landed in the working directory")


SCHEDULE_EVENTS = 750_000  # bench.py's RetailRocket length (N_EVENTS_TARGET)
SCHEDULE_REPS = 5


def _schedule_inputs(train):
    """What ``fit`` hands the schedule builder for ``train``: the dense item
    indices, the session offsets and the session order."""
    from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap
    from gru4rec_tpu_torch.data.scheduler import session_order
    from gru4rec_tpu_torch.data.tools import compute_offset, sort_if_needed

    data = apply_itemidmap(train, build_itemidmap(train, "ItemId"), "ItemId")
    sort_if_needed(data, ["SessionId", "Time"])
    offsets = compute_offset(data, "SessionId")
    order = session_order(data, "SessionId", "Time", False, len(offsets) - 1)
    return data["ItemIdx"].values.astype(np.int32), offsets, order


def phase_scheduler(smi_line):
    """The native schedule builder against the numpy builder at the
    flagship's batch, on the train phase's split and on a RetailRocket-length
    split: the four arrays equal, and the median host ms of
    ``SCHEDULE_REPS`` builds each way."""
    from gru4rec_tpu_torch.data import _native_scheduler
    from gru4rec_tpu_torch.data.scheduler import _build_schedule_numpy

    t_phase = time.time()
    if not _native_scheduler.available():
        raise AssertionError("the native scheduler is not available (no g++?)")
    out = {"phase": "scheduler", "batch_size": FLAGSHIP["batch_size"]}
    for name, n_events in (("train", N_EVENTS), ("retailrocket", SCHEDULE_EVENTS)):
        args = (*_schedule_inputs(synth_split(n_events=n_events)[0]),
                FLAGSHIP["batch_size"], False)
        times, built = {}, {}
        for way, fn in (("native", _native_scheduler.build_schedule),
                        ("numpy", _build_schedule_numpy)):
            wall = []
            for _ in range(SCHEDULE_REPS):
                t0 = time.perf_counter()
                built[way] = fn(*args)
                wall.append(time.perf_counter() - t0)
            times[way] = float(np.median(wall)) * 1e3
        equal = all(np.array_equal(getattr(built["native"], f), getattr(built["numpy"], f))
                    for f in ("in_idx", "out_idx", "valid", "reset"))
        out[name] = {"events": len(args[0]), "sessions": len(args[1]) - 1,
                     "steps": built["native"].n_steps, "native_ms": times["native"],
                     "numpy_ms": times["numpy"],
                     "numpy_over_native": times["numpy"] / times["native"],
                     "equal": equal}
        if not equal or built["native"].n_steps != built["numpy"].n_steps:
            raise AssertionError(f"native and numpy schedules differ on {name}: {out[name]}")
    out.update(seconds=time.time() - t_phase, card=smi_line)
    emit(out)


LEGACY_CUT_OFF = 20
LEGACY_BATCH = 100
LEGACY_TOL = 0.03  # two walks that refill lanes in another order


def phase_legacy_eval(model, smi_line):
    """The legacy evaluators on the train phase's flagship model and its
    test split: ``evaluate_sessions_batch`` (``predict_next_batch`` per step
    and host ranking) against ``evaluate``, recall and MRR @20 within
    ``LEGACY_TOL``; ``Pop`` and ``ItemKNN`` fitted on the train split and
    scored by ``evaluate_sessions``. Seconds and events/s of each, and the
    device memory peak of ``evaluate``."""
    import torch

    from gru4rec_tpu_torch import evaluate
    from gru4rec_tpu_torch.baselines import ItemKNN, Pop
    from gru4rec_tpu_torch.eval import evaluate_sessions, evaluate_sessions_batch

    t_phase = time.time()
    train, test = synth_split()
    n_events = int((test.groupby("SessionId").size() - 1).sum())
    out = {"phase": "legacy_eval", "cut_off": LEGACY_CUT_OFF, "batch_size": LEGACY_BATCH,
           "test_events": n_events}

    def timed(name, fn):
        t0 = time.perf_counter()
        rec, mrr = fn()
        seconds = time.perf_counter() - t0
        out[name] = {"recall": rec, "mrr": mrr, "seconds": seconds,
                     "events_per_s": n_events / seconds}
        if not (0.0 <= mrr <= rec <= 1.0):
            raise AssertionError(f"{name}: metric out of range: {out[name]}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def gpu():
        rec, mrr = evaluate(model, test, cut_off=[LEGACY_CUT_OFF], batch_size=LEGACY_BATCH)
        return rec[0], mrr[0]

    timed("evaluate", gpu)
    out["evaluate"].update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                           memory_allocated_before=base)
    timed("evaluate_sessions_batch", lambda: evaluate_sessions_batch(
        model, test, cut_off=LEGACY_CUT_OFF, batch_size=LEGACY_BATCH))
    for name, pr in (("Pop", Pop()), ("ItemKNN", ItemKNN())):
        t0 = time.perf_counter()
        pr.fit(train)
        fit_s = time.perf_counter() - t0
        timed(name, lambda: evaluate_sessions(pr, test, train, cut_off=LEGACY_CUT_OFF))
        out[name]["fit_seconds"] = fit_s
    out.update(seconds=time.time() - t_phase, card=smi_line)
    emit(out)
    diff = {k: abs(out["evaluate_sessions_batch"][k] - out["evaluate"][k])
            for k in ("recall", "mrr")}
    if max(diff.values()) > LEGACY_TOL:
        raise AssertionError(f"evaluate_sessions_batch is {diff} off evaluate")


PAROPT_SPACE = (
    '{"name": "learning_rate", "dtype": "float", "values": [0.02, 0.1], "log": true}\n'
    '{"name": "momentum", "dtype": "float", "values": [0.2, 0.6], "step": 0.1}\n')


def phase_paropt(smi_line):
    """``python -m gru4rec_tpu_torch.cli.paropt`` on the flagship split as
    TSV files: the flagship's parameters but learning rate and momentum
    fixed, a random search of two trials over those two, the final run at
    @1, 5 and 20; the trials' JSONL log through ``-tf``. K1 runs in the
    children, uncounted."""
    from gru4rec_tpu_torch.cli.paropt import scrape_primary_metric

    t_phase = time.time()
    train, test = synth_split()
    fixed = {k: v for k, v in FLAGSHIP.items() if k not in ("learning_rate", "momentum")}
    with tempfile.TemporaryDirectory() as tmp:
        train_p, test_p, space_p, log_p = (
            os.path.join(tmp, f) for f in ("train.tsv", "test.tsv", "space.jsonl",
                                           "trials.jsonl"))
        train.to_csv(train_p, sep="\t", index=False)
        test.to_csv(test_p, sep="\t", index=False)
        with open(space_p, "w") as f:
            f.write(PAROPT_SPACE)
        res = subprocess.run(
            [sys.executable, "-m", "gru4rec_tpu_torch.cli.paropt", train_p, test_p,
             "-fp", _param_string(fixed), "-opf", space_p, "-nt", "2", "-m", "20",
             "-fm", "1", "5", "20", "-tf", f"GRU4REC_TPU_LOG_JSONL={log_p}"],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        events = ([json.loads(ln) for ln in open(log_p)] if os.path.exists(log_p)
                  else [])
    lines = res.stdout.splitlines()
    trials = [ln.split(": ", 1)[1] for ln in lines if ln.startswith("--- trial ")]
    metrics = [m for m in map(scrape_primary_metric, lines) if m is not None]
    best = [float(ln.split(":")[1]) for ln in lines if ln.startswith("Best value:")]
    final = res.stdout.split("Running final eval @[1, 5, 20]:")[-1]
    epochs = [e for e in events if e["event"] == "epoch"]
    out = {"phase": "paropt", "rc": res.returncode, "trials": trials, "metrics": metrics,
           "best_value": best[0] if best else None,
           "final": [ln for ln in final.splitlines() if ln.startswith("Recall@")],
           "epoch_events": len(epochs),
           "events_per_s": [e["e_per_s"] for e in epochs],
           "seconds": time.time() - t_phase, "card": smi_line}
    emit(out)
    if res.returncode != 0:
        raise AssertionError(f"paropt exited {res.returncode}:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    if len(metrics) != 2 or best != [max(metrics)]:
        raise AssertionError(f"paropt scraped {metrics}, best {best}")
    if [ln.split(":")[0] for ln in out["final"]] != ["Recall@1", "Recall@5", "Recall@20"]:
        raise AssertionError(f"the final run printed {out['final']}")
    if len(epochs) != 3 or len(events) != 3:
        raise AssertionError(f"the trials' log holds {events}: -tf did not reach "
                             f"every child")


# ---------------------------------------------------------------------- #
# mesh: the (data, model) mesh over torch.distributed (parallel/)
MESH_MODEL_SHARDS = (2, 4)  # mesh_shard_kernel's row-shard counts
MESH_STEPS = 300            # mesh_2x2_shared_card's depth: the split's first steps
# mesh_2x2_shared_card's cases: float32 products and state, the settings of
# the JAX package's mesh parity tests (tests/test_parallel.py:47-50): a
# bfloat16 rounding turns the sums' other order into an ulp of 2**-8, and the
# runs drift apart; the SR case stores the accumulator in bfloat16 (K2)
MESH_CASES = {"train": {"compute_dtype": "float32", "opt_state_dtype": "float32"},
              "train_sr": {"compute_dtype": "float32", "opt_state_dtype": "bfloat16_sr"}}
MESH_RANK_TIMEOUT = 600     # seconds for the four ranks together


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(_bits_equal(a, b).all())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _shard_calls(opt, table, idx_t, g, st, sr_seed, n_model):
    """The whole-table call, then one call per row-shard on a copy of its
    rows with its local indices (rows of other shards the sentinel) and
    ``sr_seed`` offset to the shard's first row. Returns each shard's first
    row, its max abs error against the whole call's rows and whether all
    of its tensors are bit-equal to them."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import sparse_update

    rows = table.shape[0] // n_model
    t_w, st_w = table.clone(), {k: v.clone() for k, v in st.items()}
    sparse_update.fused_update(opt, t_w, idx_t, g, st_w, sr_seed=sr_seed)
    shards = []
    for mi in range(n_model):
        r0 = mi * rows
        t_s = table[r0:r0 + rows].clone()
        st_s = {k: v[r0:r0 + rows].clone() for k, v in st.items()}
        idx_l = torch.where((idx_t >= r0) & (idx_t < r0 + rows), idx_t - r0, SENTINEL)
        sparse_update.fused_update(opt, t_s, idx_l, g, st_s,
                                   sr_seed=None if sr_seed is None else (sr_seed[0], r0))
        shards.append((r0, [t_s] + [st_s[k] for k in st]))
    torch.cuda.synchronize()
    out = []
    for r0, got in shards:
        want = [t_w[r0:r0 + rows]] + [st_w[k][r0:r0 + rows] for k in st]
        out.append((r0, max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(got, want)),
                    all(_same_bits(a, b) for a, b in zip(got, want))))
    return out


def phase_mesh_shard_kernel(smi_line):
    """The row-sparse kernel on row-shards, as each model rank of a mesh
    calls it: K1 and K2 on the flagship ``Wy`` (36,992 x 256, K = 2,208),
    K4 on the RSC15 ``Wx0`` (37,504 x 300, K = 32), cut into 2 and 4
    shards; the shards' tables and state bit-equal to the whole-table
    call's."""
    from gru4rec_tpu_torch.models.gru import pad_cols, pad_items

    rng = np.random.RandomState(5)
    n_rows, d = pad_items(N_ITEMS, 128), pad_cols(224 + 1)
    idx = _index_sets(rng, N_ITEMS, 2 * 80 + 2048, 80, 1)[0]
    cases = {
        "K1": (_make_case("adagrad", 0.4, 0.0, "bfloat16", n_rows, d, idx, 11), None),
        "K2": (_make_case("adagrad", 0.4, 0.0, "bfloat16_sr", n_rows, d, idx, 12), SR_SEED),
        "K4": (_make_case("adagrad", 0.3, 0.0, "bfloat16", pad_items(RSC15_ITEMS, 128), 300,
                          _lane_set(rng, RSC15_ITEMS, 32), 13), None),
    }
    for name, ((opt, table, idx_t, g, st), sr_seed) in cases.items():
        for n_model in MESH_MODEL_SHARDS:
            shards = _shard_calls(opt, table, idx_t, g, st, sr_seed, n_model)
            rec = {"phase": "mesh_shard_kernel", "case": name, "n_model": n_model,
                   "shape": list(table.shape), "K": int(idx_t.shape[0]),
                   "r0": [r0 for r0, _, _ in shards],
                   "max_abs_err": [e for _, e, _ in shards],
                   "bit_equal": all(eq for _, _, eq in shards), "card": smi_line}
            emit(rec)
            if not rec["bit_equal"]:
                raise AssertionError(f"{name} on {n_model} row-shards differs from the "
                                     f"whole-table call: {rec}")


def phase_mesh_1x1(flagship, train_rec, smi_line):
    """``fit(mesh=make_mesh(1, 1))`` of the flagship over NCCL on ``cuda:0``
    for the train phase's epoch, ``evaluate(mesh=)`` and
    ``predict_topk(mesh=)``: bit-equal to the train phase's model and to
    the single-device calls; K1 once per step; the warm median ms per
    ``predict_topk`` call, mesh and single-device in turns, the mesh call's
    device ms (as ``serve`` reads it) and events/s at batch 1, 64 and 256;
    the seconds ``make_mesh`` takes (it sets up each group's communicator)."""
    import torch
    import torch.distributed as dist

    from gru4rec_tpu_torch import GRU4Rec, evaluate
    from gru4rec_tpu_torch.ops.kernels import sparse_update
    from gru4rec_tpu_torch.ops.kernels.proto_measure import device_times
    from gru4rec_tpu_torch.parallel import make_mesh

    t_phase = time.time()
    train, test = synth_split()
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1)
    mesh_seconds = time.perf_counter() - t0
    try:
        model = GRU4Rec(flagship_cfg(), device=DEVICE)
        sparse_update.reset_launches()
        model.fit(train, mesh=mesh)
        torch.cuda.synchronize()
        launches = dict(sparse_update.launches_by_mode)
        rec, mrr = evaluate(model, test, cut_off=[1, 5, 20], batch_size=512, mesh=mesh)
        want = dict(_leaves({"params": flagship._train_state.params,
                             "opt_state": flagship._train_state.opt_state}))
        got = dict(_leaves({"params": model._train_state.params,
                            "opt_state": model._train_state.opt_state}))
        differ = [k for k in want if k not in got or not _same_bits(got[k], want[k].cpu())]
        steps = sum(e["steps"] for e in model.epoch_stats)
        out = {"phase": "mesh_1x1", "backend": dist.get_backend(), "device": str(mesh.device),
               "mesh_seconds": mesh_seconds, "steps": steps, "loss": model.epoch_stats[-1]["loss"],
               "train_loss": flagship.epoch_stats[-1]["loss"],
               "events_per_s": model.epoch_stats[-1]["events"] / model.epoch_stats[-1]["seconds"],
               "leaves": len(want), "leaves_differ": differ,
               "recall": dict(zip(("@1", "@5", "@20"), rec)),
               "mrr": dict(zip(("@1", "@5", "@20"), mrr)), "launches": launches}
        rng = np.random.RandomState(1)
        catalog = model.itemidmap.index.values
        for batch in SERVE_BATCHES:
            calls = [catalog[rng.randint(0, model.n_items, batch)] for _ in range(SERVE_REPS)]
            ids_m, sc_m = model.predict_topk(_fresh_sessions(batch), calls[0], k=SERVE_K,
                                             batch=batch, mesh=mesh)
            ids_s, sc_s = model.predict_topk(_fresh_sessions(batch), calls[0], k=SERVE_K,
                                             batch=batch)
            sess = _fresh_sessions(batch)
            wall = {"mesh": [], "single": []}
            for x in calls:  # in turns
                for name, m in (("mesh", mesh), ("single", None)):
                    t0 = time.perf_counter()
                    model.predict_topk(sess, x, k=SERVE_K, batch=batch, mesh=m)
                    wall[name].append(time.perf_counter() - t0)
            dev = device_times(lambda i: model.predict_topk(sess, calls[i], k=SERVE_K,
                                                            batch=batch, mesh=mesh),
                               steps=SERVE_REPS)
            out[f"topk_batch{batch}"] = {
                "same_as_single": bool(np.array_equal(ids_m, ids_s)
                                       and np.array_equal(sc_m, sc_s)),
                "ms": float(np.median(wall["mesh"])) * 1e3,
                "single_ms": float(np.median(wall["single"])) * 1e3,
                "device_ms": sum(v[0] for v in dev.values()) / SERVE_REPS / 1e3,
                "events_per_s": batch * SERVE_REPS / sum(wall["mesh"])}
    finally:
        dist.destroy_process_group()
    out.update(seconds=time.time() - t_phase, card=smi_line)
    emit(out)
    if out["backend"] != "nccl" or differ or out["loss"] != out["train_loss"]:
        raise AssertionError(f"mesh_1x1 differs from the train phase: {out}")
    if out["recall"] != train_rec["recall"] or out["mrr"] != train_rec["mrr"]:
        raise AssertionError(f"mesh_1x1 metrics {out['recall']} {out['mrr']} against "
                             f"{train_rec['recall']} {train_rec['mrr']}")
    if launches != {**dict.fromkeys(sparse_update.MODES, 0), "K1": steps}:
        raise AssertionError(f"mesh_1x1 launched {launches} in {steps} steps")
    if not all(out[f"topk_batch{b}"]["same_as_single"] for b in SERVE_BATCHES):
        raise AssertionError(f"predict_topk(mesh=) differs from the single-device call: {out}")


def _flagship_schedule(cfg):
    """What ``fit`` builds from the train split (the item map, the
    schedule, the alias table), and the test split."""
    from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap
    from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order
    from gru4rec_tpu_torch.data.tools import compute_offset, sort_if_needed
    from gru4rec_tpu_torch.ops.sampling import build_alias_table

    train, test = synth_split()
    itemidmap = build_itemidmap(train, "ItemId")
    data = apply_itemidmap(train, itemidmap, "ItemId")
    sort_if_needed(data, ["SessionId", "Time"])
    offsets = compute_offset(data, "SessionId")
    order = session_order(data, "SessionId", "Time", cfg.time_sort, len(offsets) - 1)
    sched = build_schedule(data["ItemIdx"].values.astype(np.int32), offsets, order,
                           cfg.batch_size)
    pop = (data.groupby("ItemId").size()
           .reindex(itemidmap.index.values, fill_value=0).values)
    return itemidmap, sched, build_alias_table(pop, cfg.sample_alpha), test


def _flagship_steps(cfg, mesh=None):
    """The flagship's first ``MESH_STEPS`` steps at full width through the
    chunk function, on ``DEVICE`` or on ``mesh``, then ``evaluate`` @20 on
    the test split. Returns the record and the canonical state."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec, evaluate
    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.ops.kernels import sparse_update
    from gru4rec_tpu_torch.parallel.dist_step import (make_dist_chunk_fn, shard_train_state,
                                                      unshard_train_state)
    from gru4rec_tpu_torch.train.step import init_train_state, make_chunk_fn, make_generator

    itemidmap, sched, packed, test = _flagship_schedule(cfg)
    n = len(itemidmap)
    dev = torch.device(DEVICE) if mesh is None else mesh.device
    model = GRU4Rec(cfg, device=dev)  # sets the card's float32 matmuls
    if mesh is None:
        state, fn = init_train_state(cfg, n, dev), make_chunk_fn(cfg, n)
    else:
        state = init_train_state(cfg, n, "cpu")
        state.gen = make_generator(cfg.seed, dev)
        state, fn = shard_train_state(state, cfg, mesh), make_dist_chunk_fn(cfg, n, mesh)
    steps = [a[:MESH_STEPS] for a in (sched.in_idx, sched.out_idx, sched.valid, sched.reset)]
    sparse_update.reset_launches()
    t0 = time.perf_counter()
    loss, events = fn(state, *steps, torch.from_numpy(packed).to(dev),
                      torch.zeros(pad_items(n, cfg.item_pad_multiple), device=dev))
    loss = float(loss)
    seconds = time.perf_counter() - t0
    launches = dict(sparse_update.launches_by_mode)
    canon = state if mesh is None else unshard_train_state(state, cfg, mesh)
    model.itemidmap, model.n_items, model.params = itemidmap, n, canon.params
    rec, _ = evaluate(model, test, cut_off=[20], batch_size=512, mesh=mesh)
    return {"steps": int((steps[2].sum(axis=1) > 0).sum()), "events": events, "loss": loss,
            "seconds": seconds, "events_per_s": events / seconds, "launches": launches,
            "recall20": rec[0],
            "acc_sum": float(canon.opt_state["sparse"]["Wy"]["acc"].double().sum())}, canon


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_rank_main(rank, port, out_dir) -> int:
    """One rank of ``mesh_2x2_shared_card`` (``chip_smoke.py --mesh-rank
    <rank> <port> <dir>``): a 2x2 mesh of four processes on ``cuda:0`` over
    gloo; the flagship's first steps in each ``MESH_CASES`` case; its
    record to ``<dir>/rank<r>.json`` (rank 0 also the float32 case's ``Wy``
    as ``Wy.npy``)."""
    import torch.distributed as dist

    rank = int(rank)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="4", LOCAL_RANK="0")
    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 2, device="cuda:0", backend="gloo")
    rows = pad_items(N_ITEMS, 128) // mesh.shape["model"]
    rec = {"rank": rank, "di": mesh.di, "mi": mesh.mi, "r0": mesh.mi * rows,
           "backend": dist.get_backend(), "device": str(mesh.device), "cases": {}}
    print(json.dumps(rec), flush=True)
    for case, kw in MESH_CASES.items():
        rec["cases"][case], canon = _flagship_steps(flagship_cfg(**kw), mesh)
        if rank == 0 and case == "train":
            np.save(os.path.join(out_dir, "Wy.npy"), canon.params["Wy"].numpy())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def phase_mesh_2x2_shared_card(smi_line):
    """A 2x2 mesh of four ranks that this script spawns, all on ``cuda:0``
    over gloo (NCCL takes one rank per card), against one device over the
    same events: the flagship at full width for its first ``MESH_STEPS``
    steps, loss within rtol 1e-4, ``Wy`` within rtol 2e-4 / atol 1e-6,
    Recall@20 within 1e-3; the ``bfloat16_sr`` case's summed ``Wy``
    accumulator within ``SR_ACC_REL_LIMIT`` of the float32 run's; K1 (K2
    under SR) once per step on every rank. A rank that fails or outlives
    ``MESH_RANK_TIMEOUT`` fails the phase."""
    import torch

    t_phase = time.time()
    ref, ref_state = _flagship_steps(flagship_cfg(**MESH_CASES["train"]))
    ref_wy = ref_state.params["Wy"].cpu().numpy()
    del ref_state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(4)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(r), str(port), tmp], stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(4)]
        deadline = time.time() + MESH_RANK_TIMEOUT
        failed = []
        try:
            for r, p in enumerate(procs):
                try:
                    if p.wait(timeout=max(1.0, deadline - time.time())) != 0:
                        failed.append(f"rank {r} exited {p.returncode}")
                except subprocess.TimeoutExpired:
                    failed.append(f"rank {r} timed out")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if failed:
            tails = "\n".join(f"--- rank {r}\n" + open(os.path.join(tmp, f"rank{r}.log"))
                              .read()[-4000:] for r in range(4))
            raise AssertionError(f"mesh_2x2_shared_card: {failed}\n{tails}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(4)]
        wy = np.load(os.path.join(tmp, "Wy.npy"))
    for rec in ranks:
        emit({"phase": "mesh_rank", **{k: rec[k] for k in ("rank", "di", "mi", "r0",
                                                           "backend", "device")}})
    mesh_f32, mesh_sr = ranks[0]["cases"]["train"], ranks[0]["cases"]["train_sr"]
    out = {"phase": "mesh_2x2_shared_card", "steps": mesh_f32["steps"],
           "single": ref, "mesh": ranks[0]["cases"],
           "loss_rel_err": abs(mesh_f32["loss"] - ref["loss"]) / abs(ref["loss"]),
           "Wy_max_abs_err": float(np.abs(wy - ref_wy).max()),
           "recall20_diff": abs(mesh_f32["recall20"] - ref["recall20"]),
           "sr_acc_rel_err": abs(mesh_sr["acc_sum"] - ref["acc_sum"]) / ref["acc_sum"],
           "launches_by_rank": [{c: r["cases"][c]["launches"] for c in MESH_CASES}
                                for r in ranks],
           "seconds": time.time() - t_phase, "card": smi_line}
    emit(out)
    bad = [r["rank"] for r in ranks if r["backend"] != "gloo" or any(
        r["cases"][c]["loss"] != ranks[0]["cases"][c]["loss"] for c in MESH_CASES)]
    for r in ranks:
        for case, mode in (("train", "K1"), ("train_sr", "K2")):
            got = r["cases"][case]["launches"]
            if got != {**{m: 0 for m in got}, mode: r["cases"][case]["steps"]}:
                bad.append(f"rank {r['rank']} {case} launches {got}")
    if bad:
        raise AssertionError(f"mesh_2x2_shared_card ranks disagree: {bad}")
    if not (out["loss_rel_err"] <= 1e-4 and np.allclose(wy, ref_wy, rtol=2e-4, atol=1e-6)
            and out["recall20_diff"] <= 1e-3 and out["sr_acc_rel_err"] <= SR_ACC_REL_LIMIT):
        raise AssertionError(f"mesh_2x2_shared_card against one device: {out}")


# depth: the paramfiles' 100,000 events, the rsc15 family's (batch 32) cut
# to 40,000; each at least twice its catalog, so every item is in training
PUBLISHED_EVENTS = 100_000
PUBLISHED_RSC15_EVENTS = 40_000
PUBLISHED_LEARN_EPOCHS = 3
LEARN_RECALL5 = 0.9  # published_learn's bar: a random ranking gives 5/60
# The one-hot bpr-max config learns the 60-item chain slowly in both
# packages: after 3 epochs at its seed, Recall@5 is under 0.9 in JAX and
# in the port on the CPU (tests/test_torch_published.py prints both), so
# its bar asks for learning (six times a random ranking), not for 0.9.
ONEHOT_BPR_LEARN_RECALL5 = 0.5


def published_configs():
    """The nine published configurations at their published width, loss,
    ``logq``, dropout, momentum and batch, loaded through the port's
    harnesses: {name: (config, dataset)}. The six paramfiles through
    ``reproduce_published.load_config`` (name = dataset), the three CIKM'18
    configurations from ``run_rsc15.CONFIGS`` (``rsc15:<config>``)."""
    from gru4rec_tpu_torch import GRU4RecConfig
    from gru4rec_tpu_torch.examples import reproduce_published
    from gru4rec_tpu_torch.examples.rsc15 import run_rsc15

    out = {ds: (reproduce_published.load_config(e["paramfile"]), ds)
           for ds, e in sorted(reproduce_published.EXPECTED.items())}
    for name, params, _ in run_rsc15.CONFIGS:
        out[f"rsc15:{name}"] = (GRU4RecConfig(**params), "rsc15")
    return out


def _onehot(cfg):
    return not cfg.constrained_embedding and not cfg.embedding


def _update_shapes(cfg, n_items):
    """The "(rows, width) K=positions" of each row-sparse update of a step
    (``train/step.py``): ``Wy`` at width ``pad_cols(h + 1)`` takes the B
    lane targets and the negatives, after the B inputs in the constrained
    mode; the one-hot ``Wx0`` (width 3h) the B inputs."""
    from gru4rec_tpu_torch.models.gru import pad_cols, pad_items

    rows, B, S = pad_items(n_items, cfg.item_pad_multiple), cfg.batch_size, cfg.n_sample
    shapes = {f"({rows}, {pad_cols(cfg.layers[-1] + 1)}) K={(1 if _onehot(cfg) else 2) * B + S}"}
    if _onehot(cfg):
        shapes.add(f"({rows}, {3 * cfg.layers[0]}) K={B}")
    return shapes


def phase_published(smi_line):
    """Each published configuration (``published_configs``) for one epoch
    on ``synth_split`` at its dataset's catalog (every item in training, so
    the tables are full width), then ``evaluate`` at batch 512 and cutoffs
    1, 5, 10, 20, the harness's protocol: a finite loss, K1 once per step
    (and K4 for the one-hot configurations), every schedule native; the
    record adds ``evaluate``'s seconds and events/s, the memory peak and the
    row-sparse updates by shape. Then each for ``PUBLISHED_LEARN_EPOCHS``
    epochs at full width on the markov chain (``published_learn``):
    Recall@5 >= ``LEARN_RECALL5`` (``ONEHOT_BPR_LEARN_RECALL5`` for the
    one-hot bpr-max configuration). Returns {name: record} of the first
    part."""
    import torch

    t_phase = time.time()
    records = {}
    for name, (cfg, ds) in published_configs().items():
        epochs = cfg.n_epochs
        cfg.n_epochs = 1
        rsc15 = ds == "rsc15"
        n_items = PUBLISHED_ITEMS[ds]
        n_events = max(PUBLISHED_RSC15_EVENTS if rsc15 else PUBLISHED_EVENTS, 2 * n_items)
        mean_len = RSC15_MEAN_SESSION_LEN if rsc15 else MEAN_SESSION_LEN
        train, test = synth_split(seed=3, n_items=n_items, mean_len=mean_len,
                                  n_events=n_events)
        reduced = {"n_epochs": [epochs, 1], "events": n_events,
                   "data": f"synthetic zipf-0.8 sessions, mean length {mean_len}"}
        per_step = {"K1": 1, "K4": 1} if _onehot(cfg) else {"K1": 1}
        rec, model = _train("published", cfg, train, test, smi_line, per_step,
                            cut_off=(1, 5, 10, 20),
                            extra={"config": name, "layers": cfg.layers,
                                   "batch_size": cfg.batch_size, "loss_fn": cfg.loss,
                                   "logq": cfg.logq, "momentum": cfg.momentum,
                                   "dropout": [cfg.dropout_p_embed, cfg.dropout_p_hidden],
                                   "reduced": reduced})
        if rec["n_items"] != n_items:
            raise AssertionError(f"{name}: catalog is {rec['n_items']} items, not {n_items}")
        if {k.rsplit(" ", 1)[0] for k in rec["updates"]} != _update_shapes(cfg, n_items):
            raise AssertionError(f"{name}: updates {rec['updates']}, expected "
                                 f"{_update_shapes(cfg, n_items)}")
        records[name] = rec
        del model
        torch.cuda.empty_cache()
    learn = {}
    for name, (cfg, _) in published_configs().items():
        cfg.n_epochs = PUBLISHED_LEARN_EPOCHS
        per_step = {"K1": 1, "K4": 1} if _onehot(cfg) else {"K1": 1}
        rec, _ = _train("published_learn", cfg, markov(800), markov(100, seed=5), smi_line,
                        per_step, extra={"config": name})
        bar = ONEHOT_BPR_LEARN_RECALL5 if (_onehot(cfg) and cfg.loss == "bpr-max") \
            else LEARN_RECALL5
        learn[name] = (rec["recall"]["@5"], bar)
    emit({"phase": "published_summary", "seconds": time.time() - t_phase,
          "recall20": {k: r["recall"]["@20"] for k, r in records.items()},
          "events_per_s": {k: r["events_per_s"] for k, r in records.items()},
          "learn_recall5": learn, "card": smi_line})
    missed = {k: v for k, v in learn.items() if not v[0] >= v[1]}
    if missed:
        raise AssertionError(f"published_learn: Recall@5 under its bar {missed}")
    return records


EXAMPLES_EVENTS = 30_000  # reproduce_published's synthetic RetailRocket split
EXAMPLES_ITEMS = 10_000   # a catalog that 27,000 training events hold whole
EXAMPLES_TIMEOUT = 600


def _example(module, args, cwd=None):
    """``python -m gru4rec_tpu_torch.examples.<module>`` in a subprocess
    from the checkout's root: (result, seconds)."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", f"gru4rec_tpu_torch.examples.{module}",
                          *args], capture_output=True, text=True, timeout=EXAMPLES_TIMEOUT,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode not in (0, 1):
        raise AssertionError(f"{module} exited {res.returncode}:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    return res, time.time() - t0


def yoochoose_clicks(path):
    """Raw RSC15 clicks (``yoochoose-clicks.dat``): the generator of
    ``tests/test_preprocess.py``, 400 sessions over ten days."""
    import datetime as dt

    import pandas as pd

    rng = np.random.RandomState(4)
    base = dt.datetime(2014, 4, 1)
    rows = []
    for s in range(400):
        day = rng.randint(10) if rng.rand() > 0.2 else 9
        t0 = base + dt.timedelta(days=int(day), seconds=int(rng.randint(80000)))
        for e in range(rng.randint(1, 7)):
            ts = t0 + dt.timedelta(seconds=e)
            rows.append((s, ts.strftime("%Y-%m-%dT%H:%M:%S.%fZ")[:23] + "Z",
                         int(rng.zipf(1.4) % 60)))
    pd.DataFrame(rows).to_csv(path, header=False, index=False)


def phase_examples(smi_line):
    """The harnesses of ``gru4rec_tpu_torch/examples/`` as a user runs them,
    on the card: the quickstart (exit 0, its Recall/MRR lines and top-3
    table); ``reproduce_published retailrocket`` with the paramfile as
    published (10 epochs, dropout 0.5 / 0.05) on a synthetic split of
    ``EXAMPLES_EVENTS`` events written as TSV, which cannot meet the
    published numbers: exit 1, ``PARITY FAIL`` and a report of 8 metrics,
    each measured and finite, with ``fit_seconds``; ``rsc15.preprocess`` on
    synthetic raw clicks: its four TSVs."""
    import pandas as pd

    t_phase = time.time()
    out = {"phase": "examples"}
    quick, out["quickstart_s"] = _example("quickstart_synthetic", [])
    lines = quick.stdout.splitlines()
    metrics = [ln for ln in lines if ln.startswith("Recall@")]
    top3 = "top-3 next items for two live sessions:" in quick.stdout
    out.update(quickstart_rc=quick.returncode, quickstart_metrics=metrics,
               quickstart_top3=lines[-4:] if top3 else None)
    with tempfile.TemporaryDirectory() as tmp:
        train, test = synth_split(seed=2, n_items=EXAMPLES_ITEMS, n_events=EXAMPLES_EVENTS)
        train_p, test_p, report_p = (os.path.join(tmp, f)
                                     for f in ("train.tsv", "test.tsv", "r.json"))
        train.to_csv(train_p, sep="\t", index=False)
        test.to_csv(test_p, sep="\t", index=False)
        parity, out["reproduce_s"] = _example(
            "reproduce_published", ["retailrocket", train_p, test_p, "--out", report_p])
        report = json.load(open(report_p)) if os.path.exists(report_p) else None
        raw, pre_dir = os.path.join(tmp, "yoochoose-clicks.dat"), os.path.join(tmp, "rsc15")
        os.mkdir(pre_dir)
        yoochoose_clicks(raw)
        pre, out["preprocess_s"] = _example("rsc15.preprocess", [raw, pre_dir])
        tsvs = {f: len(pd.read_csv(os.path.join(pre_dir, f), sep="\t"))
                for f in sorted(os.listdir(pre_dir))}
        heads = {open(os.path.join(pre_dir, f)).readline().strip() for f in tsvs}
    out.update(reproduce_rc=parity.returncode,
               reproduce_verdict=[ln for ln in parity.stdout.splitlines()
                                  if ln.startswith("PARITY")],
               reproduce_events=EXAMPLES_EVENTS, reproduce_items=EXAMPLES_ITEMS,
               report={k: report[k] for k in ("paramfile", "fit_seconds", "pass")}
               if report else None,
               measured={m["metric"]: m["measured"] for m in report["metrics"]}
               if report else None,
               preprocess_rc=pre.returncode, preprocess_rows=tsvs,
               seconds=time.time() - t_phase, card=smi_line)
    emit(out)
    if quick.returncode != 0 or len(metrics) != 3 or not top3:
        raise AssertionError(f"quickstart: rc {quick.returncode}\n{quick.stdout[-3000:]}\n"
                             f"{quick.stderr[-3000:]}")
    if parity.returncode != 1 or out["reproduce_verdict"] != ["PARITY FAIL"] or \
            report is None or report["pass"] is not False or \
            not isinstance(report.get("fit_seconds"), (int, float)) or \
            len(report["metrics"]) != 8 or \
            not all(math.isfinite(v) for v in out["measured"].values()):
        raise AssertionError(f"reproduce_published: rc {parity.returncode}, report {report}"
                             f"\n{parity.stdout[-3000:]}\n{parity.stderr[-3000:]}")
    names = ["rsc15_test.txt", "rsc15_train_full.txt", "rsc15_train_tr.txt",
             "rsc15_train_valid.txt"]
    if pre.returncode != 0 or sorted(tsvs) != names or min(tsvs.values()) < 1 or \
            heads != {"SessionId\tItemId\tTime"}:
        raise AssertionError(f"preprocess: rc {pre.returncode}, files {tsvs}, heads {heads}"
                             f"\n{pre.stderr[-3000:]}")


# the kernels line: kernel_timing key -> (mode, line of the TPU kernel in
# gru4rec_tpu/ops/kernels/sparse_update.py, phase whose launches count)
KERNEL_TABLE = {"K1": ("K1", 419, "train"), "K2": ("K2", 484, "train_sr"),
                "K3": ("K3", 808, "train_adam_sr"), "K4": ("K4", 248, "train_onehot"),
                "K1 onehot Wy": ("K1", 419, "train_onehot"),
                "K1 rees46 Wy": ("K1", 419, "published_rees46")}
# P1, P2 -> the TPU kernel; their launches are the proto phase's
PROTO_TABLE = {"P1": "scripts/proto_merged_kernel.py:31",
               "P2": "scripts/proto_v3_kernel.py:63"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        import gru4rec_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1

    smi_line = phase_device()
    phase_build()
    phase_kernel()
    timing = phase_kernel_timing()
    phase_reference()
    paths = {}
    paths["train"], flagship = phase_train(smi_line)
    control = phase_train_sr_control(smi_line)
    paths["train_sr"] = phase_train_sr(smi_line, paths["train"], control)
    paths["train_adam_sr"] = phase_train_adam_sr(smi_line)
    paths["train_onehot"] = phase_train_onehot(smi_line)
    phase_learn()
    paths["learn_sr"] = phase_learn_sr(smi_line)
    proto = phase_proto(smi_line)
    phase_serve(flagship, smi_line)
    phase_checkpoint(flagship, smi_line)
    phase_resume(smi_line)
    phase_cli(smi_line)
    phase_scheduler(smi_line)
    phase_legacy_eval(flagship, smi_line)
    phase_paropt(smi_line)
    phase_mesh_shard_kernel(smi_line)
    phase_mesh_1x1(flagship, paths["train"], smi_line)
    phase_mesh_2x2_shared_card(smi_line)
    paths["published_rees46"] = phase_published(smi_line)["rees46"]
    phase_examples(smi_line)
    # library_ms: no single PyTorch call computes these functions (PERF.md);
    # e.g. torch.optim.Adagrad with sparse gradients divides by sqrt(acc) + eps
    kernels = [{
        "name": f"sparse_update[{key}]",
        "route": "cuda",
        "source": "gru4rec_tpu_torch/csrc/sparse_update.cu",
        "replaces": f"gru4rec_tpu/ops/kernels/sparse_update.py:{line}",
        "path": timing[key]["path"],
        "launches": paths[phase]["launches"][mode],
        **{k: timing[key][k] for k in ("max_abs_err", "ms", "step_ms", "plain_ms",
                                       "bound_ms")},
        "bound_by": "bytes",
        "library_ms": None,
    } for key, (mode, line, phase) in KERNEL_TABLE.items()]
    kernels += [{
        "name": f"proto_adagrad[{kernel}]",
        "route": "cuda",
        "source": "gru4rec_tpu_torch/csrc/proto_adagrad.cu",
        "replaces": replaces,
        **{k: proto[kernel][k] for k in ("launches", "max_abs_err", "ms", "step_ms",
                                         "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "library_ms": None,
    } for kernel, replaces in PROTO_TABLE.items()]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of mesh_2x2_shared_card
        sys.exit(mesh_rank_main(*sys.argv[2:5]))
    sys.exit(main())
