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
4. mixed_mm — the bfloat16 mixed-precision product of
   ``ops/mixed_mm.py`` (``compute_dtype="bfloat16"``, every configuration's
   default) on the card's bf16 tensor cores at the main paths' shapes: the
   flagship step's four products, rees46's training products (batch 240,
   GRU-512) and its evaluation scores (512 x 512 x 200,064), two of the
   rsc15 family's (GRU-100, batch 32) and two of ``learn_sr``'s (an
   embedding of 12), serving at batch 1 and 256; each against its plain version on the same inputs (the
   product within ``2·K·2^-24·(|a|·|b|)`` entrywise, each gradient within
   one bf16 ulp beyond its float32 sums' bound and bit-equal on 99% of its
   entries), captured against eager bit for bit with the launches counted
   per replay, and timed (the route, the plain version, the bare cuBLAS
   GEMM, the cast of the right operand); ``mixed_mm_route``: a traced
   flagship step whose GEMMs are all bf16 tensor-core GEMMs, and with
   float32 products all float32 ones. Every training phase then checks the
   products' launches: ``mm_per_step`` per step, the forward ones per
   evaluation step; then ``score_rank``: the full-catalog ranking kernel
   (``ops/kernels/score_rank.py``) against its plain version at rees46's
   evaluation shape in each tie mode, one call with host syncs an error,
   and its device, wrapper and plain time per call beside one read of the
   scores (``score_rank_timing``); ``score_rank_elementwise``: its
   elementwise mode at diginetica's evaluation shape under every
   elementwise activation, counts equal to the plain version's, one call
   with host syncs an error, and elu-1's time beside the eager route's and
   one read (``score_rank_elementwise_timing``); every training phase's
   ``evaluate`` calls it once per step under a softmax or an elementwise
   final activation;
5. reference — the training slice on the card against the same slice on
   the CPU at a small size, step by step;
6. train   — ``GRU4Rec.fit`` of the RetailRocket flagship config (GRU-224,
   batch 80, bpr-max/elu-0.5, 2048 pop^0.4 alias negatives, constrained
   embedding, adagrad + momentum 0.4) for one epoch on synthetic
   RetailRocket-shaped data, then ``evaluate`` on held-out sessions, with
   the kernel's launch counters read around that run;
7. train_sr_control — the same with ``opt_state_dtype="bfloat16_sr"``
   but adagrad's bf16 accumulator stored round-to-nearest (no SR; K1 with
   bf16 state): the reading that ``train_sr``'s limit must exclude;
8. train_sr — the same with stochastic rounding (K2): its loss within 2%
   of the train phase's, its summed ``Wy`` accumulator within
   ``SR_ACC_REL_LIMIT`` of the train phase's float32 one, the control's
   outside that limit;
9. train_adam_sr — the flagship with adam (learning rate 0.001) and
   ``bfloat16_sr`` state (K3 on the full-width ``Wy``);
10. train_onehot — the RSC15 config of ``param_samples/rsc15_bpr-max.py``
   (GRU-100, one-hot input, batch 32, 2048 uniform negatives, adagrad +
   momentum 0.3) for one epoch on synthetic sessions over RSC15's 37,483
   items (K4 on ``Wx0``, K1 on ``Wy``);
11. graph  — every training phase runs ``fit`` through the captured step
   (``train/step.py``: three eager warm-up steps, then one CUDA graph
   replayed per step; each record's ``graph`` gives the replays and the
   bytes the graph's pool reserved). Here the flagship (K1), ``train_sr``
   (K2, its seeds read on the device), ``train_adam_sr`` (K3),
   ``train_onehot`` (K4 and K1) and ``train_sgd`` (the flagship with plain
   SGD, first trained through the graph here: its row-sparse update is the
   torch-op path, no kernel) are trained again for their epoch through the
   eager loop, the graph's plain version: the epoch loss and every
   parameter, optimizer-state and hidden-state leaf bit-equal, the same
   launches by mode (the counters count replays). ``graph_dropout``: the
   RetailRocket published configuration's dropout masks, step by step,
   equal to the eager loop's and different on every replay;
   ``graph_seed``: K2 and K3 with the seed read on the device bit-equal to
   the seed by value;
12. learn  — the markov-chain drive of the verify recipe through the port,
   which must reach recall@1 >= 0.9;
13. learn_sr — the same chain with adam, an embedding of 12 and
   ``bfloat16_sr`` state (K3 on ``E`` and ``Wy``) at its seed and seeds
   0-9, mean recall@1 >= 0.9;
14. proto   — the adagrad prototypes P1 (merged ``[t | a]`` layout) and P2
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
15. serve   — serving on the train phase's fitted flagship model after
   ``scripts/measure_serving.py``: ``predict_topk`` (k = 20) at batch 1, 64
   and 256 through its captured call (``models/gru4rec.py::_serve_graph``)
   and eagerly in turns (warm median ms per call, device ms per call,
   events/s, host launches per call: at most 6 captured),
   ``predict_next_batch`` once at batch 512; top-k against the full score
   frame, a changed session's lane against a fresh lane, and
   ``cast_for_serving("bfloat16")``; the captured calls against eager
   serving bit for bit over session changes, a change of k, a change of
   batch and the bfloat16 cast (``graph_vs_eager``);
16. eval_graph — the captured evaluation step against the eager loop at
   the flagship's and rees46's widths: Recall, MRR and final lanes
   bit-equal in the four tie modes, full catalog and subset; ms per step,
   host launches per step, the memory peak and the graph pool's bytes of
   the eager loop, a standalone call and a kept graph; a standalone call
   leaves no memory allocated;
17. checkpoint — ``savemodel(include_optimizer=True)`` of that model and
   ``loadmodel`` on the card (archive bytes, save and load seconds; equal
   top-k scores bit for bit), then ``fit(retrain=True)`` of the loaded
   model on data with 500 unseen items (the tables grow; K1 once per step);
18. resume  — the markov chain with adagrad and ``bfloat16_sr`` state (K2):
   a run resumed from a training checkpoint against two uninterrupted runs
   (``resume_diff <= repeat_diff``), with a ``profile_dir`` trace; in-fit
   validation every epoch with ``early_stop_patience`` and ``keep_best``,
   which builds one validation schedule and captures one evaluation step
   per ``fit`` (``valid_schedules``, ``valid_graphs``);
19. cli     — ``python -m gru4rec_tpu_torch.cli.run`` as subprocesses: the
   flagship trained, saved and evaluated from TSV files, the archive
   loaded and evaluated to the same ``PRIMARY METRIC:``, and a NaN run
   that exits 2;
20. scheduler — the native schedule builder (``data/_native_scheduler.py``,
   ``csrc/scheduler.cpp`` built by ``g++``) against the numpy builder on the
   train phase's split and on a RetailRocket-length split of 750,000 events:
   equal arrays, and the median ms of 5 builds each. Every training phase
   (``train`` to ``learn_sr``, and ``resume``) prints ``native_schedules``
   and ``numpy_schedules``, the schedules built each way while it ran: none
   by numpy;
21. legacy_eval — on the train phase's flagship model and test split,
   ``evaluate_sessions_batch`` (the ``predict_next_batch`` path) against
   ``evaluate`` (recall and MRR @20 within 0.03), ``Pop`` and ``ItemKNN``
   through ``evaluate_sessions``; seconds and events/s of each evaluator,
   and the device memory peak of ``evaluate``;
22. paropt  — ``python -m gru4rec_tpu_torch.cli.paropt``: a random search
   of two trials over the flagship's learning rate and momentum, then the
   final run of the best at @1, 5, 20; ``-tf`` reaches every child (one
   JSONL ``epoch`` event each);
23. mesh    — the (data, model) mesh of ``gru4rec_tpu_torch/parallel/``
   over ``torch.distributed``, in three parts. ``mesh_shard_kernel``: K1
   and K2 on the flagship ``Wy`` and K4 on the RSC15 ``Wx0``, cut into 2
   and 4 row-shards as a mesh's model ranks hold them, each shard's call
   on its rows with local indices and ``sr_seed=(seed, r0)``: bit-equal to
   the whole-table call (``r0`` and ``max_abs_err`` per shard).
   ``mesh_1x1``: ``fit(mesh=make_mesh(1, 1))`` of the flagship over NCCL
   on ``cuda:0`` for the train phase's epoch, through the captured mesh
   step (``parallel/dist_step.py``: three eager steps, then one CUDA graph,
   collectives included, replayed per step; ``graph`` as in the training
   phases): loss, every parameter and optimizer leaf, and Recall/MRR@1/5/20
   of ``evaluate(mesh=)`` (captured, and its eager loop) bit-equal to the
   train phase's; K1 once per step, replays counted; the same fit through
   the eager loop bit-equal; the flagship with ``bfloat16_sr`` on the mesh
   bit-equal to ``train_sr`` (K2 once per step, its seeds read on the
   device); ``mesh_1x1_steps``: the flagship's chunk function one device
   captured, mesh captured and mesh eager over the same windows in turns
   (ms per step, events/s, device busy ms, idle share, host launches,
   kernels and copies per step, pool bytes); ``predict_topk(mesh=)`` at
   batch 1, 64 and 256 through its captured call, equal to the
   single-device call (warm median ms per call of both in turns, the mesh
   call's device ms and host launches, events/s).
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
24. published — the nine published configurations, loaded through the
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
25. examples — ``python -m gru4rec_tpu_torch.examples.<name>`` as
   subprocesses: the quickstart (exit 0), ``reproduce_published
   retailrocket`` with the paramfile as published on a synthetic split of
   30,000 events (exit 1, ``PARITY FAIL``, a report of 8 finite metrics),
   ``rsc15.preprocess`` on synthetic raw clicks (four TSVs);
26. hbm_budget — ``scripts/measure_hbm_budget_torch.py``: ``table`` (the
   bytes per item and fixed of the parameters, the optimizer state and the
   run's buffers for each adapt x ``opt_state_dtype`` at GRU-512, batch 240,
   with the graph pool and the capture stream's workspace read from one
   probe on the card) and one ``try`` at 1,000,000 items with adam and
   ``bfloat16_sr`` (``ok``, K3 once per step, its memory reserved);
27. fuzz    — the JAX package's config-surface fuzz
   (``tests/test_config_fuzz.py``: its generator, copied here as
   ``fuzz_draw_config`` and ``fuzz_sessions``, seed ``1000 + draw``) on the
   card: draws 0-23 at their drawn widths, then draws 0-7 with every layer
   (and the embedding, where drawn) 128 wide, each as drawn (dropout,
   bfloat16 products, its state dtype, 2 epochs of 120 sessions). Per run:
   ``fit`` through the captured step and through the eager loop, every
   epoch loss and every parameter, state and lane leaf bit-equal, the
   replays the steps after the warm-up, and the kernel launches its
   config implies once per step and table (K2/K3 on ``bfloat16_sr``
   adagrad/adam state, else K1 at a width that is a multiple of 128 and
   K4 at any other, none under plain SGD); ``evaluate`` captured against
   eager, bit-equal; ``savemodel`` -> ``loadmodel`` -> ``predict_topk``
   (k = 5) with the same ids and scores; the chunk function step by step
   from the same state on the card (captured) and the CPU, with float32
   products and no dropout: loss within rtol 1e-4, parameters within atol
   1e-5, float32 state within atol 1e-5 + rtol 1e-6, bfloat16 state within
   one bf16 ulp; each entry of an adam parameter and its momentum also
   within lr times the difference of the step directions the two devices'
   float32 moments give (adam's slope lr / eps at a zero gradient), and
   every adam entry past 1e-5 read back. One line per run, then
   ``fuzz_summary`` (runs, steps, launches by mode, the largest
   card-against-CPU differences, the adam entries past 1e-5);
28. paropt_sweep — ``scripts/run_paropt_sweep_torch.py 3``: three paropt
   trials at the sweep's GRU-224 / batch-80 / 2048-negative shape on
   420,000 synthetic training events, from a copy of the package with an
   empty build directory: exit 0, a metric per trial, ``cache_shared``
   (trial 1's first epoch, which builds the kernel and the schedule
   builder, over 3x the warm trials' median), and paropt's final run of
   the best parameters at the best trial's Recall@20;
29. bench   — ``python -m gru4rec_tpu_torch.bench`` in full as a fresh
   subprocess (four flagship epochs at the bench's 750,000 events, then the
   epoch-1 children: two warm, one cold that builds the kernel and the
   schedule builder into an empty directory): exit 0, the result line's
   keys those of ``bench.py``'s line in its order (read from its source),
   every epoch-1 field a number, ``bench_hw`` the card's name, K1 once per
   step of the four epochs; it prints the line and the card's
   ``nvidia-smi`` line as the harness gave them;
30. bench_scaling — ``python -m gru4rec_tpu_torch.bench_scaling``: one row
   per data-parallel width the cards allow (one card: devices 1, batch
   80), the keys of ``bench_scaling.py``'s row, K1 once per step;
31. kernels — one JSON line per the port's kernel table (K1-K4, K1 on the
   one-hot ``Wy``, K1 on rees46's ``Wy``, P1, P2, and the product at the
   flagship's scores and rees46's evaluation), with the ``fuzz``
   phase's launches of each mode beside the main path's.

Every phase prints one JSON line; a failed check raises, and the script
then exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import gc
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


def eval_sessions(n_events, n_items, seed=1, mean_len=MEAN_SESSION_LEN):
    """``scripts/measure_eval.py``'s synthetic test sessions: ``n_events``
    events in sessions of geometric length (mean ``mean_len``, at least 2)
    over zipf-0.8 items of an ``n_items`` catalog with integer ids."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    n_sessions = int(n_events / mean_len)
    lens = 2 + rng.geometric(1.0 / (mean_len - 2.0), size=n_sessions)
    total = int(lens.sum())
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = 1.0 / ranks**0.8
    p /= p.sum()
    items = rng.choice(n_items, size=total, p=p).astype(np.int64)
    sess = np.repeat(np.arange(n_sessions, dtype=np.int64), lens)
    return pd.DataFrame({"SessionId": sess, "ItemId": items,
                         "Time": np.arange(total, dtype=np.int64)})


def seeded_model(cfg, n_items):
    """A model on the card over a catalog of ``n_items`` integer ids, its
    weights the seeded initialisation (``cfg.seed``): evaluation and
    serving cost and parity need no training."""
    import pandas as pd

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.models import gru

    model = GRU4Rec(cfg, device=DEVICE)
    ids = np.arange(n_items, dtype=np.int64)
    model.itemidmap = pd.Series(ids, index=ids, name="ItemIdx")
    model.n_items = n_items
    model.params = gru.init_params(cfg, n_items, model.device)
    return model


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


BF16_PEAK_FLOP_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
FP32_UNIT = 2.0**-24       # float32 unit roundoff
# mixed_mm's shapes, name -> (M, K, N, width of the table whose rows
# [:, :K] form the right operand, or None; with a backward pass)
MIXED_MM_SHAPES = {
    "flagship projection": (80, 224, 672, None, True),
    "flagship cell rz": (80, 224, 448, None, True),
    "flagship cell h": (80, 224, 224, None, True),
    "flagship scores": (80, 224, 2128, 256, True),
    "rees46 projection": (240, 512, 1536, None, True),
    "rees46 cell rz": (240, 512, 1024, None, True),
    "rees46 cell h": (240, 512, 512, None, True),
    "rees46 scores": (240, 512, 2288, 640, True),
    "rees46 evaluation": (512, 512, 200_064, 640, False),
    # the rsc15 family's GRU-100: a depth whose bf16 rows are 200 bytes
    "rsc15 cell rz": (32, 100, 200, None, True),
    "rsc15 scores": (32, 100, 2080, 128, True),
    # learn_sr's embedding of 12 (rows of 24 bytes) and its scores
    "learn_sr projection": (32, 12, 192, None, True),
    "learn_sr scores": (32, 64, 96, 128, True),
    "serve batch 1": (1, 224, 36_992, 256, False),
    "serve batch 256": (256, 224, 36_992, 256, False),
}
MIXED_MM_REPS = 20          # timed calls of each way, median
MIXED_MM_MIN_BIT_EQUAL = 0.99
MIXED_MM_TRACE_STEPS = 16   # flagship steps in each traced window


def _median_ms(fn, reps=MIXED_MM_REPS):
    """Median device time of ``fn()`` over ``reps`` calls, CUDA events
    around each, after two untimed calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bf16_ulp(x):
    """The bfloat16 ulp of each entry of ``|x|`` (0 where x is 0)."""
    import torch

    m, e = torch.frexp(x.abs())
    return torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def _grad_check(got, want, bound):
    """(max |got - want|, entries past one bf16 ulp of the larger beyond
    ``bound``, entries past one ulp, bit-equal share)."""
    import torch

    diff = (got - want).abs()
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return (float(diff.max()), int((diff > ulp + bound).sum()), int((diff > ulp).sum()),
            float((got == want).float().mean()))


def _mm_case(name, shape, gen):
    """One shape of ``phase_mixed_mm``: the route against its plain version
    on the same card inputs, captured against eager, and the timings."""
    import torch

    from gru4rec_tpu_torch.ops import mixed_mm
    from gru4rec_tpu_torch.utils.cuda_graph import capture, capture_stream, run_on

    M, K, N, width, backward = shape
    dev = torch.device(DEVICE)
    a = (torch.rand((M, K), generator=gen, device=dev) * 2 - 1).requires_grad_(backward)
    table = (torch.randn((N, width) if width else (K, N), generator=gen, device=dev)
             * 0.1).requires_grad_(backward)
    g = torch.randn((M, N), generator=gen, device=dev) * 1e-3 if backward else None

    def right(t):
        return t[:, :K].T if width else t

    def call(fn):
        if not backward:
            with torch.no_grad():
                return (fn(a, right(table)),)
        out = fn(a, right(table))
        ga, gt = torch.autograd.grad(out, (a, table), g)
        return out.detach(), ga, right(gt)

    mixed_mm.reset_launches()
    got = call(mixed_mm.mixed_mm)
    launches = dict(mixed_mm.launches_by_mode)
    want_launches = {"forward": 1, "backward": 2 if backward else 0}
    plain = call(mixed_mm.mixed_mm_plain)
    a16, b16 = a.detach().to(torch.bfloat16).float(), right(table.detach()).to(torch.bfloat16).float()
    bound = 2 * K * FP32_UNIT * (a16.abs() @ b16.abs())
    fwd_err = float((got[0] - plain[0]).abs().max())
    fwd_bad = int(((got[0] - plain[0]).abs() > bound).sum())
    rec = {"phase": "mixed_mm", "shape": name, "M": M, "K": K, "N": N,
           "table_width": width, "backward": backward, "launches": launches,
           "max_abs_err": fwd_err, "past_bound": fwd_bad}
    del bound
    if backward:
        # the card sums the tripled depth, the plain version the depth once
        bounds = (4 * N * FP32_UNIT * (g.abs() @ b16.abs().T),
                  4 * M * FP32_UNIT * (a16.abs().T @ g.abs()))
        for which, x, y, bnd in (("grad_a", got[1], plain[1], bounds[0]),
                                 ("grad_b", got[2], plain[2], bounds[1])):
            err, bad, past_ulp, share = _grad_check(x, y, bnd)
            rec[which] = {"max_abs_err": err, "past_bound": bad, "past_one_ulp": past_ulp,
                          "bit_equal_share": share, "entries": x.numel()}
        del bounds
    # captured against eager, on the capture stream
    stream = capture_stream(dev)
    eager = run_on(stream, lambda: call(mixed_mm.mixed_mm))
    mixed_mm.reset_launches()
    graph, pool_bytes, captured = capture(lambda: call(mixed_mm.mixed_mm), stream)
    graph.replay()
    torch.cuda.synchronize()
    rec["graph_tally"] = graph.tally
    rec["graph_bit_equal"] = all(torch.equal(x, y) for x, y in zip(captured, eager))
    rec["graph_replay_launches"] = dict(mixed_mm.launches_by_mode)
    del graph, captured, eager
    # timings: the route (casts + GEMM), the plain version, the bare GEMM on
    # operands already cast (the library call), the right operand's cast
    with torch.no_grad():
        b = right(table.detach())
        a_ = a.detach()
        a16_, b16_ = a_.to(torch.bfloat16), b.to(torch.bfloat16)
        rec["ms"] = _median_ms(lambda: mixed_mm.mixed_mm(a_, b))
        rec["plain_ms"] = _median_ms(lambda: mixed_mm.mixed_mm_plain(a_, b))
        rec["library_ms"] = _median_ms(lambda: mixed_mm._tc_mm(a16_, b16_))
        rec["cast_ms"] = _median_ms(lambda: b.to(torch.bfloat16))
    if backward:
        rec["fwd_bwd_ms"] = _median_ms(lambda: call(mixed_mm.mixed_mm))
        rec["plain_fwd_bwd_ms"] = _median_ms(lambda: call(mixed_mm.mixed_mm_plain))
    flops = 2.0 * M * K * N
    moved = 4.0 * (M * K + K * N + M * N)  # a and b read (float32), the scores written
    rec.update({"tflop_s": flops / rec["ms"] / 1e9,
                "library_tflop_s": flops / rec["library_ms"] / 1e9,
                "plain_tflop_s": flops / rec["plain_ms"] / 1e9,
                "bound_ms": max(moved / HBM_BYTES_PER_S, flops / BF16_PEAK_FLOP_S) * 1e3,
                "bound_by": "bytes" if moved / HBM_BYTES_PER_S > flops / BF16_PEAK_FLOP_S
                else "operations"})
    bad = []
    recorded = {"mixed_mm": {m: n for m, n in want_launches.items() if n}}
    if launches != want_launches or rec["graph_tally"] != recorded \
            or rec["graph_replay_launches"] != want_launches:
        bad.append("launch counts")
    if fwd_bad:
        bad.append("product past 2·K·2^-24·(|a|·|b|)")
    for which in ("grad_a", "grad_b"):
        r = rec.get(which)
        if r and (r["past_bound"] or r["bit_equal_share"] < MIXED_MM_MIN_BIT_EQUAL):
            bad.append(which)
    if not rec["graph_bit_equal"]:
        bad.append("captured differs from eager")
    return rec, bad


def _gemm_kind(name):
    """The operand type a cuBLAS GEMM kernel's name gives: "bf16" (nvjet's
    first type letter ``t``, or ``bf16`` in the name), "f32" (nvjet's ``s``,
    the xmma ``f32f32_f32f32`` kernels, sgemm), else None (not a GEMM)."""
    low = name.lower()
    if not any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return None
    if low.startswith("nvjet_t") or "bf16" in low:
        return "bf16"
    if low.startswith("nvjet_s") or "f32f32_f32f32" in low or "sgemm" in low:
        return "f32"
    return "other"


def _mm_route_trace(smi_line):
    """The flagship's captured step traced over ``MIXED_MM_TRACE_STEPS``
    steps with its default bfloat16 products and, as the control, with
    float32 products: the GEMM kernels by name, kind and runs per step."""
    import torch

    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.models.gru4rec import resolve_device
    from gru4rec_tpu_torch.train.step import init_train_state, make_chunk_fn
    from gru4rec_tpu_torch.utils.profiling import trace

    S = MIXED_MM_TRACE_STEPS
    itemidmap, sched, packed, _ = _flagship_schedule(flagship_cfg())
    n = len(itemidmap)
    dev = resolve_device(DEVICE)  # the card's matmul settings
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = flagship_cfg(compute_dtype=dtype)
        state, fn = init_train_state(cfg, n, dev), make_chunk_fn(cfg, n)
        samp1 = torch.from_numpy(packed).to(dev)
        logp0 = torch.zeros(pad_items(n, cfg.item_pad_multiple), device=dev)

        def window(w):
            return fn(state, *[x[w * S:(w + 1) * S] for x in
                               (sched.in_idx, sched.out_idx, sched.valid, sched.reset)],
                      samp1, logp0)

        window(0)  # the eager warm-up steps and the capture
        traced = trace(lambda: window(1), S)
        gemms = {k: {"kind": _gemm_kind(k), "ms_per_step": v[0], "runs_per_step": v[1]}
                 for k, v in traced["by_name"].items() if _gemm_kind(k)}
        out[dtype] = {"gemms": gemms, "replays": fn.runner.replays,
                      "runs_per_step": {kind: sum(v["runs_per_step"] for v in gemms.values()
                                                  if v["kind"] == kind)
                                        for kind in ("bf16", "f32", "other")},
                      "kernels_per_step": traced["kernels"],
                      "device_busy_ms_per_step": traced["device_busy_ms"]}
        del state, fn
    fwd, bwd = mm_per_step(flagship_cfg())
    rec = {"phase": "mixed_mm_route", "steps": S, "products_per_step": fwd + bwd, **out,
           "card": smi_line}
    emit(rec)
    bf, ctl = out["bfloat16"]["runs_per_step"], out["float32"]["runs_per_step"]
    # the tracer drops records now and then: a window may fall short by a few
    if bf["f32"] or bf["other"] or not 0.9 * (fwd + bwd) <= bf["bf16"] <= fwd + bwd:
        raise AssertionError(f"mixed_mm_route: the bfloat16 step's GEMMs are not "
                             f"{fwd + bwd} bf16 tensor-core GEMMs per step: {bf}")
    if ctl["bf16"] or not ctl["f32"]:
        raise AssertionError(f"mixed_mm_route: the float32 control's GEMMs are not "
                             f"float32: {ctl}")
    return rec


def phase_mixed_mm(smi_line):
    """The bfloat16 mixed-precision product (``ops/mixed_mm.py``, the
    default ``compute_dtype``) on the card's tensor cores at the main
    paths' shapes (``MIXED_MM_SHAPES``), each against its plain version on
    the same card inputs: the product within ``2·K·2^-24·(|a|·|b|)``
    entrywise; each operand's gradient within one bf16 ulp beyond the
    float32 sums' bound and bit-equal on at least ``MIXED_MM_MIN_BIT_EQUAL``
    of its entries; a captured forward and backward bit-equal to eager, its
    launches counted per replay; the route's, the plain version's, the
    bare GEMM's and the cast's median ms (CUDA events) with TFLOP/s. Then
    ``mixed_mm_route``: the flagship step traced, every GEMM a bf16
    tensor-core GEMM (the float32 control's all float32). Returns {shape:
    record}."""
    import torch

    t_phase = time.time()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    records, failed = {}, {}
    for name, shape in MIXED_MM_SHAPES.items():
        rec, bad = _mm_case(name, shape, gen)
        rec["card"] = smi_line
        emit(rec)
        records[name] = rec
        if bad:
            failed[name] = bad
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"mixed_mm: {failed}")
    _mm_route_trace(smi_line)
    emit({"phase": "mixed_mm_summary", "seconds": time.time() - t_phase, "card": smi_line})
    return records


# the full-catalog ranking kernel at rees46's evaluation: B, N (the padded
# catalog), n_items, the width of the table whose column h is the bias
SCORE_RANK_SHAPE = (512, 200_064, 200_000, 640)
SCORE_RANK_STEPS = 64


def _near_target(x, bias, n_items, tgt):
    """Per lane, the other real columns whose plain activated value lies
    within one float32 ulp of the target's (the target's own column left
    out: the kernel must count it exactly)."""
    import torch

    from gru4rec_tpu_torch.ops.activations import masked_softmax

    cols = torch.arange(x.shape[1], device=x.device)
    valid = cols < n_items
    yhat = masked_softmax(x + bias, valid)
    t = yhat[torch.arange(x.shape[0], device=x.device), tgt][:, None]
    ulp = torch.nextafter(t, torch.full_like(t, torch.inf)) - t
    others = valid & (cols != tgt[:, None].long())
    return torch.sum(((yhat - t).abs() <= ulp) & others, dim=1)


def phase_score_rank(smi_line):
    """The full-catalog ranking kernel (``ops/kernels/score_rank.py``,
    ``csrc/score_rank.cu``) at rees46's evaluation shape
    (``SCORE_RANK_SHAPE``, logits and bias drawn from a seed, a third of
    the lanes invalid): in each tie mode its counts against the plain
    version's on the card, each lane within the other columns whose plain
    activated value lies within one ulp of the target's, so exact on a lane
    with none (``off_lanes``, ``past_near``, ``near_columns``,
    ``near_lanes``); one call under ``torch.cuda.set_sync_debug_mode
    ("error")``; then ``SCORE_RANK_STEPS`` back-to-back calls (standard):
    ``ms`` the device time per call of the kernels named ``score_rank*``
    (``torch.profiler``; ``ops`` by name, each once per call), ``step_ms``
    and ``plain_ms`` the wrapper's and the plain version's time per call
    (CUDA events), ``bound_ms`` one read of the scores at 3.35 TB/s.
    Returns the timing record."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import proto_measure
    from gru4rec_tpu_torch.ops.kernels import score_rank as sr

    B, N, n_items, width = SCORE_RANK_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    x = torch.randn((B, N), generator=gen, device=DEVICE) * 3.0
    table = torch.zeros((N, width), device=DEVICE)
    table[:n_items, width // 2] = torch.randn(n_items, generator=gen, device=DEVICE) * 0.5
    bias = table[:, width // 2]
    tgt = torch.randint(0, n_items, (B,), generator=gen, device=DEVICE, dtype=torch.int32)
    tgt[::3] = 0
    near = _near_target(x, bias, n_items, tgt)
    checks = {}
    for mode in sr.MODES:
        got = sr.score_rank_cuda(x, bias, n_items, tgt, mode)
        want = sr.score_rank_plain(x, bias, n_items, tgt, mode)
        for name, g, w in zip(("gt", "second"), got, want):
            if w is None:
                continue
            diff = (g.long() - w.long()).abs()
            checks[f"{mode} {name}"] = {"off_lanes": int((diff > 0).sum()),
                                        "off_sum": int(diff.sum()),
                                        "past_near": int((diff > near).sum())}
    near_lanes = int((near > 0).sum())
    emit({"phase": "score_rank", "shape": [B, N, n_items], "checks": checks,
          "near_columns": int(near.sum()), "near_lanes": near_lanes, "card": smi_line})
    bad = {k: v for k, v in checks.items() if v["past_near"] or v["off_lanes"] > near_lanes}
    if bad:
        raise AssertionError(f"score_rank: counts past the near columns {bad}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sr.score_rank_cuda(x, bias, n_items, tgt, "median")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps = SCORE_RANK_STEPS
    xs = [x, torch.randn((B, N), generator=gen, device=DEVICE) * 3.0]
    kern = lambda s: sr.score_rank_cuda(xs[s % 2], bias, n_items, tgt, "standard")
    plain = lambda s: sr.score_rank_plain(xs[s % 2], bias, n_items, tgt, "standard")
    times = proto_measure.device_times(kern, steps=steps)
    ours = {k: v for k, v in times.items() if "score_rank" in k}
    if not ours or any(abs(n - steps) > steps // 16 for _, n in ours.values()):
        raise AssertionError(f"score_rank: kernels per call {times}")
    bytes_read = B * N * 4
    rec = {"phase": "score_rank_timing", "shape": [B, N, n_items],
           "ms": sum(us for us, _ in ours.values()) / steps / 1e3,
           "ops": {k[:60]: us / n for k, (us, n) in ours.items()},
           "other_ops": {k[:60]: v for k, v in times.items() if k not in ours},
           "step_ms": proto_measure.steps_us(kern, steps=steps) / 1e3,
           "plain_ms": proto_measure.steps_us(plain, steps=steps, reps=3) / 1e3,
           "bound_ms": bytes_read / HBM_BYTES_PER_S * 1e3, "bytes": bytes_read,
           "bound_by": "bytes", "library_ms": None, "card": smi_line}
    emit(rec)
    return rec


# its elementwise mode at diginetica's evaluation (elu-1): B, N, n_items,
# the table's width
SCORE_RANK_EW_SHAPE = (512, 43_008, 43_000, 640)
SCORE_RANK_EW_ACTS = ("elu-1", "elu-0.5", "linear", "relu", "leaky-0.1",
                      "selu-1.0507-1.6733", "tanh", "sigmoid")


def phase_score_rank_elementwise(smi_line):
    """The ranking kernel's elementwise mode at diginetica's evaluation
    shape (``SCORE_RANK_EW_SHAPE``, logits and bias drawn from a seed, a
    third of the lanes invalid, a few columns far below zero where the
    saturating activations tie, a third of the lanes targeting one): under
    each activation of ``SCORE_RANK_EW_ACTS`` and tie mode, its counts
    against the plain version's on the card (``off_lanes``: they must be
    equal); one call under ``torch.cuda.set_sync_debug_mode("error")``;
    then ``SCORE_RANK_STEPS`` back-to-back elu-1 calls (standard): ``ms``
    the device time per call of the kernels named ``score_rank*``
    (``torch.profiler``; ``ops`` by name, each once per call), ``step_ms``
    and ``plain_ms`` the wrapper's and the plain version's (the eager
    route's op sequence) time per call (CUDA events), ``bound_ms`` one
    read of the scores at 3.35 TB/s. Returns the timing record."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import proto_measure
    from gru4rec_tpu_torch.ops.kernels import score_rank as sr

    B, N, n_items, width = SCORE_RANK_EW_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(17)
    x = torch.randn((B, N), generator=gen, device=DEVICE) * 3.0
    x[:, 4:10] = -120.0 - 10.0 * torch.arange(6, device=DEVICE)
    table = torch.zeros((N, width), device=DEVICE)
    table[:n_items, width // 2] = torch.randn(n_items, generator=gen, device=DEVICE) * 0.5
    table[4:10, width // 2] = 0.0
    bias = table[:, width // 2]
    tgt = torch.randint(0, n_items, (B,), generator=gen, device=DEVICE, dtype=torch.int32)
    tgt[::3] = 0
    tgt[1::3] = 6
    checks = {}
    for act in SCORE_RANK_EW_ACTS:
        for mode in sr.MODES:
            got = sr.score_rank_cuda(x, bias, n_items, tgt, mode, act)
            want = sr.score_rank_plain(x, bias, n_items, tgt, mode, act)
            for name, g, w in zip(("gt", "second"), got, want):
                if w is not None:
                    checks[f"{act} {mode} {name}"] = int((g.long() != w.long()).sum())
    emit({"phase": "score_rank_elementwise", "shape": [B, N, n_items], "off_lanes": checks,
          "card": smi_line})
    bad = {k: v for k, v in checks.items() if v}
    if bad:
        raise AssertionError(f"score_rank_elementwise: counts off the plain version's {bad}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sr.score_rank_cuda(x, bias, n_items, tgt, "median", "elu-1")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps = SCORE_RANK_STEPS
    xs = [x, torch.randn((B, N), generator=gen, device=DEVICE) * 3.0]
    kern = lambda s: sr.score_rank_cuda(xs[s % 2], bias, n_items, tgt, "standard", "elu-1")
    plain = lambda s: sr.score_rank_plain(xs[s % 2], bias, n_items, tgt, "standard", "elu-1")
    times = proto_measure.device_times(kern, steps=steps)
    ours = {k: v for k, v in times.items() if "score_rank" in k}
    if len(ours) != 2 or any(abs(n - steps) > steps // 16 for _, n in ours.values()):
        raise AssertionError(f"score_rank_elementwise: kernels per call {times}")
    bytes_read = B * N * 4
    rec = {"phase": "score_rank_elementwise_timing", "shape": [B, N, n_items],
           "act": "elu-1",
           "ms": sum(us / n for us, n in ours.values()) / 1e3,
           "ops": {k[:60]: us / n for k, (us, n) in ours.items()},
           "other_ops": {k[:60]: v for k, v in times.items() if k not in ours},
           "step_ms": proto_measure.steps_us(kern, steps=steps) / 1e3,
           "plain_ms": proto_measure.steps_us(plain, steps=steps, reps=3) / 1e3,
           "bound_ms": bytes_read / HBM_BYTES_PER_S * 1e3, "bytes": bytes_read,
           "bound_by": "bytes", "library_ms": None, "card": smi_line}
    emit(rec)
    return rec


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
    state (slot: dtype) while the block runs; each goes on to
    ``sparse_update.fused_update``, which counts its launch. Yields two
    dicts: the updates run eagerly, and those recorded by a graph capture
    (run once per replay, never by the capture: :func:`_replayed`)."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import sparse_update

    eager, captured = {}, {}
    fused = sparse_update.fused_update

    def counted(opt, table, idx, g, st, sr_seed=None):
        state = ",".join(f"{k}:{str(v.dtype).replace('torch.', '')}" for k, v in st.items())
        key = f"{tuple(table.shape)} K={idx.shape[0]} {state}"
        counts = captured if torch.cuda.is_current_stream_capturing() else eager
        counts[key] = counts.get(key, 0) + 1
        return fused(opt, table, idx, g, st, sr_seed=sr_seed)

    if on:
        sparse_update.fused_update = counted
    try:
        yield eager, captured
    finally:
        sparse_update.fused_update = fused


def _replayed(eager, captured, replays):
    """The updates that ran: the eager ones and the captured ones once per
    replay."""
    return {k: eager.get(k, 0) + captured.get(k, 0) * replays
            for k in sorted(set(eager) | set(captured))}


@contextlib.contextmanager
def _chunk_fns(eager=False):
    """The chunk functions that ``fit`` makes while the block runs, on one
    device or on a mesh, in the yielded list; with ``eager`` they run the
    eager loop, the captured step's plain version (``_eager=True``)."""
    from gru4rec_tpu_torch.models import gru4rec
    from gru4rec_tpu_torch.parallel import dist_step
    from gru4rec_tpu_torch.train import step as tstep

    made = []
    make, make_dist = gru4rec.make_chunk_fn, gru4rec.make_dist_chunk_fn

    def recorded(cfg, n_items):
        made.append(tstep.make_chunk_fn(cfg, n_items, _eager=eager))
        return made[-1]

    def recorded_dist(cfg, n_items, mesh):
        made.append(dist_step.make_dist_chunk_fn(cfg, n_items, mesh, _eager=eager))
        return made[-1]

    gru4rec.make_chunk_fn, gru4rec.make_dist_chunk_fn = recorded, recorded_dist
    try:
        yield made
    finally:
        gru4rec.make_chunk_fn, gru4rec.make_dist_chunk_fn = make, make_dist


def _graph_record(phase, made, steps):
    """The captured step of the one chunk function a ``fit`` made: eager
    warm-up steps, replays (together every step), the bytes its pool
    reserved."""
    (fn,) = made
    runner = fn.runner
    if runner is None or runner.graph is None or runner.warm + runner.replays != steps:
        raise AssertionError(f"{phase}: fit did not replay a captured step per step "
                             f"({steps} steps, runner {runner and vars(runner)})")
    return {"warmup_steps": runner.warm, "replays": runner.replays,
            "pool_bytes": runner.pool_bytes}


def mm_per_step(cfg):
    """(forward, backward) tensor-core products of one step of ``cfg``
    (``ops/mixed_mm.py``; none under float32 products): per layer the
    input projection (none on the one-hot first layer, whose row gather is
    that product) and the cell's two, then the scores; a gradient of both
    operands of each but the incoming hidden state's (``H · Wrz``; no
    gradient flows into ``H``). An evaluation step runs the forward ones."""
    if cfg.compute_dtype != "bfloat16":
        return 0, 0
    layers = len(cfg.layers)
    fwd = 3 * layers + (0 if _onehot(cfg) else 1)
    return fwd, 2 * fwd - layers


def _train(phase, cfg, train, test, smi_line, per_step, cut_off=(1, 5, 20), extra=None):
    """``GRU4Rec.fit`` for one epoch then ``evaluate``, with the kernel's
    and the tensor-core product's launch counters set to 0 just before and
    read just after. ``per_step`` = {mode: launches per step} that the path
    must show (every other mode none); the products must number
    ``mm_per_step`` per training step and its forward ones per evaluation
    step (``mm_launches``); the full-catalog ranking kernel must run once
    per evaluation step under a final activation it takes (a softmax or an
    elementwise one), else never (``score_rank_launches``); ``fit`` must
    have replayed its captured step on every step but the warm-up
    (``graph``: warm-up steps, replays, pool bytes). With
    ``extra`` (a dict of fields for the record), the record
    also holds ``evaluate``'s seconds and events/s, the device memory peak
    of the run and ``updates``: the table shape, K and state of the
    row-sparse updates by count (``_updates``). Returns the phase's JSON
    record and the fitted model."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec, evaluate
    from gru4rec_tpu_torch.eval.evaluation import _eval_schedule
    from gru4rec_tpu_torch.ops import mixed_mm
    from gru4rec_tpu_torch.ops.kernels import score_rank, sparse_update

    model = GRU4Rec(cfg, device=DEVICE)
    details = {}
    if extra is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sparse_update.reset_launches()
    mixed_mm.reset_launches()
    score_rank.reset_launches()
    with _schedules() as schedules, _updates(extra is not None) as (eager, captured), \
            _chunk_fns() as made:
        model.fit(train)
        t_eval = time.perf_counter()
        rec, mrr = evaluate(model, test, cut_off=list(cut_off), batch_size=512)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t_eval
    by_mode = dict(sparse_update.launches_by_mode)
    mm_launches = dict(mixed_mm.launches_by_mode)
    steps = sum(e["steps"] for e in model.epoch_stats)
    graph = _graph_record(phase, made, steps)
    eval_steps = _eval_schedule(model, test, 512, "SessionId", "ItemId", "Time").n_steps
    fwd, bwd = mm_per_step(cfg)
    want = {"forward": fwd * (steps + eval_steps), "backward": bwd * steps}
    if mm_launches != want:
        raise AssertionError(f"{phase}: tensor-core products {mm_launches} over {steps} "
                             f"training and {eval_steps} evaluation steps, expected {want}")
    ranked = sum(score_rank.launches_by_mode.values())
    if ranked != (eval_steps if score_rank.takes(cfg.final_act) else 0):
        raise AssertionError(f"{phase}: score_rank ran {ranked} times over {eval_steps} "
                             f"evaluation steps under final_act={cfg.final_act!r}")
    if extra is not None:
        n_eval = int((test.groupby("SessionId").size() - 1).sum())
        details = {**extra, "eval_events": n_eval, "eval_seconds": t_eval,
                   "eval_events_per_s": n_eval / t_eval,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "updates": _replayed(eager, captured, graph["replays"])}
    # fit builds one schedule per epoch in a random order, else one for all
    # epochs; evaluate one
    _check_schedules(phase, schedules,
                     (cfg.n_epochs if cfg.train_random_order else 1) + 1)

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
              "launches": by_mode, "mm_launches": mm_launches, "eval_steps": eval_steps,
              "score_rank_launches": ranked,
              "graph": graph, **schedules, **details,
              "card": smi_line}
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
    rec, model = _train("train_sr", flagship_cfg(opt_state_dtype="bfloat16_sr"), train, test,
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
    return rec, model


def phase_train_adam_sr(smi_line):
    """The flagship with adam and bfloat16_sr state (K3 on the full-width
    Wy, once per step), on the train phase's data: the adam + SR table size
    that the JAX package sends to its compact kernel. Adam takes a learning
    rate of 0.001: at the flagship's 0.05 it does not learn (PERF.md)."""
    train, test = synth_split()
    cfg = flagship_cfg(adapt="adam", learning_rate=0.001, opt_state_dtype="bfloat16_sr")
    return _train("train_adam_sr", cfg, train, test, smi_line, {"K3": 1})


def phase_train_onehot(smi_line):
    """Path B: param_samples/rsc15_bpr-max.py on RSC15-shaped sessions (K4 on
    the 300-wide Wx0, K1 on the 128-wide Wy, each once per step)."""
    train, test = synth_split(seed=1, n_items=RSC15_ITEMS, mean_len=RSC15_MEAN_SESSION_LEN)
    rec, model = _train("train_onehot", rsc15_cfg(), train, test, smi_line,
                        {"K4": 1, "K1": 1})
    n_pad = rec["tables"]["Wy"][0]
    if rec["n_items"] != RSC15_ITEMS or rec["tables"]["Wx0"] != [n_pad, 300] or \
            rec["tables"]["Wy"] != [n_pad, 128]:
        raise AssertionError(f"unexpected RSC15 tables {rec['tables']} for "
                             f"{rec['n_items']} items")
    return rec, model


def phase_train_sgd(smi_line):
    """The flagship with plain SGD (``adapt=None``): no optimizer state to
    fuse, so the row-sparse update is the torch-op path inside the captured
    step, and no kernel launches."""
    train, test = synth_split()
    return _train("train_sgd", flagship_cfg(adapt=None), train, test, smi_line, {})


GRAPH_DROPOUT_STEPS = 6  # graph_dropout's replayed steps, after the warm-up


def phase_graph(smi_line, runs):
    """The captured training step against its plain version, the eager
    loop (``make_chunk_fn(..., _eager=True)``, run through ``fit``), at
    full width on the same data. ``runs`` = {phase: (config, train split,
    the phase's fitted model, its record)}: the flagship (K1), ``train_sr``
    (K2, its seeds read on the device), ``train_adam_sr`` (K3),
    ``train_onehot`` (K4 and K1) and ``train_sgd`` (no kernel). Each is
    trained for its epoch eagerly: the epoch loss and every parameter, optimizer-state and hidden-state
    leaf bit-equal to the graph's, the same launches by mode; wall seconds
    and events/s of both. Then ``graph_dropout`` and ``graph_seed``."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    def tree(model):
        st = model._train_state
        return dict(_leaves({"params": st.params, "opt_state": st.opt_state, "H": st.H}))

    for phase, (cfg, train, graphed, graph_rec) in runs.items():
        model = GRU4Rec(cfg, device=DEVICE)
        sparse_update.reset_launches()
        with _chunk_fns(eager=True) as made:
            model.fit(train)
        torch.cuda.synchronize()
        by_mode = dict(sparse_update.launches_by_mode)
        want, got = tree(graphed), tree(model)
        differ = [k for k in want if not _same_bits(got[k], want[k])]
        stats = model.epoch_stats[-1]
        out = {"phase": "graph", "path": phase, "steps": stats["steps"],
               "loss": stats["loss"], "graph_loss": graph_rec["loss"],
               "leaves": len(want), "leaves_differ": differ,
               "max_abs_err": max(float((got[k].double() - want[k].double()).abs().max())
                                  for k in want),
               "launches": by_mode, "graph_launches": graph_rec["launches"],
               "seconds": stats["seconds"], "graph_seconds": graph_rec["seconds"],
               "events_per_s": stats["events"] / stats["seconds"],
               "graph_events_per_s": graph_rec["events_per_s"],
               "graph": graph_rec["graph"], "card": smi_line}
        emit(out)
        if made[0].runner is not None:
            raise AssertionError(f"graph {phase}: the eager run captured a graph")
        if differ or out["loss"] != out["graph_loss"] or by_mode != graph_rec["launches"]:
            raise AssertionError(f"graph {phase}: the captured step and the eager loop "
                                 f"differ: {out}")
        del model
    _graph_dropout(smi_line)
    _graph_seed()


def _graph_dropout(smi_line):
    """The RetailRocket published configuration (dropout 0.5 on the
    embedding, 0.05 on the hidden state) at full width on the flagship
    split, one step per chunk call, eagerly and through the graph: each
    dropout output is copied into a probe, which under capture lives in the
    graph's pool and is refilled by every replay. The masks (zero patterns)
    of every step equal the eager loop's, differ between consecutive
    replays, and keep about 1 - p of each layer."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.models import gru
    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.train import step as tstep

    cfg = published_configs()["retailrocket"][0]
    itemidmap, sched, packed, _ = _flagship_schedule(cfg)
    n = len(itemidmap)
    GRU4Rec(cfg, device=DEVICE)  # the card's float32 matmuls
    steps = tstep.WARMUP_STEPS + GRAPH_DROPOUT_STEPS
    dropout, probes = gru._dropout, []

    def probing(x, p, gen, lanes=None):
        y = dropout(x, p, gen, lanes)
        probes.append(y.clone())
        return y

    runs = []
    gru._dropout = probing
    try:
        for eager in (True, False):
            probes.clear()
            state = tstep.init_train_state(cfg, n, DEVICE)
            fn = tstep.make_chunk_fn(cfg, n, _eager=eager)
            samp1 = torch.from_numpy(packed).to(DEVICE)
            logp0 = torch.zeros(pad_items(n, cfg.item_pad_multiple), device=DEVICE)
            masks = []
            for t in range(steps):
                fn(state, *(a[t:t + 1] for a in (sched.in_idx, sched.out_idx, sched.valid,
                                                  sched.reset)), samp1, logp0)
                if t == 0:
                    per_step = len(probes)
                masks.append([(y == 0).cpu() for y in probes[-per_step:]])
            runs.append((masks, fn.runner))
    finally:
        gru._dropout = dropout
    (eager_masks, _), (graph_masks, runner) = runs
    replayed = graph_masks[tstep.WARMUP_STEPS:]
    same = [all(torch.equal(a, b) for a, b in zip(x, y))
            for x, y in zip(eager_masks, graph_masks)]
    differ = [any(not torch.equal(a, b) for a, b in zip(x, y))
              for x, y in zip(replayed, replayed[1:])]
    drop_share = [[float(m.float().mean()) for m in x] for x in replayed]
    out = {"phase": "graph_dropout", "config": "retailrocket",
           "dropout": [cfg.dropout_p_embed, cfg.dropout_p_hidden],
           "probes_per_step": per_step, "replays": runner.replays,
           "equal_to_eager": same, "differ_from_previous_replay": differ,
           "dropped_share": drop_share, "card": smi_line}
    emit(out)
    ps = ([] if _onehot(cfg) else [cfg.dropout_p_embed]) + \
        [cfg.dropout_p_hidden] * len(cfg.layers)
    if not (all(same) and all(differ) and runner.replays == GRAPH_DROPOUT_STEPS
            and per_step == len(ps)
            and all(abs(s - p) < 0.05 for x in drop_share for s, p in zip(x, ps))):
        raise AssertionError(f"graph_dropout: {out}")


def _graph_seed():
    """K2 and K3 at the flagship shape with the stochastic-rounding seed
    read on the device (a 0-d int32 tensor, as a replayed step passes it)
    against the same seed by value: three calls each from the same state,
    table and state bit-equal."""
    import torch

    from gru4rec_tpu_torch.ops.kernels import sparse_update

    rng = np.random.RandomState(7)
    idx = _index_sets(rng, N_ITEMS, 2 * 80 + 2048, 80, 1)[0]
    out = {"phase": "graph_seed", "K": len(idx)}
    for adapt, mode in (("adagrad", "K2"), ("adam", "K3")):
        runs = []
        for seed in (SR_SEED[0], torch.tensor(SR_SEED[0], dtype=torch.int32, device=DEVICE)):
            opt, table, idx_t, g, st = _make_case(adapt, 0.4, 0.0, "bfloat16_sr",
                                                  N_ITEMS + 24, 256, idx, 3)
            for _ in range(3):
                sparse_update.fused_update(opt, table, idx_t, g, st, sr_seed=(seed, 0))
            runs.append([table] + list(st.values()))
        torch.cuda.synchronize()
        out[mode] = all(_same_bits(a, b) for a, b in zip(*runs))
    emit(out)
    if not (out["K2"] and out["K3"]):
        raise AssertionError(f"the device seed and the seed by value differ: {out}")


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


LEARN_SR_SEEDS = tuple(range(10))  # learn_sr's seeds beside its config's own


def phase_learn_sr(smi_line):
    """adam + SR state (K3 on E and Wy, twice per step) at the config's own
    seed and at ``LEARN_SR_SEEDS``: the mean recall@1 >= 0.9. A single seed
    is no bar for this configuration: the order of the float32 sums in its
    products alone moves one seed's recall@1 by up to 0.16 (ROADMAP S3,
    ``scripts/product_order_spread_torch.py --learn``). Returns the own
    seed's record."""
    train, test = markov(800), markov(100, seed=5)
    rec, _ = _train("learn_sr", learn_sr_cfg(), train, test, smi_line, {"K3": 2})
    if rec["tables"]["E"][1] != 12 or rec["opt_state"]["E"]["acc2"] != "bfloat16":
        raise AssertionError(f"unexpected E table / state {rec['tables']} {rec['opt_state']}")
    recall = {learn_sr_cfg().seed: rec["recall"]["@1"]}
    for seed in LEARN_SR_SEEDS:
        cfg = learn_sr_cfg()
        cfg.seed = seed
        recall[seed] = _train("learn_sr_seed", cfg, train, test, smi_line,
                              {"K3": 2})[0]["recall"]["@1"]
    mean = float(np.mean(list(recall.values())))
    emit({"phase": "learn_sr_seeds", "recall1": recall, "mean": mean, "card": smi_line})
    if mean < 0.9:
        raise AssertionError(f"adam + bfloat16_sr markov recall@1 mean {mean} < 0.9: {recall}")
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
SERVE_WARMUP = 3       # untimed calls: eager warm-up, capture, one replay
SERVE_MAX_LAUNCHES = 6  # host launches of a captured call, at most
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
    from gru4rec_tpu_torch.utils.profiling import trace

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
    eager = _serving_twin(model)
    eager._serve_graphs = None  # the graphs' plain version
    for batch in SERVE_BATCHES:
        sess = _fresh_sessions(batch)
        calls = [items(batch) for _ in range(SERVE_REPS)]
        for m in (model, eager):
            for x in calls[:SERVE_WARMUP]:  # a graph is captured at the second call
                m.predict_topk(sess, x, k=SERVE_K, batch=batch)
        wall = {"graph": [], "eager": []}
        for x in calls:  # in turns
            for way, m in (("graph", model), ("eager", eager)):
                t0 = time.perf_counter()
                m.predict_topk(sess, x, k=SERVE_K, batch=batch)
                wall[way].append(time.perf_counter() - t0)
        dev = device_times(
            lambda s: model.predict_topk(sess, calls[s], k=SERVE_K, batch=batch),
            steps=SERVE_REPS)
        ms = float(np.median(wall["graph"])) * 1e3
        device_ms = sum(v[0] for v in dev.values()) / SERVE_REPS / 1e3
        launches = {way: trace(lambda: [m.predict_topk(sess, x, k=SERVE_K, batch=batch)
                                        for x in calls], SERVE_REPS)
                    for way, m in (("graph", model), ("eager", eager))}
        out[f"topk_batch{batch}"] = {
            "ms": ms, "device_ms": device_ms, "device_share": device_ms / ms,
            "events_per_s": batch * SERVE_REPS / sum(wall["graph"]), "device_ops": len(dev),
            "host_launches": launches["graph"]["host_launches"],
            "eager_ms": float(np.median(wall["eager"])) * 1e3,
            "eager_host_launches": launches["eager"]["host_launches"],
            "eager_device_busy_ms": launches["eager"]["device_busy_ms"],
            "graph_device_busy_ms": launches["graph"]["device_busy_ms"],
            "graph_pool_bytes": model._serve_graphs[("topk", batch, SERVE_K)].pool_bytes}
        if launches["graph"]["host_launches"] > SERVE_MAX_LAUNCHES:
            raise AssertionError(f"serve: a captured call at batch {batch} issues "
                                 f"{launches['graph']['host_launches']} host launches")
    del eager
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
    out["graph_vs_eager"] = _serve_graph_vs_eager(model, items)
    out.update(seconds=time.time() - t_phase, card=smi_line)
    emit(out)


def _serve_graph_vs_eager(model, items):
    """The captured serving calls against eager serving, both on fresh
    twins of ``model``: ``predict_topk`` and full-catalog
    ``predict_next_batch``, three calls of each kind in a row (a warm-up,
    a capture, a replay), with session changes on every call, over k =
    20, k = 10, batch 64, batch 256 and batch 64 again (fresh lanes: a new
    capture), then the same after ``cast_for_serving("bfloat16")`` of both
    (a new capture): ids, scores, score frames and lanes bit-equal."""
    import torch

    twins = {"graph": _serving_twin(model), "eager": _serving_twin(model)}
    twins["eager"]._serve_graphs = None
    rng = np.random.RandomState(3)
    sess = {}
    plan = [("topk", 64, SERVE_K), ("topk", 64, 10), ("next", 64, None),
            ("topk", 256, SERVE_K), ("next", 256, None), ("topk", 64, SERVE_K)]
    calls, diff = 0, 0.0
    for cast in (False, True):
        if cast:
            for m in twins.values():
                m.cast_for_serving("bfloat16")
            if twins["graph"]._serve_graphs:
                raise AssertionError("cast_for_serving kept graphs of the old weights")
        for kind, batch, k in plan:
            for _ in range(3):
                s = sess.get(batch, _fresh_sessions(batch))
                s = np.where(rng.rand(batch) < 0.3, _fresh_sessions(batch), s)
                sess[batch] = s
                x = items(batch)
                got = {}
                for way, m in twins.items():
                    if kind == "topk":
                        got[way] = m.predict_topk(s, x, k=k, batch=batch)
                    else:
                        got[way] = (m.predict_next_batch(s, x, batch=batch).values,)
                    got[way] += tuple(h.cpu().numpy() for h in m.H)
                calls += 1
                for a, b in zip(got["graph"], got["eager"]):
                    if a.dtype == object:
                        if not np.array_equal(a, b):
                            raise AssertionError(f"serve: top-k ids differ ({kind}, {batch}, {k})")
                    else:
                        diff = max(diff, float(np.abs(a.astype(np.float64)
                                                      - b.astype(np.float64)).max()))
    graphs = twins["graph"]._serve_graphs
    out = {"calls": calls, "max_abs_err": diff,
           "replays": {"/".join(map(str, k)): g.replays for k, g in graphs.items()},
           "bound_dtype": str(twins["graph"].params["Wy"].dtype).replace("torch.", "")}
    if diff != 0.0 or not all(g.replays for g in graphs.values()) or \
            set(graphs) != {("topk", 64, SERVE_K), ("topk", 64, 10), ("next", 64),
                            ("topk", 256, SERVE_K), ("next", 256)}:
        raise AssertionError(f"serve: captured calls against eager serving: {out}")
    del twins
    torch.cuda.empty_cache()
    return out


EVAL_GRAPH_EVENTS = 8_000   # each eval_graph evaluation's synthetic test events
EVAL_GRAPH_SUBSET = 1_000   # the subset path's item list
EVAL_GRAPH_REPS = 3         # timed calls of each way, in turns
EVAL_BATCH = 512
EVAL_CUTOFFS = [1, 5, 10, 20]


@contextlib.contextmanager
def _eval_lanes():
    """Records, while the block runs, the lanes each evaluation step is
    given (``make_eval_step``'s steps write them in place): the last entry
    holds the final lanes of the last call."""
    from gru4rec_tpu_torch.eval import evaluation

    seen = []
    make = evaluation.make_eval_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def wrapped(params, H, *rest, **kw):
            seen.append(H)
            return step(params, H, *rest, **kw)

        return wrapped

    evaluation.make_eval_step = recording
    try:
        yield seen
    finally:
        evaluation.make_eval_step = make


def phase_eval_graph(flagship, smi_line):
    """The captured evaluation step (``eval/evaluation.py::_EvalGraph``)
    against its plain version, the eager loop (``evaluate(_eager=True)``),
    at two widths: the train phase's fitted flagship model (36,968 items,
    GRU-224, elu-0.5) and the rees46 published configuration at its width
    (200,000 items, GRU-512, softmax) from its seed, each on
    ``EVAL_GRAPH_EVENTS`` synthetic test events (``eval_sessions``) at batch
    512 and cutoffs 1, 5, 10, 20. In all four tie modes, on the full catalog
    and on a subset of ``EVAL_GRAPH_SUBSET`` items: Recall, MRR and the
    final lanes bit-equal (``max_abs_err`` 0.0), every step after the
    warm-up replayed; the scores table rounded to bfloat16 once a call
    (``evaluation.table_casts``, ``table_casts`` by case: eager, graph) on
    rees46's fused route (full catalog, a tie mode of the ranking kernel)
    and never elsewhere. Then, in the standard mode, three ways in turns: the
    eager loop; ``graph``, the standalone call, which captures its step and
    frees the graph when it returns; ``graph_kept``, the graph kept across
    calls as ``fit`` keeps it. For each: the median ms per step (512
    lanes) and per 512 scored events, the host launches, device busy ms
    and kernels per step (``utils/profiling.trace``; the kept graph's busy
    ms also as ``kept_busy_ms_per_step``), the table's refreshes per call,
    the memory peak of a call; the graph pool's bytes. A standalone call leaves
    ``memory_allocated`` as it found it (``memory_reserved`` is printed
    beside it: the call gives its pool back to the device)."""
    import torch

    from gru4rec_tpu_torch import evaluate
    from gru4rec_tpu_torch.eval import evaluation
    from gru4rec_tpu_torch.eval.evaluation import _eval_schedule
    from gru4rec_tpu_torch.ops.ranking import TIE_MODES
    from gru4rec_tpu_torch.utils.cuda_graph import WARMUP_STEPS
    from gru4rec_tpu_torch.utils.profiling import trace

    t_phase = time.time()
    from gru4rec_tpu_torch.examples import reproduce_published

    rees46 = reproduce_published.load_config(
        reproduce_published.EXPECTED["rees46"]["paramfile"])
    models = {"flagship": flagship,
              "rees46": seeded_model(rees46, PUBLISHED_ITEMS["rees46"])}
    for name, model in models.items():
        catalog = model.itemidmap.index.values
        test = eval_sessions(EVAL_GRAPH_EVENTS, model.n_items)
        test["ItemId"] = catalog[test["ItemId"].values]
        rng = np.random.RandomState(2)
        subset = catalog[rng.choice(model.n_items, EVAL_GRAPH_SUBSET, replace=False)]
        steps = _eval_schedule(model, test, EVAL_BATCH, "SessionId", "ItemId", "Time")
        events, steps = steps.n_events, steps.n_steps
        kw = dict(cut_off=EVAL_CUTOFFS, batch_size=EVAL_BATCH)

        def casts(call):
            """``call()``'s result and the table refreshes it counted."""
            evaluation.reset_table_casts()
            out = call()
            return out, evaluation.table_casts["per_call"]

        cases, table_casts, wrong_casts = {}, {}, {}
        with _eval_lanes() as seen:
            for mode in TIE_MODES:
                for items in ("full", "subset"):
                    args = dict(kw, mode=mode, items=subset if items == "subset" else None)
                    want, n_eager = casts(lambda: evaluate(model, test, _eager=True, **args))
                    H_want = seen[-1]
                    graphs = {}
                    got, n_graph = casts(lambda: evaluate(model, test, _graphs=graphs, **args))
                    (runner,) = graphs.values()
                    fused = name == "rees46" and mode != "tiebreaking" and items == "full"
                    table_casts[f"{mode}/{items}"] = [n_eager, n_graph]
                    if [n_eager, n_graph] != [int(fused)] * 2:
                        wrong_casts[f"{mode}/{items}"] = [n_eager, n_graph]
                    if runner.warm != WARMUP_STEPS or runner.warm + runner.replays != steps:
                        raise AssertionError(f"eval_graph {name} {mode}/{items}: "
                                             f"{runner.warm} eager and {runner.replays} "
                                             f"replayed steps of {steps}")
                    cases[f"{mode}/{items}"] = max(
                        [abs(a - b) for a, b in zip(got[0] + got[1], want[0] + want[1])]
                        + [float((h - hw).abs().max()) for h, hw in zip(runner.H, H_want)])
                    del graphs, runner, H_want
                    seen.clear()
        kept = {}
        ways = {"eager": dict(_eager=True), "graph": {}, "graph_kept": dict(_graphs=kept)}
        for extra in ways.values():  # set-up and capture, not timed
            evaluate(model, test, **kw, **extra)
        seconds, peaks, refreshes = {w: [] for w in ways}, {}, {w: [] for w in ways}
        for _ in range(EVAL_GRAPH_REPS):
            for way, extra in ways.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                evaluation.reset_table_casts()
                t0 = time.perf_counter()
                evaluate(model, test, **kw, **extra)
                seconds[way].append(time.perf_counter() - t0)
                refreshes[way].append(evaluation.table_casts["per_call"])
                peaks[way] = max(peaks.get(way, 0), torch.cuda.max_memory_allocated())
        traced = {way: trace(lambda: evaluate(model, test, **kw, **extra), steps)
                  for way, extra in ways.items()}
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        reserved = [torch.cuda.memory_reserved()]
        evaluate(model, test, **kw)
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        reserved.append(torch.cuda.memory_reserved())
        (runner,) = kept.values()
        rec = {"phase": "eval_graph", "model": name, "n_items": model.n_items,
               "layers": model.config.layers, "final_act": model.config.final_act,
               "test_events": len(test), "scored_events": events, "steps": steps,
               "batch_size": EVAL_BATCH, "cutoffs": EVAL_CUTOFFS,
               "subset_items": EVAL_GRAPH_SUBSET, "warmup_steps": WARMUP_STEPS,
               "max_abs_err": cases, "table_casts": table_casts,
               "kept_busy_ms_per_step": traced["graph_kept"]["device_busy_ms"],
               "ways": {way: {
                   "seconds": seconds[way],
                   "ms_per_step": float(np.median(seconds[way])) * 1e3 / steps,
                   "ms_per_512_events": float(np.median(seconds[way])) * 1e3
                   / (events / EVAL_BATCH),
                   "host_launches_per_step": traced[way]["host_launches"],
                   "device_busy_ms_per_step": traced[way]["device_busy_ms"],
                   "kernels_per_step": traced[way]["kernels"],
                   "table_casts_per_call": refreshes[way],
                   "max_memory_allocated": peaks[way]} for way in ways},
               "pool_bytes": runner.pool_bytes,
               "memory_allocated_before_after": [before, after],
               "memory_reserved_before_after": reserved, "card": smi_line}
        emit(rec)
        if any(cases.values()):
            raise AssertionError(f"eval_graph {name}: the graph and the eager loop differ: "
                                 f"{cases}")
        if wrong_casts:
            raise AssertionError(f"eval_graph {name}: table refreshes (eager, graph) of a "
                                 f"call: {wrong_casts}")
        if before != after:
            raise AssertionError(f"eval_graph {name}: a standalone evaluate left "
                                 f"{after - before} bytes allocated")
        del kept, runner
    del models
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "eval_graph_summary", "seconds": time.time() - t_phase, "card": smi_line})


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


@contextlib.contextmanager
def _eval_builds():
    """Counts, while the block runs, the schedules ``evaluate`` builds
    (``eval/evaluation.py``'s ``build_schedule``) and the evaluation
    runners it makes (``_EvalGraph`` objects, captured on the card where a
    call has more than ``WARMUP_STEPS`` steps)."""
    from gru4rec_tpu_torch.eval import evaluation

    counts = {"valid_schedules": 0, "valid_graphs": 0}
    build, graph = evaluation.build_schedule, evaluation._EvalGraph

    def counted_build(*args, **kw):
        counts["valid_schedules"] += 1
        return build(*args, **kw)

    class Counted(graph):
        def __init__(self, *args, **kw):
            counts["valid_graphs"] += 1
            super().__init__(*args, **kw)

    evaluation.build_schedule, evaluation._EvalGraph = counted_build, Counted
    try:
        yield counts
    finally:
        evaluation.build_schedule, evaluation._EvalGraph = build, graph


def phase_resume(smi_line):
    """Exact resume across a training checkpoint, on the markov chain with
    SR state (K2): two uninterrupted runs (their difference is
    ``repeat_diff``), one epoch with ``checkpoint_every=1`` then
    ``resume=`` for the rest, which also writes a ``profile_dir`` trace
    (its difference from the uninterrupted run is ``resume_diff``; K2
    launches once per resumed step); ``resume_diff <= repeat_diff``. Then
    ``eval_data`` with ``early_stop_patience`` and ``keep_best``: the kept
    parameters equal those of the best epoch's run, and that ``fit``'s
    validations built one schedule (``valid_schedules``) and captured one
    evaluation step (``valid_graphs``), as JAX's ``fit`` builds one
    schedule."""
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

        with _eval_builds() as valid_builds:
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
           **valid_builds,
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
    # fit memoizes its validation schedule and keeps its captured step
    if len(mrrs) < 2 or valid_builds != {"valid_schedules": 1, "valid_graphs": 1}:
        raise AssertionError(f"{len(mrrs)} validations built {valid_builds}")
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
    working directory), run beside the other two."""
    from concurrent.futures import ThreadPoolExecutor

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
        with ThreadPoolExecutor(1) as pool:
            nan_job = pool.submit(_cli, [markov_p, "-ps", "loss=bpr-max,layers=64,"
                                         "batch_size=32,n_sample=64,n_epochs=1,"
                                         "constrained_embedding=True,learning_rate=nan"], env)
            fit, fit_s, fit_pm = _cli([train_p, "-ps", _param_string(FLAGSHIP), "-s",
                                       model_p, "-t", test_p, "-m", "1", "5", "20", "-lpm"],
                                      env)
            load, load_s, load_pm = _cli([model_p, "-l", "-t", test_p, "-m", "1", "5", "20",
                                          "-lpm"], env)
            nan, nan_s, _ = nan_job.result()
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


MESH_WINDOW = 64   # mesh_1x1's steps per timed window of the chunk functions
MESH_ROUNDS = 4    # timed windows of each way, in turns


def _mesh_ways(mesh, smi_line):
    """The flagship's chunk function three ways on the same windows of its
    schedule: ``train`` (one device, the captured step), ``mesh`` (the 1x1
    mesh's captured step) and ``mesh_eager`` (its eager loop). After a
    warm-up window (the eager steps and the capture), ``MESH_ROUNDS``
    windows of ``MESH_WINDOW`` steps each, the ways in turns (the order
    reversed every round): ms per step and events/s, median over the
    rounds; then one traced window each (``utils/profiling.py``): device
    busy ms, idle share, host launches, kernels and copies per step."""
    import torch

    from gru4rec_tpu_torch.models.gru import pad_items
    from gru4rec_tpu_torch.parallel.dist_step import make_dist_chunk_fn, shard_train_state
    from gru4rec_tpu_torch.train.step import init_train_state, make_chunk_fn, make_generator
    from gru4rec_tpu_torch.utils.profiling import trace

    cfg = flagship_cfg()
    itemidmap, sched, packed, _ = _flagship_schedule(cfg)
    n = len(itemidmap)
    dev = mesh.device
    samp1 = torch.from_numpy(packed).to(dev)
    logp0 = torch.zeros(pad_items(n, cfg.item_pad_multiple), device=dev)
    ways = {}
    for name in ("train", "mesh", "mesh_eager"):
        if name == "train":
            ways[name] = (init_train_state(cfg, n, dev), make_chunk_fn(cfg, n))
            continue
        state = init_train_state(cfg, n, "cpu")
        state.gen = make_generator(cfg.seed, dev)
        ways[name] = (shard_train_state(state, cfg, mesh),
                      make_dist_chunk_fn(cfg, n, mesh, _eager=name == "mesh_eager"))

    def run(name, w):
        state, fn = ways[name]
        sl = [a[w * MESH_WINDOW:(w + 1) * MESH_WINDOW]
              for a in (sched.in_idx, sched.out_idx, sched.valid, sched.reset)]
        return fn(state, *sl, samp1, logp0)[1]

    for name in ways:
        run(name, 0)
    torch.cuda.synchronize()
    timed = {name: [] for name in ways}
    for r in range(MESH_ROUNDS):
        for name in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            t0 = time.perf_counter()
            events = run(name, 1 + r)
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t0, events))
    out = {}
    for name, (state, fn) in ways.items():
        traced = trace(lambda: run(name, 1 + MESH_ROUNDS), MESH_WINDOW)
        ms = float(np.median([sec for sec, _ in timed[name]])) * 1e3 / MESH_WINDOW
        out[name] = {
            "ms_per_step": ms,
            "events_per_s": float(np.median([ev / sec for sec, ev in timed[name]])),
            "device_busy_ms_per_step": traced["device_busy_ms"],
            "idle_share": 1.0 - traced["device_busy_ms"] / ms,
            "host_launches_per_step": traced["host_launches"],
            "host_launches_by_call": traced["host_launches_by_call"],
            "kernels_per_step": traced["kernels"],
            "device_copies_per_step": traced["device_copies"],
            "pool_bytes": None if fn.runner is None else fn.runner.pool_bytes,
            "replays": None if fn.runner is None else fn.runner.replays}
    emit({"phase": "mesh_1x1_steps", "window": MESH_WINDOW, "rounds": MESH_ROUNDS, **out,
          "card": smi_line})
    return out


def _mesh_fit(cfg, train, mesh, eager=False):
    """``fit(mesh=)`` for one epoch with the launch counters set to 0 just
    before and read just after: the model, its launches and the chunk
    function it made."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    model = GRU4Rec(cfg, device=DEVICE)
    sparse_update.reset_launches()
    with _chunk_fns(eager=eager) as made:
        model.fit(train, mesh=mesh)
    torch.cuda.synchronize()
    return model, dict(sparse_update.launches_by_mode), made


def _differ(model, want):
    """The parameter and optimizer-state leaves of ``model`` whose bits
    differ from ``want`` ({path: tensor})."""
    got = dict(_leaves({"params": model._train_state.params,
                        "opt_state": model._train_state.opt_state}))
    return [k for k in want if k not in got or not _same_bits(got[k], want[k].cpu())]


def phase_mesh_1x1(flagship, train_rec, sr_rec, smi_line):
    """``fit(mesh=make_mesh(1, 1))`` of the flagship over NCCL on ``cuda:0``
    for the train phase's epoch: one captured step replayed per step after
    the warm-up (``graph``), loss, every parameter and optimizer leaf, and
    Recall/MRR@1/5/20 of ``evaluate(mesh=)`` (captured, and its eager loop)
    bit-equal to the train phase's; K1 once per step, replays counted; the
    same fit through the eager loop (``make_dist_chunk_fn(...,
    _eager=True)``) bit-equal too; the flagship with ``bfloat16_sr`` on the
    mesh bit-equal to ``train_sr`` (``sr_rec``: its loss and leaves), K2
    once per step; the three ways' steps in turns (``_mesh_ways``);
    ``predict_topk(mesh=)`` at batch 1, 64 and 256 through its captured
    call, equal to the single-device call (warm median ms per call of both
    in turns, the mesh call's device ms and host launches, events/s); the
    seconds ``make_mesh`` takes (it sets up each group's communicator)."""
    import torch
    import torch.distributed as dist

    from gru4rec_tpu_torch import evaluate
    from gru4rec_tpu_torch.ops.kernels import sparse_update
    from gru4rec_tpu_torch.ops.kernels.proto_measure import device_times
    from gru4rec_tpu_torch.parallel import make_mesh
    from gru4rec_tpu_torch.utils.profiling import trace

    t_phase = time.time()
    train, test = synth_split()
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1)
    mesh_seconds = time.perf_counter() - t0
    try:
        model, launches, made = _mesh_fit(flagship_cfg(), train, mesh)
        steps = sum(e["steps"] for e in model.epoch_stats)
        graph = _graph_record("mesh_1x1", made, steps)
        rec, mrr = evaluate(model, test, cut_off=[1, 5, 20], batch_size=512, mesh=mesh)
        eval_eager = evaluate(model, test, cut_off=[1, 5, 20], batch_size=512, mesh=mesh,
                              _eager=True)
        want = dict(_leaves({"params": flagship._train_state.params,
                             "opt_state": flagship._train_state.opt_state}))
        differ = _differ(model, want)
        eager_model, eager_launches, eager_made = _mesh_fit(flagship_cfg(), train, mesh,
                                                            eager=True)
        eager_differ = _differ(eager_model, dict(_leaves({
            "params": model._train_state.params, "opt_state": model._train_state.opt_state})))
        eager_stats = eager_model.epoch_stats[-1]
        del eager_model
        sr_model, sr_launches, sr_made = _mesh_fit(
            flagship_cfg(opt_state_dtype="bfloat16_sr"), train, mesh)
        sr_graph = _graph_record("mesh_1x1 bfloat16_sr", sr_made, steps)
        sr_differ = _differ(sr_model, sr_rec["leaves"])
        sr_loss = sr_model.epoch_stats[-1]["loss"]
        del sr_model
        stats = model.epoch_stats[-1]
        out = {"phase": "mesh_1x1", "backend": dist.get_backend(), "device": str(mesh.device),
               "capturable": mesh.capturable, "mesh_seconds": mesh_seconds, "steps": steps,
               "loss": model.epoch_stats[-1]["loss"],
               "train_loss": flagship.epoch_stats[-1]["loss"],
               "events_per_s": stats["events"] / stats["seconds"],
               "train_events_per_s": train_rec["events_per_s"],
               "graph": graph, "leaves": len(want), "leaves_differ": differ,
               "eager_runner": None if eager_made[0].runner is None else "set",
               "eager_leaves_differ": eager_differ, "eager_launches": eager_launches,
               "eager_events_per_s": eager_stats["events"] / eager_stats["seconds"],
               "sr_loss": sr_loss, "train_sr_loss": sr_rec["loss"], "sr_graph": sr_graph,
               "sr_leaves_differ": sr_differ, "sr_launches": sr_launches,
               "recall": dict(zip(("@1", "@5", "@20"), rec)),
               "mrr": dict(zip(("@1", "@5", "@20"), mrr)),
               "eval_graph_equals_eager": (rec, mrr) == tuple(eval_eager),
               "launches": launches}
        out["steps_in_turns"] = _mesh_ways(mesh, smi_line)
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
            traced = trace(lambda: [model.predict_topk(sess, x, k=SERVE_K, batch=batch,
                                                       mesh=mesh) for x in calls], SERVE_REPS)
            g = model._serve_graphs.get(("topk", batch, SERVE_K, mesh))
            out[f"topk_batch{batch}"] = {
                "same_as_single": bool(np.array_equal(ids_m, ids_s)
                                       and np.array_equal(sc_m, sc_s)),
                "captured": g is not None and g.replays > 0,
                "replays": None if g is None else g.replays,
                "pool_bytes": None if g is None else g.pool_bytes,
                "ms": float(np.median(wall["mesh"])) * 1e3,
                "single_ms": float(np.median(wall["single"])) * 1e3,
                "device_ms": sum(v[0] for v in dev.values()) / SERVE_REPS / 1e3,
                "host_launches": traced["host_launches"],
                "host_launches_by_call": traced["host_launches_by_call"],
                "events_per_s": batch * SERVE_REPS / sum(wall["mesh"])}
    finally:
        dist.destroy_process_group()
    out.update(seconds=time.time() - t_phase, card=smi_line)
    emit(out)
    if out["backend"] != "nccl" or not out["capturable"] or differ \
            or out["loss"] != out["train_loss"]:
        raise AssertionError(f"mesh_1x1 differs from the train phase: {out}")
    if out["recall"] != train_rec["recall"] or out["mrr"] != train_rec["mrr"] \
            or not out["eval_graph_equals_eager"]:
        raise AssertionError(f"mesh_1x1 metrics {out['recall']} {out['mrr']} against "
                             f"{train_rec['recall']} {train_rec['mrr']} and the eager loop")
    if eager_differ or out["eager_runner"] is not None:
        raise AssertionError(f"mesh_1x1's captured fit differs from its eager loop: {out}")
    for name, got, mode in (("graph", launches, "K1"), ("eager", eager_launches, "K1"),
                            ("bfloat16_sr", sr_launches, "K2")):
        if got != {**dict.fromkeys(sparse_update.MODES, 0), mode: steps}:
            raise AssertionError(f"mesh_1x1 {name} launched {got} in {steps} steps")
    if sr_differ or sr_loss != sr_rec["loss"]:
        raise AssertionError(f"mesh_1x1 bfloat16_sr differs from train_sr: {sr_differ}, "
                             f"loss {sr_loss} against {sr_rec['loss']}")
    ways = out["steps_in_turns"]
    if ways["mesh"]["replays"] is None or ways["mesh_eager"]["replays"] is not None:
        raise AssertionError(f"mesh_1x1 ways: {ways}")
    if not all(out[f"topk_batch{b}"]["same_as_single"] and out[f"topk_batch{b}"]["captured"]
               for b in SERVE_BATCHES):
        raise AssertionError(f"predict_topk(mesh=) differs from the single-device call or "
                             f"was not captured: {out}")


def _fit_built(cfg, train):
    """What ``fit`` builds for training from ``train``, read from a ``fit``
    on the CPU whose chunk function trains nothing: the model (item map,
    catalog) and ``{"schedules": [one per epoch built], "samp1": ...,
    "logp0": ...}``, the sampler and logq tables as CPU tensors."""
    import contextlib
    import io

    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.models import gru4rec

    built = {"schedules": []}
    build, make = gru4rec.build_schedule, gru4rec.make_chunk_fn

    def recorded(*a, **k):
        built["schedules"].append(build(*a, **k))
        return built["schedules"][-1]

    def stub(cfg, n_items):
        def chunk_fn(state, in_c, out_c, valid_c, reset_c, samp1, logp0, **_):
            built["samp1"], built["logp0"] = samp1, logp0
            return torch.zeros(()), int(valid_c.sum())
        return chunk_fn

    gru4rec.build_schedule, gru4rec.make_chunk_fn = recorded, stub
    try:
        model = GRU4Rec(cfg, device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):  # fit's epoch lines
            model.fit(train)
    finally:
        gru4rec.build_schedule, gru4rec.make_chunk_fn = build, make
    return model, built


def _flagship_schedule(cfg):
    """What ``fit`` builds from the train split (the item map, the first
    epoch's schedule, the sampler table), and the test split."""
    train, test = synth_split()
    model, built = _fit_built(cfg, train)
    return model.itemidmap, built["schedules"][0], built["samp1"].numpy(), test


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
        gc.collect()  # so the next configuration's peak holds none of this one
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
          "graph_pool_bytes": {k: r["graph"]["pool_bytes"] for k, r in records.items()},
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
    synthetic raw clicks: its four TSVs. The three run at once."""
    from concurrent.futures import ThreadPoolExecutor

    import pandas as pd

    t_phase = time.time()
    out = {"phase": "examples"}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(3) as pool:
        train, test = synth_split(seed=2, n_items=EXAMPLES_ITEMS, n_events=EXAMPLES_EVENTS)
        train_p, test_p, report_p = (os.path.join(tmp, f)
                                     for f in ("train.tsv", "test.tsv", "r.json"))
        train.to_csv(train_p, sep="\t", index=False)
        test.to_csv(test_p, sep="\t", index=False)
        raw, pre_dir = os.path.join(tmp, "yoochoose-clicks.dat"), os.path.join(tmp, "rsc15")
        os.mkdir(pre_dir)
        yoochoose_clicks(raw)
        jobs = [pool.submit(_example, "quickstart_synthetic", []),
                pool.submit(_example, "reproduce_published",
                            ["retailrocket", train_p, test_p, "--out", report_p]),
                pool.submit(_example, "rsc15.preprocess", [raw, pre_dir])]
        (quick, out["quickstart_s"]), (parity, out["reproduce_s"]), \
            (pre, out["preprocess_s"]) = (job.result() for job in jobs)
        report = json.load(open(report_p)) if os.path.exists(report_p) else None
        tsvs = {f: len(pd.read_csv(os.path.join(pre_dir, f), sep="\t"))
                for f in sorted(os.listdir(pre_dir))}
        heads = {open(os.path.join(pre_dir, f)).readline().strip() for f in tsvs}
    lines = quick.stdout.splitlines()
    metrics = [ln for ln in lines if ln.startswith("Recall@")]
    top3 = "top-3 next items for two live sessions:" in quick.stdout
    out.update(quickstart_rc=quick.returncode, quickstart_metrics=metrics,
               quickstart_top3=lines[-4:] if top3 else None)
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


# ---------------------------------------------------------------------- #
# hbm_budget: scripts/measure_hbm_budget_torch.py
HBM_TRY = ("1000000", "adam", "bfloat16_sr")  # about 5.4 GB of state: fits, reaches K3
HBM_TIMEOUT = 600  # seconds for the script's two runs together


def phase_hbm_budget(smi_line):
    """``scripts/measure_hbm_budget_torch.py`` as two processes at once:
    ``table`` (bytes per item and fixed of the parameters, the optimizer
    state and the run's buffers per (adapt, opt_state_dtype) at GRU-512, and
    the fixed buffers of a captured step read from one probe on the card: the
    graph pool and the capture stream's cuBLAS workspace) and one ``try`` at
    ``HBM_TRY``: ``ok``, K3 once per step of its 64-step chunk (3 eager, the
    rest replays), its ``max_memory_reserved`` and pool. The ladder
    (``boundary``) takes minutes and is not run here."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "measure_hbm_budget_torch.py")
    t0 = time.time()
    procs = {name: subprocess.Popen([sys.executable, script, *args], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, args in (("table", ("table",)), ("try", ("try",) + HBM_TRY))}
    outs = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=max(1.0, t0 + HBM_TIMEOUT - time.time()))
            if p.returncode != 0:
                raise AssertionError(f"hbm_budget {name}: exit {p.returncode}\n"
                                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
            outs[name] = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for row in outs["table"]:
        emit({"phase": "hbm_budget", **row})
    (probe,) = outs["try"]
    emit({"phase": "hbm_budget_try", **probe, "seconds": time.time() - t0})
    if len(outs["table"]) != 6 or not all(
            isinstance(r["graph_pool_bytes"], int) and r["graph_pool_bytes"] > 0
            and isinstance(r["capture_workspace_bytes"], int)
            and r.get("predicted_max_items", 0) > 0 for r in outs["table"]):
        raise AssertionError(f"hbm_budget table: {outs['table']}")
    if probe["result"] != "ok" or probe["launches"] != {"K3": probe["warmup_steps"]
                                                       + probe["replays"]} \
            or probe["replays"] < 1:
        raise AssertionError(f"hbm_budget try: {probe}")


# ---------------------------------------------------------------------- #
# fuzz: the JAX package's config-surface fuzz (tests/test_config_fuzz.py)
# through the port on the card
FUZZ_DRAWS = 24          # draws 0-23 at their drawn widths
FUZZ_WIDE_DRAWS = 8      # draws 0-7 again at width 128 (K1 across the surface)
FUZZ_WIDE = 128
ADAM_READINGS = 20       # adam entries past 1e-5 read back per run, at most
FUZZ_FINAL_ACT = {
    "cross-entropy": "softmax",
    "xe_logit": "softmax_logit",
    "bpr": "elu-0.5",
    "bpr-max": "elu-1",
    "top1": "tanh",
    "top1-max": "leaky-0.1",
}


def fuzz_draw_config(rng):
    """A copy of ``draw_config`` of ``tests/test_config_fuzz.py`` (this
    script imports nothing of the JAX package; a CPU test holds the two
    equal): one random valid config of the combination surface."""
    loss = rng.choice(list(FUZZ_FINAL_ACT))
    n_sample = int(rng.choice([0, 8, 24]))
    if loss in ("bpr", "bpr-max", "top1", "top1-max") and n_sample == 0:
        n_sample = 8
    mode = rng.choice(["onehot", "embedding", "constrained"])
    kw = dict(
        loss=str(loss), final_act=FUZZ_FINAL_ACT[loss],
        hidden_act=str(rng.choice(["tanh", "relu"])),
        layers=[int(rng.choice([8, 12]))] * int(rng.choice([1, 2])),
        batch_size=8, n_sample=n_sample,
        sample_alpha=float(rng.choice([0.0, 0.5, 0.75])),
        sampler=str(rng.choice(["alias", "searchsorted"])),
        learning_rate=0.06, n_epochs=2, chunk_size=int(rng.choice([8, 16])),
        item_pad_multiple=32,
        adapt=rng.choice([None, "adagrad", "rmsprop", "adadelta", "adam"]),
        momentum=float(rng.choice([0.0, 0.3])),
        lmbd=float(rng.choice([0.0, 1e-4])),
        grad_cap=float(rng.choice([0.0, 5.0])),
        logq=float(rng.choice([0.0, 1.0])),
        dropout_p_hidden=float(rng.choice([0.0, 0.2])),
        dropout_p_embed=float(rng.choice([0.0, 0.1])),
        time_sort=bool(rng.choice([True, False])),
        train_random_order=bool(rng.choice([True, False])),
        opt_state_dtype=str(rng.choice(["float32", "bfloat16", "bfloat16_sr"])),
        dedup_impl=str(rng.choice(["sort", "matmul"])),
        seed=int(rng.randint(1000)),
    )
    if loss in ("cross-entropy", "xe_logit"):
        kw["smoothing"] = float(rng.choice([0.0, 0.2]))
    if mode == "embedding":
        kw["embedding"] = int(rng.choice([7, 9]))
    elif mode == "constrained":
        kw["constrained_embedding"] = True
    if kw["adapt"] == "adadelta":
        kw["learning_rate"] = 1.0
    return kw


def fuzz_sessions(n, seed, n_items=40):
    """A copy of ``sessions`` of ``tests/test_config_fuzz.py``: the chain
    next = (11*i+5) % n_items, sessions of 3-6 events."""
    import pandas as pd

    r = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n):
        i = r.randint(n_items)
        for _ in range(r.randint(3, 7)):
            rows.append((s, f"it{i}", t))
            t += 1
            i = (11 * i + 5) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


def fuzz_runs():
    """(draw, width, config kwargs) of the phase's 32 runs: draws 0-23 as
    drawn, then draws 0-7 with every layer, and the embedding where the
    draw has one, ``FUZZ_WIDE`` wide (the rest of the draw kept)."""
    runs = []
    for draw in range(FUZZ_DRAWS):
        runs.append((draw, "drawn", fuzz_draw_config(np.random.RandomState(1000 + draw))))
    for draw in range(FUZZ_WIDE_DRAWS):
        kw = dict(runs[draw][2])
        kw["layers"] = [FUZZ_WIDE] * len(kw["layers"])
        if "embedding" in kw:
            kw["embedding"] = FUZZ_WIDE
        runs.append((draw, FUZZ_WIDE, kw))
    return runs


def fuzz_tables(model):
    """{name: width} of a fitted model's row-sparse item tables."""
    params = model.params
    tables = {"Wy": params["Wy"].shape[1]}
    if "E" in params:
        tables["E"] = params["E"].shape[1]
    elif not model.config.constrained_embedding:
        tables["Wx0"] = params["Wx"][0].shape[1]
    return tables


def fuzz_launches_per_step(cfg, tables):
    """The kernel launches per training step that the config implies, by
    mode: one per row-sparse item table (``tables``: name -> width), K2
    (K3 under adam) where the table's state is stored with stochastic
    rounding, else K1 at a width that is a multiple of 128 and K4 at any
    other; plain SGD updates its rows with torch ops, no kernel."""
    per = {}
    if cfg.adapt is None:
        return per
    sr = cfg.opt_state_dtype == "bfloat16_sr" and cfg.adapt in ("adagrad", "adam")
    for width in tables.values():
        mode = ("K3" if cfg.adapt == "adam" else "K2") if sr else \
            ("K1" if width % 128 == 0 else "K4")
        per[mode] = per.get(mode, 0) + 1
    return per


def _fuzz_fit(cfg, train, eager):
    """``fit`` on the card through the captured step, or with ``eager``
    through the eager loop: the model, its chunk function and the launches
    by mode."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    model = GRU4Rec(cfg, device=DEVICE)
    sparse_update.reset_launches()
    with _chunk_fns(eager=eager) as made:
        model.fit(train)
    torch.cuda.synchronize()
    (fn,) = made
    return model, fn, dict(sparse_update.launches_by_mode)


def _close(got, want, what, extra=0.0):
    """The largest difference of two leaves, and whether it is within the
    card-against-CPU tolerance: parameters atol 1e-5; float32 optimizer
    state atol 1e-5 + rtol 1e-6 (accumulators grow past 10); bfloat16
    state one bf16 ulp; each plus ``extra`` (a number, or a tensor of the
    leaf's shape)."""
    import torch

    g, w = got.detach().double().cpu(), want.detach().double()
    diff = (g - w).abs()
    if got.dtype == want.dtype == torch.bfloat16:
        tol = 2.0**-7 * torch.maximum(g.abs(), w.abs()) + 1e-8 + extra
    elif what == "params":
        tol = 1e-5 + extra
    else:
        tol = 1e-5 + 1e-6 * w.abs() + extra
    return float(diff.max()) if diff.numel() else 0.0, bool((diff <= tol).all())


def _adam_moments(cfg, state):
    """{parameter leaf: (m, v, t, velocity leaf, exact)} of adam's state,
    in float64 on the CPU: the first and second moments, shaped as the
    parameter, the step count (a number, or a column per row of a
    row-sparse table's merged ``[acc | meang | count]``), the key of the
    parameter's momentum state (None without momentum), and whether the
    moments are the float32 ones the step used (not so for a table stored
    in bfloat16 with stochastic rounding)."""
    import torch

    from gru4rec_tpu_torch.models import gru
    from gru4rec_tpu_torch.ops import sr
    from gru4rec_tpu_torch.train import step as tstep

    mode = gru.input_mode(cfg)
    first = 1 if mode == "onehot" else 0  # a one-hot Wx[0] is row-sparse
    out = {}
    for k, sts in state.opt_state["dense"].items():
        for i, st in enumerate(sts):
            j = i + first if k == "Wx" else i
            out[f"/{k}/{j}"] = (st["meang"].double().cpu(), st["acc"].double().cpu(),
                                float(st["count"].reshape(-1)[0]),
                                f"/dense/{k}/{i}/velocity" if "velocity" in st else None,
                                True)
    for name in tstep.sparse_table_names(mode):
        st = state.opt_state["sparse"][name]
        d = (state.params["Wx"][0] if name == "Wx0" else state.params[name]).shape[1]
        exact = st["acc2"].dtype == torch.float32
        acc2 = st["acc2"].double().cpu()
        cnt = acc2[:, 2 * d:2 * d + 1] if exact else sr.limbs_decode(
            *(acc2[:, 2 * d + i:2 * d + i + 1] for i in range(3)))
        out["/Wx/0" if name == "Wx0" else f"/{name}"] = (
            acc2[:, d:2 * d], acc2[:, :d], cnt,
            f"/sparse/{name}/velocity" if "velocity" in st else None, exact)
    return out


def _adam_direction(opt, m, v, t):
    """Adam's step direction m^ / (sqrt(v^) + eps) from its moments, in
    float64 (``opt``: the port's ``Optimizer``; ``optimizers._adapt_dense``'s
    formula; 0 where the count is 0, a row never updated)."""
    import torch

    from gru4rec_tpu_torch.ops.kernels.sparse_update import EPSILON, log_decay

    t = torch.as_tensor(t, dtype=torch.float64)
    c1, c2 = -torch.expm1(t * log_decay(opt.v1)), -torch.expm1(t * log_decay(opt.v2))
    return torch.where(t > 0, (m / c1) / (torch.sqrt(v / c2) + EPSILON), 0.0)


def _fuzz_card_vs_cpu(kw, train):
    """The chunk function step by step on the card (its captured step) and
    on the CPU (the eager loop), each step from the CPU's state: the
    draw's config with float32 products and no dropout (the devices draw
    different masks), the first epoch's schedule as fit builds it, the
    negatives fit would draw injected; per-step loss within rtol 1e-4,
    every leaf within :func:`_close`'s tolerance; a trajectory that
    diverges ends the comparison where both devices' losses stop being
    finite. Returns (steps compared, largest loss rel. error, largest leaf
    difference, (adam entries past 1e-5, the first ADAM_READINGS read
    back))."""
    from gru4rec_tpu_torch import GRU4RecConfig
    from gru4rec_tpu_torch.models.gru4rec import resolve_device
    from gru4rec_tpu_torch.ops.sampling import draw_negatives
    from gru4rec_tpu_torch.train import step as tstep
    from gru4rec_tpu_torch.train.optimizers import make_optimizer

    cfg = GRU4RecConfig(**dict(kw, dropout_p_hidden=0.0, dropout_p_embed=0.0,
                               compute_dtype="float32"))
    model, built = _fit_built(cfg, train)
    n_items, sched = model.n_items, built["schedules"][0]
    # negatives drawn with the draw's sampler, on the CPU, fed to both devices
    neg = draw_negatives(tstep.make_generator(cfg.seed, "cpu"), built["samp1"], sched.n_steps,
                         cfg.n_sample, n_items, cfg.sample_alpha, cfg.sampler)

    def setup(d):  # (state, chunk function, sampler table, logq table)
        return (tstep.init_train_state(cfg, n_items, d), tstep.make_chunk_fn(cfg, n_items),
                built["samp1"].to(d), built["logp0"].to(d))

    cpu, card = setup("cpu"), setup(resolve_device(DEVICE))

    def tree(state):
        return {"params": dict(_leaves(state.params)),
                "opt": dict(_leaves(state.opt_state)),
                "H": dict(_leaves(list(state.H)))}

    def sync():  # the card's tensors take the CPU's values, in place
        want = tree(cpu[0])
        for what, leaves in tree(card[0]).items():
            for k, t in leaves.items():
                t.copy_(want[what][k])

    # adam's step lr * m^ / (sqrt(v^) + eps) has a slope of up to lr / eps
    # in the gradient near 0, and the card sums the gradient in another
    # order (ROADMAP F6): each entry of an adam parameter, and of its
    # momentum, may differ by lr times the difference of the directions
    # that the two devices' float32 moments give (each moment held to the
    # state tolerance) beyond its tolerance.
    # The first ADAM_READINGS entries past 1e-5 are read back: the gradient
    # on both devices (from the first moment: m = v1 m_old + (1 - v1) g),
    # the moments, and the gradient difference in float32 roundings of its
    # row's largest gradient.
    adam, opt = cfg.adapt == "adam", make_optimizer(cfg)
    readings, n_past = [], 0
    sync()
    loss_err = leaf_err = 0.0
    for t in range(sched.n_steps):
        sl = [a[t:t + 1] for a in (sched.in_idx, sched.out_idx, sched.valid, sched.reset)]
        before = _adam_moments(cfg, cpu[0]) if adam else {}
        l_cpu, _ = cpu[1](cpu[0], *sl, cpu[2], cpu[3], neg=neg[t:t + 1])
        l_dev, _ = card[1](card[0], *sl, card[2], card[3], neg=neg[t:t + 1])
        l_cpu, l_dev = float(l_cpu), float(l_dev)
        if not (math.isfinite(l_cpu) and math.isfinite(l_dev)):
            # a diverging trajectory: both devices at the same step, or a fault
            if math.isfinite(l_cpu) or math.isfinite(l_dev):
                raise AssertionError(f"fuzz {kw}: step {t} loss card {l_dev} CPU {l_cpu}")
            return t, loss_err, leaf_err, (n_past, readings)
        # relative, and 1e-7 absolute for a loss that has cancelled below 1e-3
        rel = abs(l_dev - l_cpu) / max(abs(l_cpu), 1e-3)
        loss_err = max(loss_err, rel)
        if rel > 1e-4:
            raise AssertionError(f"fuzz {kw}: step {t} loss card {l_dev} CPU {l_cpu}")
        got, want = tree(card[0]), tree(cpu[0])
        extra = {}
        if adam:
            m_dev, m_cpu = _adam_moments(cfg, card[0]), _adam_moments(cfg, cpu[0])
            for k in m_cpu:
                if m_cpu[k][4]:
                    extra[k] = cfg.learning_rate * (_adam_direction(opt, *m_dev[k][:3])
                                                    - _adam_direction(opt, *m_cpu[k][:3])).abs()
                    if m_cpu[k][3] is not None:
                        extra[m_cpu[k][3]] = extra[k]
                dp = (got["params"][k].detach().double().cpu()
                      - want["params"][k].double()).abs()
                past = (dp > 1e-5).nonzero().tolist()
                n_past += len(past)
                past = past[:ADAM_READINGS - len(readings)]
                if not past:
                    continue
                g_dev = (m_dev[k][0] - opt.v1 * before[k][0]) / (1.0 - opt.v1)
                g_cpu = (m_cpu[k][0] - opt.v1 * before[k][0]) / (1.0 - opt.v1)
                for ix in map(tuple, past):
                    row = g_cpu[ix[0]] if g_cpu.dim() == 2 else g_cpu
                    dg = float(g_dev[ix] - g_cpu[ix])
                    readings.append({
                        "step": t, "leaf": k, "index": list(ix),
                        "param_diff": float(dp[ix]),
                        "allowed": 1e-5 + float(extra[k][ix]) if k in extra else 1e-5,
                        "g_card": float(g_dev[ix]), "g_cpu": float(g_cpu[ix]), "dg": dg,
                        "m_card": float(m_dev[k][0][ix]), "m_cpu": float(m_cpu[k][0][ix]),
                        "v_card": float(m_dev[k][1][ix]), "v_cpu": float(m_cpu[k][1][ix]),
                        "dg_in_roundings_of_row_max":
                            abs(dg) / (2.0**-24 * float(row.abs().max())),
                        "moments": "float32" if m_cpu[k][4] else "bfloat16 (stochastic)"})
        for what in got:
            for k, v in got[what].items():
                diff, ok = _close(v, want[what][k], what, extra.get(k, 0.0))
                leaf_err = max(leaf_err, diff)
                if not ok:
                    raise AssertionError(f"fuzz {kw}: step {t} {what}{k} card and CPU "
                                         f"differ by {diff}; adam entries past 1e-5: "
                                         f"{readings}")
        sync()
    runner = card[1].runner
    if runner.graph is None or runner.warm + runner.replays != sched.n_steps:
        raise AssertionError(f"fuzz {kw}: the card's chunk did not replay its step "
                             f"({vars(runner)})")
    return sched.n_steps, loss_err, leaf_err, (n_past, readings)


def _fuzz_run(draw, width, kw, tmp):
    """One run of the fuzz phase (module doc): its record."""
    import torch

    from gru4rec_tpu_torch import GRU4Rec, GRU4RecConfig, evaluate
    from gru4rec_tpu_torch.utils.cuda_graph import WARMUP_STEPS

    t0 = time.time()
    train, test = fuzz_sessions(120, seed=draw), fuzz_sessions(25, seed=100 + draw)
    cfg = GRU4RecConfig(**kw)
    name = f"fuzz draw {draw} width {width}"

    graphed, fn, launches = _fuzz_fit(cfg, train, eager=False)
    eager, fn_e, launches_e = _fuzz_fit(GRU4RecConfig(**kw), train, eager=True)
    steps = sum(e["steps"] for e in graphed.epoch_stats)
    runner = fn.runner
    captured = runner is not None and runner.graph is not None and fn_e.runner is None
    if not captured or runner.warm != WARMUP_STEPS or runner.replays != steps - WARMUP_STEPS:
        raise AssertionError(f"{name}: fit did not replay its captured step on every step "
                             f"after the warm-up ({steps} steps, runner "
                             f"{runner and vars(runner)})")
    want = dict(_leaves({"params": graphed._train_state.params,
                         "opt_state": graphed._train_state.opt_state,
                         "H": list(graphed._train_state.H)}))
    got = dict(_leaves({"params": eager._train_state.params,
                        "opt_state": eager._train_state.opt_state,
                        "H": list(eager._train_state.H)}))
    differ = [k for k in want if not _same_bits(got[k], want[k])]
    losses = [e["loss"] for e in graphed.epoch_stats]
    bit_equal = not differ and losses == [e["loss"] for e in eager.epoch_stats]
    if not bit_equal or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: the captured fit and the eager loop differ: "
                             f"leaves {differ}, losses {losses} and "
                             f"{[e['loss'] for e in eager.epoch_stats]}")
    tables = fuzz_tables(graphed)
    per_step = fuzz_launches_per_step(cfg, tables)
    want_launches = {m: per_step.get(m, 0) * steps for m in launches}
    if launches != want_launches or launches_e != want_launches:
        raise AssertionError(f"{name}: launches {launches} (eager {launches_e}) over "
                             f"{steps} steps, expected {per_step} per step")

    # evaluation: the captured step against the eager loop
    graphs = {}
    rec, mrr = evaluate(graphed, test, cut_off=[1, 5], batch_size=8, _graphs=graphs)
    rec_e, mrr_e = evaluate(graphed, test, cut_off=[1, 5], batch_size=8, _eager=True)
    eval_replays = sum(g.replays for g in graphs.values())
    if (rec, mrr) != (rec_e, mrr_e) or eval_replays < 1 or \
            not all(0.0 <= v <= 1.0 for v in rec + mrr):
        raise AssertionError(f"{name}: evaluate captured {rec} {mrr} ({eval_replays} "
                             f"replays), eager {rec_e} {mrr_e}")
    graphs.clear()

    # savemodel -> loadmodel -> predict_topk
    first = test.groupby("SessionId").head(1).head(cfg.batch_size)
    sessions, items = first["SessionId"].values, first["ItemId"].values
    ids, scores = graphed.predict_topk(sessions, items, k=5, batch=cfg.batch_size)
    path = os.path.join(tmp, f"fuzz{draw}_{width}.npz")
    graphed.savemodel(path)
    loaded = GRU4Rec.loadmodel(path, device=DEVICE)
    ids2, scores2 = loaded.predict_topk(sessions, items, k=5, batch=cfg.batch_size)
    topk_equal = bool((ids == ids2).all() and np.array_equal(scores, scores2))
    if not topk_equal:
        raise AssertionError(f"{name}: predict_topk after save and load differs:\n"
                             f"{ids}\n{ids2}\n{scores}\n{scores2}")

    cpu_steps, loss_err, leaf_err, (n_past, readings) = _fuzz_card_vs_cpu(kw, train)
    mode = (f"emb{kw['embedding']}" if "embedding" in kw
            else "constrained" if kw.get("constrained_embedding") else "onehot")
    summary = (f"{kw['loss']}/{kw['final_act']} {kw['hidden_act']} {kw['layers']} {mode} "
               f"{kw['adapt']} m{kw['momentum']} {kw['opt_state_dtype']} "
               f"n{kw['n_sample']} {kw['sampler']} a{kw['sample_alpha']} "
               f"cap{kw['grad_cap']} logq{kw['logq']}")
    del graphed, eager, loaded
    torch.cuda.empty_cache()
    return {"phase": "fuzz", "draw": draw, "width": width, "config": summary,
            "tables": tables, "launches_per_step": per_step, "steps": steps,
            "captured": captured, "replays": runner.replays, "bit_equal": bit_equal,
            "loss": losses, "recall": rec, "eval_replays": eval_replays,
            "topk_equal": topk_equal, "cpu_steps": cpu_steps,
            "card_vs_cpu_loss_max_rel_err": loss_err, "card_vs_cpu_max_abs_err": leaf_err,
            "adam_entries_past_1e-5": n_past, "adam_readings": readings,
            "seconds": time.time() - t0}


def phase_fuzz(smi_line):
    """The JAX package's config-surface fuzz on the card (module doc): one
    line per run, then a ``fuzz_summary`` line; returns the summary."""
    t0 = time.time()
    launches, records = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for draw, width, kw in fuzz_runs():
            rec = _fuzz_run(draw, width, kw, tmp)
            emit(rec)
            records.append(rec)
            for m, n in rec["launches_per_step"].items():
                launches[m] = launches.get(m, 0) + n * rec["steps"]
    out = {"phase": "fuzz_summary", "runs": len(records),
           "draws": len({r["draw"] for r in records}),
           "wide_runs": sum(r["width"] == FUZZ_WIDE for r in records),
           "steps": sum(r["steps"] for r in records),
           "cpu_steps": sum(r["cpu_steps"] for r in records),
           "launches": launches,
           "card_vs_cpu_loss_max_rel_err": max(r["card_vs_cpu_loss_max_rel_err"]
                                               for r in records),
           "card_vs_cpu_max_abs_err": max(r["card_vs_cpu_max_abs_err"] for r in records),
           "adam_entries_past_1e-5": sum(r["adam_entries_past_1e-5"] for r in records),
           "seconds": time.time() - t0, "card": smi_line}
    emit(out)
    if out["runs"] != FUZZ_DRAWS + FUZZ_WIDE_DRAWS:
        raise AssertionError(f"fuzz: {out['runs']} runs")
    return out


# ---------------------------------------------------------------------- #
# paropt_sweep: scripts/run_paropt_sweep_torch.py
PAROPT_SWEEP_TRIALS = 3
PAROPT_SWEEP_TIMEOUT = 900


def phase_paropt_sweep(smi_line):
    """``scripts/run_paropt_sweep_torch.py 3``: three paropt trials at the
    sweep's GRU-224 / batch-80 / 2048-negative shape from a copy of the
    package with an empty build directory (trial 1 builds the kernel and
    the schedule builder), then paropt's final run of the best parameters:
    exit 0, a metric per trial, ``cache_shared`` true, and the final run's
    Recall@20 equal to the best trial's (a repeat of the same trial,
    printed to 6 decimals; one recall step of the 40,000-event test set is
    about 3e-5)."""
    t0 = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [sys.executable, os.path.join(root, "scripts", "run_paropt_sweep_torch.py"),
             str(PAROPT_SWEEP_TRIALS), tmp], capture_output=True, text=True,
            timeout=PAROPT_SWEEP_TIMEOUT, cwd=root)
        log = open(os.path.join(tmp, "sweep.log")).read() \
            if os.path.exists(os.path.join(tmp, "sweep.log")) else ""
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    trials, summ = lines[:-1], (lines[-1] if lines else {})
    final = [ln for ln in log.split("Running final eval @[20]:")[-1].splitlines()
             if ln.startswith("Recall@20:")]
    metrics = [t.get("metric") for t in trials]
    best = max((m for m in metrics if m is not None), default=None)
    final_recall = final[0].split()[1] if final else None
    out = {"phase": "paropt_sweep", "rc": res.returncode, "trials": trials,
           "summary": summ, "final_recall@20": final_recall,
           "repeat_equal": best is not None and final_recall == f"{best:.6f}",
           "seconds": time.time() - t0, "card": smi_line}
    emit(out)
    if res.returncode != 0 or summ.get("rc") != 0 or \
            summ.get("n_trials") != PAROPT_SWEEP_TRIALS or None in metrics or \
            summ.get("cache_shared") is not True or not out["repeat_equal"]:
        raise AssertionError(f"paropt_sweep: {out}\n{res.stderr[-3000:]}\n{log[-3000:]}")


# ---------------------------------------------------------------------- #
# bench, bench_scaling: the port's harnesses, each as a fresh subprocess
BENCH_TIMEOUT = 900    # seconds for the bench, its three epoch-1 children included
SCALING_TIMEOUT = 600


def _dumped_keys(name):
    """The keys, in order, of the dict that ``main`` of the JAX package's
    harness ``name`` (``bench.py``, ``bench_scaling.py``) passes to
    ``json.dumps``, read from its source (nothing of it is imported)."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    (main,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main"]
    (d,) = [n.args[0] for n in ast.walk(main)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "dumps" and n.args and isinstance(n.args[0], ast.Dict)]
    return [k.value for k in d.keys]


def _harness(module, timeout):
    """``python -m <module>`` from the checkout's root: (stdout lines, the
    ``{"fit": ...}`` records of its stderr, stderr, seconds); a non-zero
    exit fails the phase."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", module], capture_output=True, text=True,
                         timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise AssertionError(f"{module} exited {res.returncode}:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    fits = [json.loads(ln)["fit"] for ln in res.stderr.splitlines() if ln.startswith('{"fit"')]
    return res.stdout.strip().splitlines(), fits, res.stderr, time.time() - t0


def _fit_summary(phase, fit):
    """A harness's ``fit``: finite losses and K1 once per step of every
    epoch, no other mode."""
    from gru4rec_tpu_torch.ops.kernels import sparse_update

    steps = sum(e["steps"] for e in fit["epochs"])
    want = {m: steps if m == "K1" else 0 for m in sparse_update.MODES}
    if fit["launches"] != want or not all(math.isfinite(e["loss"]) for e in fit["epochs"]):
        raise AssertionError(f"{phase}: launches {fit['launches']} over {steps} steps, "
                             f"expected {want}; epochs {fit['epochs']}")
    return {"steps": steps, "epoch_events": [e["events"] for e in fit["epochs"]],
            "epoch_seconds": [e["seconds"] for e in fit["epochs"]],
            "launches": fit["launches"]}


def phase_bench(smi_line):
    """``python -m gru4rec_tpu_torch.bench`` in full (module doc)."""
    import torch

    lines, fits, stderr, seconds = _harness("gru4rec_tpu_torch.bench", BENCH_TIMEOUT)
    line = json.loads(lines[-1])
    smi = [ln[len("nvidia-smi: "):] for ln in stderr.splitlines()
           if ln.startswith("nvidia-smi: ")]
    keys = _dumped_keys("bench.py")
    epoch1 = [line.get("epoch1_warm_s"), line.get("epoch1_cold_s"),
              *line.get("epoch1_warm_runs_s", [])]
    if list(line) != keys or len(fits) != 1 or len(smi) != 1 or \
            len(line["epoch1_warm_runs_s"]) != 2 or \
            not all(isinstance(v, (int, float)) and v > 0 for v in epoch1) or \
            line["bench_hw"] != torch.cuda.get_device_name(0) or \
            not (math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"bench: line {line}, keys {keys}, nvidia-smi {smi}, "
                             f"{len(fits)} fit records\n{stderr[-3000:]}")
    emit({"phase": "bench", "line": line, "nvidia_smi": smi[0],
          **_fit_summary("bench", fits[0]), "seconds": seconds, "card": smi_line})


def phase_bench_scaling(smi_line):
    """``python -m gru4rec_tpu_torch.bench_scaling`` (module doc)."""
    import torch

    from gru4rec_tpu_torch.bench_scaling import widths

    lines, fits, stderr, seconds = _harness("gru4rec_tpu_torch.bench_scaling",
                                            SCALING_TIMEOUT)
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    keys = _dumped_keys("bench_scaling.py")
    want = [(d, 80 * d) for d in widths(torch.cuda.device_count())]
    if [(r.get("devices"), r.get("batch")) for r in rows] != want or \
            any(list(r) != keys or not r["value"] > 0 for r in rows) or \
            [f["devices"] for f in fits] != [d for d, _ in want]:
        raise AssertionError(f"bench_scaling: rows {rows}, expected {want}, keys {keys}\n"
                             f"{stderr[-3000:]}")
    for r, fit in zip(rows, fits):
        emit({"phase": "bench_scaling", "row": r,
              **_fit_summary(f"bench_scaling width {r['devices']}", fit),
              "seconds": seconds, "card": smi_line})


# the kernels line: kernel_timing key -> (mode, line of the TPU kernel in
# gru4rec_tpu/ops/kernels/sparse_update.py, phase whose launches count)
KERNEL_TABLE = {"K1": ("K1", 419, "train"), "K2": ("K2", 484, "train_sr"),
                "K3": ("K3", 808, "train_adam_sr"), "K4": ("K4", 248, "train_onehot"),
                "K1 onehot Wy": ("K1", 419, "train_onehot"),
                "K1 rees46 Wy": ("K1", 419, "published_rees46")}
# the product's kernels-line entries: mixed_mm shape -> (phase whose
# launches count, its path)
MIXED_MM_TABLE = {"flagship scores": ("train", "train: flagship fit + evaluate"),
                  "rees46 evaluation": ("published_rees46",
                                        "published: rees46 fit + evaluate")}
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
    mm = phase_mixed_mm(smi_line)
    ranking = phase_score_rank(smi_line)
    ranking_ew = phase_score_rank_elementwise(smi_line)
    phase_reference()
    paths = {}
    paths["train"], flagship = phase_train(smi_line)
    control = phase_train_sr_control(smi_line)
    paths["train_sr"], sr_model = phase_train_sr(smi_line, paths["train"], control)
    paths["train_adam_sr"], adam_model = phase_train_adam_sr(smi_line)
    paths["train_onehot"], onehot_model = phase_train_onehot(smi_line)
    sgd, sgd_model = phase_train_sgd(smi_line)
    phase_graph(smi_line, {
        "train": (flagship_cfg(), synth_split()[0], flagship, paths["train"]),
        "train_sr": (flagship_cfg(opt_state_dtype="bfloat16_sr"), synth_split()[0],
                     sr_model, paths["train_sr"]),
        "train_adam_sr": (flagship_cfg(adapt="adam", learning_rate=0.001,
                                       opt_state_dtype="bfloat16_sr"),
                          synth_split()[0], adam_model, paths["train_adam_sr"]),
        "train_onehot": (rsc15_cfg(), synth_split(seed=1, n_items=RSC15_ITEMS,
                                                  mean_len=RSC15_MEAN_SESSION_LEN)[0],
                         onehot_model, paths["train_onehot"]),
        "train_sgd": (flagship_cfg(adapt=None), synth_split()[0], sgd_model, sgd)})
    # train_sr's reading for the mesh phase's bfloat16_sr fit
    sr_rec = {"loss": sr_model.epoch_stats[-1]["loss"],
              "leaves": {k: v.cpu() for k, v in _leaves({
                  "params": sr_model._train_state.params,
                  "opt_state": sr_model._train_state.opt_state})}}
    del sr_model, adam_model, onehot_model, sgd_model
    phase_learn()
    paths["learn_sr"] = phase_learn_sr(smi_line)
    proto = phase_proto(smi_line)
    phase_serve(flagship, smi_line)
    phase_eval_graph(flagship, smi_line)
    phase_checkpoint(flagship, smi_line)
    phase_resume(smi_line)
    phase_cli(smi_line)
    phase_scheduler(smi_line)
    phase_legacy_eval(flagship, smi_line)
    phase_paropt(smi_line)
    phase_mesh_shard_kernel(smi_line)
    phase_mesh_1x1(flagship, paths["train"], sr_rec, smi_line)
    phase_mesh_2x2_shared_card(smi_line)
    paths["published_rees46"] = phase_published(smi_line)["rees46"]
    phase_examples(smi_line)
    phase_hbm_budget(smi_line)
    fuzz = phase_fuzz(smi_line)
    phase_paropt_sweep(smi_line)
    phase_bench(smi_line)
    phase_bench_scaling(smi_line)
    # library_ms: no single PyTorch call computes these functions (PERF.md);
    # e.g. torch.optim.Adagrad with sparse gradients divides by sqrt(acc) + eps
    kernels = [{
        "name": f"sparse_update[{key}]",
        "route": "cuda",
        "source": "gru4rec_tpu_torch/csrc/sparse_update.cu",
        "replaces": f"gru4rec_tpu/ops/kernels/sparse_update.py:{line}",
        "path": timing[key]["path"],
        "launches": paths[phase]["launches"][mode],
        "fuzz_launches": fuzz["launches"].get(mode, 0),
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
    kernels += [{
        "name": f"mixed_mm[{shape}]",
        "route": "cuda",
        "backend": "cuBLAS bf16 tensor-core GEMM (aten::mm.dtype), no kernel source",
        "source": "gru4rec_tpu_torch/ops/mixed_mm.py",
        "replaces": "gru4rec_tpu/models/gru.py:143",
        "path": path,
        "launches": sum(paths[phase]["mm_launches"].values()),
        **{k: mm[shape][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
    } for shape, (phase, path) in MIXED_MM_TABLE.items()]
    # library_ms: no PyTorch call ranks a target among softmax scores
    kernels.append({
        "name": "score_rank[rees46 evaluation]",
        "route": "cuda",
        "source": "gru4rec_tpu_torch/csrc/score_rank.cu",
        "replaces": None,
        "path": "published: rees46 evaluate",
        "launches": paths["published_rees46"]["score_rank_launches"],
        **{k: ranking[k] for k in ("ms", "step_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
    })
    kernels.append({
        "name": "score_rank[diginetica evaluation, elementwise elu-1]",
        "route": "cuda",
        "source": "gru4rec_tpu_torch/csrc/score_rank.cu",
        "replaces": None,
        "path": "train: the flagship's evaluate (elu-0.5)",
        "launches": paths["train"]["score_rank_launches"],
        **{k: ranking_ew[k] for k in ("ms", "step_ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
    })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of mesh_2x2_shared_card
        sys.exit(mesh_rank_main(*sys.argv[2:5]))
    sys.exit(main())
