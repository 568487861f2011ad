"""Recall@N / MRR@N evaluation over session-parallel lanes.

PyTorch counterpart of ``gru4rec_tpu/eval/evaluation.py``: ``evaluate``
(and its alias ``evaluate_gpu``), and the legacy evaluators
``evaluate_sessions_batch`` (the stateful ``predict_next_batch`` serving
path) and ``evaluate_sessions`` (baseline predictors), which are host
numpy and pandas around the model's predict call.

``evaluate`` (reference: evaluate_gpu, evaluation.py:15-147) keeps the
same session-parallel lane iteration (the shared schedule), the same rank
graph with four tie-break modes (evaluation.py:62-66), several cutoffs
accumulated in one pass, a loop over steps, and only the final counters
read back. The JAX package compiles its steps into one program per chunk;
on a CUDA device the port captures one step as a CUDA graph and replays it
per step (:class:`_EvalGraph`); the same object uncaptured is its plain
version.
The schedule is memoized across calls on one frame (``_sched_cache``), as
in JAX.

Semantics kept from the JAX package:
* test items are inner-joined to the training vocabulary (unseen items are
  dropped, evaluation.py:77);
* events are sorted by (session, time, item) (evaluation.py:78);
* metrics average per *event*;
* ranks use ``<= cutoff``.

Ranks are always taken on ACTIVATED scores, the reference's semantics. (The
JAX evaluator ranks full-catalog scores on pre-activation logits for
"rank-invariant" activations, where float32 saturation of elu/tanh/sigmoid
can change ties, and its mesh evaluator always does; this port copies
neither.)

On a mesh (``evaluate(mesh=)``, ``parallel/mesh.py``) the lanes split over
the ``data`` axis and the item table's rows over ``model``, the training
layout: each rank scores its lanes against the rows it owns, an elementwise
final activation applies per shard, a softmax takes each row's max and sum
over ``model``, and the rank is the sum over ``model`` of each shard's
comparison counts; the counters are summed over ``data`` at the end.
:func:`make_dist_topk_fn` serves the same way, merging per-shard top-k
candidates. On an NCCL mesh both are captured as on one device, the
collectives inside the graph; a gloo mesh runs them eagerly.
"""

from __future__ import annotations

import contextlib
import copy
import json

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist

from gru4rec_tpu_torch.data.scheduler import build_schedule
from gru4rec_tpu_torch.data.tools import compute_offset
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.ops.activations import NEG_INF, get_activation
from gru4rec_tpu_torch.ops.kernels import score_rank
from gru4rec_tpu_torch.ops.ranking import TIE_MODES, compute_ranks, ranks_from_counts
from gru4rec_tpu_torch.parallel.dist_step import (check_mesh, detect_scratch_layout,
                                                  make_row_gather, shard_params)
from gru4rec_tpu_torch.train.step import StackLayout
from gru4rec_tpu_torch.utils.cuda_graph import WARMUP_STEPS, ReplayLoop, binding
from gru4rec_tpu_torch.utils.profiling import span

# tiebreaking on a mesh: each model shard dithers from its own generator,
# seeded ``seed + 1 + mi * SHARD_SEED_STRIDE`` (shard 0: the single-device seed)
SHARD_SEED_STRIDE = 0x9E3779B1


def _on_card(t) -> bool:
    """Whether the step ranks through the ranking kernel: a CUDA tensor.
    On the CPU the step keeps its eager ops, and with them ``compute_ranks``
    as the one place every evaluation ranks there."""
    return t.device.type == "cuda"


def _fused_route(cfg, tie_mode: str, items_subset: bool) -> bool:
    """Whether the step scores and ranks through the ranking kernel where it
    runs on the card (:func:`_on_card`): full-catalog ranking under a final
    activation the kernel takes (``softmax`` or ``softmax_logit``, which
    ranks as ``softmax``, or an elementwise one:
    ``ops/kernels/score_rank.py::takes``) in the ``standard``,
    ``conservative`` or ``median`` tie mode."""
    return (not items_subset and score_rank.takes(cfg.final_act)
            and tie_mode in score_rank.MODES)


def _table_cols(cfg, tie_mode: str, items_subset: bool):
    """The columns ``Wy[:, :h_last]`` that the fused route's scores product
    rounds to bfloat16 on every step, as their count ``h_last``, or None
    where the route is not fused or its products keep float32 operands. An
    evaluation runner then holds their bfloat16 copy, rounded once per call
    (:meth:`_EvalGraph.count`), in place of the product's cast."""
    if _fused_route(cfg, tie_mode, items_subset) and \
            gru.torch_dtype(cfg.compute_dtype) != torch.float32:
        return cfg.layers[-1]
    return None


# the refreshes of an evaluation runner's bfloat16 table, one per call that
# holds one (:meth:`_EvalGraph.count`)
table_casts = {"per_call": 0}


def reset_table_casts() -> None:
    table_casts["per_call"] = 0


EVAL_ROUTES = ("fused", "fused_elementwise", "full_eager", "subset")
# single-device ``evaluate`` calls by the route their steps take
# (:func:`_eval_route`), one per call
eval_routes = dict.fromkeys(EVAL_ROUTES, 0)


def reset_eval_routes() -> None:
    for r in EVAL_ROUTES:
        eval_routes[r] = 0


def _eval_route(cfg, tie_mode: str, items_subset: bool, Wy) -> str:
    """The branch of :func:`make_eval_step` a step over ``Wy`` takes:
    ``subset`` (``items=``), ``fused`` (the card's ranking kernel under a
    softmax), ``fused_elementwise`` (the same kernel's elementwise mode) or
    ``full_eager`` (the full catalog through ``gru.activate`` and
    ``compute_ranks``: on the card ``tiebreaking`` and activations the
    kernel does not take, on the CPU every full-catalog call)."""
    if items_subset:
        return "subset"
    if _fused_route(cfg, tie_mode, False) and _on_card(Wy):
        return "fused" if cfg.final_act in score_rank.SOFTMAX else "fused_elementwise"
    return "full_eager"


def _tally(ranks, valid, cutoffs, rec, mrr, H, H_new, H_in) -> None:
    """A step's counts, in place: the valid lanes' hits at each cutoff into
    ``rec``, their reciprocal ranks into ``mrr``, and their new hidden state
    into ``H`` (the others keep ``H_in``)."""
    vf = valid.float()
    for k, c in enumerate(cutoffs):
        hit = (ranks <= c).float() * vf
        rec[k] += torch.sum(hit)
        mrr[k] += torch.sum(hit / ranks)
    for h, hn, ho in zip(H, H_new, H_in):
        h.copy_(torch.where(valid[:, None], hn, ho))


def make_eval_step(cfg, n_items: int, cutoffs, tie_mode: str,
                   items_subset: bool = False):
    """Build the per-step evaluation function ``step(params, H, in_idx,
    out_idx, valid, reset, rec, mrr, gen, item_idx=None, table=None)``: the
    lanes ``H`` change in place, and ``rec`` and ``mrr`` (len(cutoffs),)
    accumulate in place, so that a captured step (:class:`_EvalGraph`)
    reads and writes the same tensors on every replay. Nothing in it waits
    on the host.

    On the card (:func:`_on_card`), the fused route (:func:`_fused_route`)
    goes, after the scores GEMM, through the kernel of
    ``ops/kernels/score_rank.py`` (``score_rank_cuda``, in its softmax or
    its elementwise mode), whose counts this module's ``ranks_from_counts``
    turns into ranks. There ``table``, where given, is ``Wy[:, :h_last]``
    rounded to bfloat16 (:func:`_table_cols`), and the GEMM reads it as it
    is; else the product rounds those rows itself. The CPU, the subset,
    ``tiebreaking`` and activations the kernel does not take score through
    ``gru``'s forward and rank with eager ops (the kernel's plain version),
    the full catalog through this module's ``compute_ranks``. The span
    ``gru4rec.evaluate.rank`` holds the full-catalog ranking of the eager
    route (activation, masks, target gather and ranks) and of the kernel's
    elementwise mode (the kernel and ``ranks_from_counts``); the softmax
    mode opens none (the branches: :func:`_eval_route`)."""
    if tie_mode not in TIE_MODES:
        raise NotImplementedError(f"Unknown tie mode: {tie_mode!r}")
    mode = gru.input_mode(cfg)
    cutoffs = tuple(int(c) for c in cutoffs)
    mm = gru.make_mm(cfg)
    h_last = cfg.layers[-1]

    def step(params, H, in_idx, out_idx, valid, reset, rec, mrr, gen,
             item_idx=None, table=None):
        Wy = params["Wy"]
        H_in = [torch.where(reset[:, None], 0.0, h) for h in H]
        srows = gru.input_rows(params, torch.where(valid, in_idx, 0), mode)
        b = in_idx.shape[0]
        lanes = torch.arange(b, device=Wy.device)
        route = _eval_route(cfg, tie_mode, items_subset, Wy)
        if route == "subset":
            # score only the target + the item list (evaluation.py:104-105)
            srows["Wy"] = torch.cat([Wy[torch.where(valid, out_idx, 0)], Wy[item_idx]])
            H_new, yhat = gru.forward(params, srows, H_in, cfg, M=b, training=False,
                                      col_valid=None, full_catalog=False)
            if tie_mode == "tiebreaking":
                yhat = yhat + torch.rand(yhat.shape, generator=gen,
                                         device=yhat.device) * 1e-10
            target = yhat[lanes, lanes]
            others = yhat[:, b:]
            out_v = torch.where(valid, out_idx, -1)
            dup = item_idx[None, :] == out_v[:, None]
            if tie_mode == "tiebreaking":
                # the target's duplicate subset column carries an independent
                # dither draw; full-catalog semantics compare the target with
                # itself exactly, so that duplicate is excluded
                others = torch.where(dup, -torch.inf, others)
            self_adj = 0.0
            if tie_mode in ("conservative", "median"):
                # count the self-comparison exactly once (the JAX package's
                # deliberate divergence from the reference's subset path)
                self_adj = torch.where(dup.any(dim=1), 0.0,
                                       1.0 if tie_mode == "conservative" else 0.5)
            ranks = compute_ranks(others, target, tie_mode) + self_adj
        elif route in ("fused", "fused_elementwise"):
            H_new, y = gru.forward_stack(params, srows, H_in, cfg, M=b, training=False,
                                         full_catalog=True)
            w = Wy[:, :h_last] if table is None else table
            scores = mm(y, w.T)
            # the elementwise mode ranks inside the span that the eager route
            # opens for the same work (eval_elementwise.* read it); the
            # softmax mode opens none
            with span("gru4rec.evaluate.rank") if route == "fused_elementwise" else \
                    contextlib.nullcontext():
                counts = score_rank.score_rank_cuda(scores, Wy[:, h_last], n_items,
                                                    torch.where(valid, out_idx, 0), tie_mode,
                                                    cfg.final_act)
                ranks = ranks_from_counts(*counts, tie_mode)
        else:
            item_valid = torch.arange(Wy.shape[0], device=Wy.device) < n_items
            H_new, y = gru.forward_stack(params, srows, H_in, cfg, M=b, training=False,
                                         full_catalog=True)
            scores = gru.score(params, srows, y, cfg, full_catalog=True)
            with span("gru4rec.evaluate.rank"):
                yhat = gru.activate(scores, cfg, training=False, valid=item_valid,
                                    full_catalog=True)
                # as inside gru.forward: the raw scores are not held while the
                # step ranks (one (batch, rows) float32 matrix less in the pool)
                del scores
                yhat = torch.where(item_valid, yhat, -torch.inf)
                if tie_mode == "tiebreaking":
                    yhat = yhat + torch.rand(yhat.shape, generator=gen,
                                             device=yhat.device) * 1e-10
                target = yhat[lanes, torch.where(valid, out_idx, 0)]
                # full catalog: the self-comparison is among the columns
                ranks = compute_ranks(yhat, target, tie_mode)
        _tally(ranks, valid, cutoffs, rec, mrr, H, H_new, H_in)

    return step


def _dist_activation(cfg, mesh):
    """``act(scores, valid)`` of a (lanes, columns) score block whose
    columns are split over the ``model`` axis: the predict-time final
    activation (``softmax_logit`` serves as ``softmax``), elementwise per
    shard, or a softmax over the ``valid`` columns of every shard with the
    row's max and sum taken over ``model`` (``masked_softmax``'s steps)."""
    name = "softmax" if cfg.final_act == "softmax_logit" else cfg.final_act
    if name != "softmax":
        act = get_activation(name)
        return lambda s, valid: act(s)

    def softmax(s, valid):
        x = torch.where(valid, s, NEG_INF)
        m = mesh.all_reduce(torch.amax(x, dim=-1, keepdim=True), "model", dist.ReduceOp.MAX)
        e = torch.where(valid, torch.exp(x - m), 0.0)
        return e / mesh.all_reduce(torch.sum(e, dim=-1, keepdim=True), "model")

    return softmax


def _linear_head(cfg):
    """``cfg`` with a linear final activation: the mesh paths score shards
    and activate them across shards themselves."""
    cfg = copy.copy(cfg)  # not dataclasses.replace: that re-runs validation
    cfg.final_act = "linear"
    return cfg


def make_dist_eval_step(cfg, n_items: int, cutoffs, tie_mode: str, mesh, batch_size: int,
                        items_subset: bool = False):
    """The per-step evaluation function on ``mesh`` (JAX's
    ``make_dist_eval_chunk_fn``, ranking activated scores): the signature
    of :func:`make_eval_step` (``H`` in place), with ``params`` this rank's shards
    (``parallel/dist_step.py::shard_params``), the schedule arguments the
    global (batch,) step, ``H`` the rank's lane block and ``gen`` its
    shard's dither generator. ``items_subset`` scores, as the single-device
    step does, every lane's target and the item list, each shard the
    columns whose rows it owns."""
    if tie_mode not in TIE_MODES:
        raise NotImplementedError(f"Unknown tie mode: {tie_mode!r}")
    mode = gru.input_mode(cfg)
    cutoffs = tuple(int(c) for c in cutoffs)
    lo, bl = mesh.lanes(batch_size)
    act = _dist_activation(cfg, mesh)
    cfg_lin = _linear_head(cfg)

    def step(params, H, in_idx, out_idx, valid, reset, rec, mrr, gen, item_idx=None):
        Wy = params["Wy"]
        dev = Wy.device
        rows_local = Wy.shape[0]
        r0 = mesh.mi * rows_local
        in_l, out_l = in_idx[lo:lo + bl], out_idx[lo:lo + bl]
        valid_l, reset_l = valid[lo:lo + bl], reset[lo:lo + bl]
        H_in = [torch.where(reset_l[:, None], 0.0, h) for h in H]
        srows = gru.input_rows(params, torch.where(valid_l, in_l, 0), mode,
                            make_row_gather(r0, rows_local, mesh))
        lanes = torch.arange(bl, device=dev)
        if items_subset:
            # columns [every lane's target | the item list], as on one device
            cols = torch.cat([torch.where(valid, out_idx, 0), item_idx])
            owned = (cols >= r0) & (cols < r0 + rows_local)
            srows["Wy"] = torch.where(owned[:, None], Wy[torch.where(owned, cols - r0, 0)], 0.0)
            H_new, s = gru.forward(params, srows, H_in, cfg_lin, M=bl, training=False,
                                   col_valid=None, full_catalog=False)
            yhat = act(s, owned[None, :])
            if tie_mode == "tiebreaking":
                yhat = yhat + torch.rand((batch_size, yhat.shape[1]), generator=gen,
                                         device=dev)[lo:lo + bl] * 1e-10
            t_owned = owned[lo + lanes]
            t_local = torch.where(t_owned, yhat[lanes, lo + lanes], 0.0)
            others = yhat[:, batch_size:]
            count = owned[batch_size:][None, :]
            out_v = torch.where(valid_l, out_l, -1)
            dup = item_idx[None, :] == out_v[:, None]
            if tie_mode == "tiebreaking":
                count = count & ~dup  # see make_eval_step
            self_adj = 0.0
            if tie_mode in ("conservative", "median"):
                self_adj = torch.where(dup.any(dim=1), 0.0,
                                       1.0 if tie_mode == "conservative" else 0.5)
        else:
            col_valid = (r0 + torch.arange(rows_local, device=dev)) < n_items
            H_new, s = gru.forward(params, srows, H_in, cfg_lin, M=bl, training=False,
                                   full_catalog=True, item_valid=col_valid)
            others = torch.where(col_valid, act(s, col_valid), -torch.inf)
            if tie_mode == "tiebreaking":
                others = others + torch.rand((batch_size, rows_local), generator=gen,
                                             device=dev)[lo:lo + bl] * 1e-10
            out_v = torch.where(valid_l, out_l, 0)
            t_owned = (out_v >= r0) & (out_v < r0 + rows_local)
            t_local = torch.where(
                t_owned, others[lanes, torch.clamp(out_v - r0, 0, rows_local - 1)], 0.0)
            count = None  # other shards' and padding columns are -inf
            self_adj = 0.0
        t = mesh.all_reduce(t_local, "model")[:, None]
        cmp = [others > t]
        if tie_mode == "conservative":
            cmp.append(others >= t)
        elif tie_mode == "median":
            cmp.append(others == t)
        if count is not None:
            cmp = [c & count for c in cmp]
        counts = mesh.all_reduce(torch.stack([torch.sum(c, dim=1) for c in cmp]), "model")
        ranks = ranks_from_counts(counts[0], counts[1] if len(cmp) > 1 else None,
                                  tie_mode) + self_adj
        _tally(ranks, valid_l, cutoffs, rec, mrr, H, H_new, H_in)

    return step


def make_dist_topk_fn(cfg, n_items: int, k: int, mesh):
    """The top-k serving step on ``mesh`` (JAX's ``make_dist_topk_fn``):
    ``topk(params, H, in_idx) -> (H_new, ids, scores)`` for this rank's lane
    block, ``params`` its shards. Each shard activates its scores
    (:func:`_dist_activation`) and takes the top k of the rows it owns; the
    candidates are gathered over ``model`` and the top k taken again, so
    only (lanes, k) ids and scores cross between shards."""
    mode = gru.input_mode(cfg)
    nm = mesh.shape["model"]
    act = _dist_activation(cfg, mesh)
    cfg_lin = _linear_head(cfg)

    @torch.no_grad()
    def topk(params, H, in_idx):
        Wy = params["Wy"]
        rows_local = Wy.shape[0]
        r0 = mesh.mi * rows_local
        srows = gru.input_rows(params, in_idx, mode, make_row_gather(r0, rows_local, mesh))
        col_valid = (r0 + torch.arange(rows_local, device=Wy.device)) < n_items
        H_new, s = gru.forward(params, srows, list(H), cfg_lin, M=in_idx.shape[0],
                               training=False, full_catalog=True, item_valid=col_valid)
        yhat = torch.where(col_valid, act(s, col_valid), -torch.inf)
        kk = min(k, rows_local)
        # the shard's real columns alone where they hold k (on a 1 x 1 mesh
        # the single-device call's very input)
        n_real = min(max(n_items - r0, 0), rows_local)
        scores, idx = torch.topk(yhat[:, :n_real] if n_real >= kk else yhat, kk, dim=1)
        ids = idx + r0
        if nm > 1:
            b = scores.shape[0]
            merged = [mesh.all_gather(x, "model").view(nm, b, kk).transpose(0, 1)
                      .reshape(b, nm * kk) for x in (scores, ids)]
            scores, pos = torch.topk(merged[0], k, dim=1)
            ids = torch.gather(merged[1], 1, pos)
        return H_new, ids, scores

    return topk


SORT_ROUTES = ("packed", "lexsort")
# how often each route of :func:`_sort_order` ran: one per schedule built
schedule_sorts_by_route = dict.fromkeys(SORT_ROUTES, 0)


def reset_schedule_sorts() -> None:
    for r in SORT_ROUTES:
        schedule_sorts_by_route[r] = 0


def _sort_column(col: pd.Series) -> np.ndarray:
    """``col`` as numpy orders it the way ``sort_values`` does, missing
    values last: a numeric or datetime numpy column as it is (numpy sorts
    NaN and NaT last), any other (strings, objects, categories, nullable
    types) as its ``pd.factorize(sort=True)`` codes."""
    if isinstance(col.dtype, np.dtype) and col.dtype.kind in "biufmM":
        return col.to_numpy()
    codes, uniques = pd.factorize(col, sort=True)
    return np.where(codes < 0, len(uniques), codes)


def _packed_key(cols):
    """One int64 key that orders the rows as ``cols`` do in turn (the first
    the major), or None where a column is no integer or the product of the
    columns' value ranges does not fit in 63 bits."""
    if not len(cols[0]) or not all(c.dtype.kind in "iu" for c in cols):
        return None
    lows = [int(c.min()) for c in cols]
    spans = [int(c.max()) - lo + 1 for c, lo in zip(cols, lows)]
    if np.prod(spans, dtype=object) >= 2**63:
        return None
    # sum((c - lo) * stride) in int64's wrap-around arithmetic (a uint64
    # column read as int64 too): exact, since the true key lies in [0, 2**63)
    key, base = None, 0
    for c, lo, n in zip(cols, lows, spans):
        c = c.view(np.int64) if c.dtype == np.uint64 else c
        if key is None:
            key = c.astype(np.int64)
        else:
            key *= n
            key += c
        base = base * n + lo
    key -= (base + 2**63) % 2**64 - 2**63
    return key


def _sort_order(cols) -> np.ndarray:
    """The order of the rows sorted by ``cols`` (session, time, item), as
    ``sort_values`` sorts them: one ``argsort`` of :func:`_packed_key`
    where it exists, else ``np.lexsort``. Rows that tie on all three hold
    the same item, so the order among them changes no schedule array."""
    key = _packed_key(cols)
    if key is not None:
        schedule_sorts_by_route["packed"] += 1
        return np.argsort(key)
    schedule_sorts_by_route["lexsort"] += 1
    return np.lexsort(cols[::-1])


def _eval_schedule(gru_model, test_data, batch_size, session_key, item_key, time_key,
                   sched_cache=None):
    """The evaluation schedule of ``test_data``: its events inner-joined to
    the training vocabulary (unseen items dropped) and sorted by (session,
    time, item), the sessions in that order over ``batch_size`` lanes.

    ``sched_cache`` (a caller-owned dict; JAX's ``_sched_cache``) memoizes
    that host work across calls with the same frame: ``fit`` validates on
    one frame every epoch and keeps one dict per call. The key is the
    frame's ``id``, its length, its first and last rows' three columns, the
    batch and the three column names (an ``id`` alone could be recycled,
    and an in-place edit keeps ``id`` and length); the frame is pinned in
    the entry, so its ``id`` cannot be reused while the dict holds it.

    A miss builds it from the frame's numpy columns, in the spans
    ``gru4rec.evaluate.schedule.join`` (``get_indexer`` on the item map),
    ``.sort`` (:func:`_sort_order`), ``.offsets`` (where the sorted session
    column changes) and ``.walk``: the arrays a pandas ``merge``,
    ``sort_values`` and ``groupby`` give. Rows whose session is missing
    are left out, as ``groupby`` leaves them out."""
    key = None
    if sched_cache is not None:
        cols = (session_key, item_key, time_key)
        fp = ()
        if len(test_data):
            first, last = test_data.iloc[0], test_data.iloc[-1]
            fp = tuple(first[k] for k in cols) + tuple(last[k] for k in cols)
        key = (id(test_data), len(test_data), fp, int(batch_size)) + cols
        hit = sched_cache.get(key)
        if hit is not None:
            return hit[1]
    itemidmap = gru_model.itemidmap
    with span("gru4rec.evaluate.schedule.join"):
        pos = itemidmap.index.get_indexer(test_data[item_key].to_numpy())
        keep = (pos >= 0) & test_data[session_key].notna().to_numpy()
        rows = slice(None) if keep.all() else np.flatnonzero(keep)
        item_idx = itemidmap.to_numpy()[pos[rows]].astype(np.int32)
    with span("gru4rec.evaluate.schedule.sort"):
        by = [_sort_column(test_data[k])[rows] for k in (session_key, time_key, item_key)]
        order = _sort_order(by)
    with span("gru4rec.evaluate.schedule.offsets"):
        s = by[0][order]
        # each session's first row, and the end of the last session if any
        offsets = np.flatnonzero(np.r_[True, s[1:] != s[:-1], len(s) > 0])
    with span("gru4rec.evaluate.schedule.walk"):
        sessions_order = np.arange(len(offsets) - 1, dtype=np.int64)
        sched = build_schedule(item_idx[order], offsets, sessions_order, batch_size)
    if key is not None:
        sched_cache[key] = (test_data, sched)
    return sched


class _EvalGraph(ReplayLoop):
    """The evaluation step over a call's schedule, captured as a CUDA graph
    and replayed per step where ``capturable``, else its eager plain
    version: the counterpart of JAX's compiled evaluators
    (``make_eval_chunk_fn`` and, on a mesh, ``make_dist_eval_chunk_fn``: a
    ``lax.scan`` over the steps with the carry donated).

    It owns the lanes ``H`` (``lanes`` of them: the batch, or a mesh rank's
    block of it), the counters ``rec`` and ``mrr``, the dither generator
    ``gen`` and two input slots: the loop's ``slot``, one step's row of the
    packed schedule (``train/step.py::StackLayout``: ``in | out | valid |
    reset``), and ``item_idx``, the subset's item indices. :meth:`count`
    zeroes the state in place, seeds ``gen`` and runs the schedule through
    the loop (``utils/cuda_graph.py::ReplayLoop``: the spans
    ``gru4rec.evaluate.warmup`` and ``.replay``); ``gen`` is registered
    with the graph, so each replay draws the tiebreaking dither the eager
    step would. The graph reads the parameters it was captured on: the
    caller keys it on their binding (:func:`evaluate`). The capture's pool
    holds the step's intermediates, among them the (batch, n_items) score
    matrices; ``pool_bytes`` is its size.

    Where ``table_cols`` is given (:func:`_table_cols`) and ``Wy`` is a
    float32 table on the card, the object owns ``table``, a contiguous
    bfloat16 copy of ``Wy[:, :table_cols]`` made outside the capture's
    pool. :meth:`count` rounds it from the live ``Wy`` before the call's
    first step, on the stream the steps run on (the span
    ``gru4rec.evaluate.cast``, counted in ``table_casts``), and every
    step's scores product reads it: the table is rounded once a call, not
    once a step, and a graph kept across calls scores the weights as they
    are at each call. Its transpose has the layout of the product's own
    cast, so the GEMM and its sums are the same."""

    def __init__(self, step, cfg, batch_size: int, lanes: int, n_cutoffs: int, n_subset,
                 device, capturable: bool, table_cols=None):
        super().__init__(WARMUP_STEPS, warmup_span="gru4rec.evaluate.warmup",
                         replay_span="gru4rec.evaluate.replay")
        self.step = step
        self.table_cols = table_cols
        self.table = None
        self.layout = StackLayout(batch_size, 0)
        self.H = gru.init_hidden(cfg, lanes, device)
        self.rec = torch.zeros(n_cutoffs, dtype=torch.float32, device=device)
        self.mrr = torch.zeros(n_cutoffs, dtype=torch.float32, device=device)
        self.gen = torch.Generator(device=device)
        self.item_idx = (None if n_subset is None else
                         torch.zeros(n_subset, dtype=torch.int32, device=device))
        self.place(torch.zeros(self.layout.width, dtype=torch.int32, device=device),
                   capturable, [self.gen])

    def count(self, params, stack, seed: int, item_idx=None):
        """Every step of ``stack`` ((T, 4 * batch) int32 on the device):
        ``(rec, mrr)``, the object's own counters."""
        for t in (*self.H, self.rec, self.mrr):
            t.zero_()
        self.gen.manual_seed(seed)
        if item_idx is not None:
            self.item_idx.copy_(item_idx)
        self._round_table(params["Wy"])
        self.run(stack, params)
        return self.rec, self.mrr

    def _round_table(self, Wy):
        """``table`` rounded from ``Wy`` (made at the first call), where the
        object holds one (class doc)."""
        cols = self.table_cols
        if cols is None or not _on_card(Wy) or Wy.dtype != torch.float32:
            return
        with span("gru4rec.evaluate.cast"):
            if self.table is None:
                self.table = torch.empty((Wy.shape[0], cols), dtype=torch.bfloat16,
                                         device=Wy.device)
            self.table.copy_(Wy[:, :cols])
        table_casts["per_call"] += 1

    def fn(self, row, params):
        in_idx, out_idx, valid, reset, _, _ = self.layout.split(row)
        kw = {} if self.table is None else {"table": self.table}
        self.step(params, self.H, in_idx, out_idx, valid, reset, self.rec, self.mrr,
                  self.gen, self.item_idx, **kw)


@torch.no_grad()
def evaluate(gru_model, test_data, items=None, session_key="SessionId",
             item_key="ItemId", time_key="Time", cut_off=[20], batch_size=100,
             mode="standard", mesh=None, _sched_cache=None, _shards=None, _graphs=None,
             _eager=False):
    """Measure Recall@N and MRR@N of a trained model (reference: evaluate_gpu,
    evaluation.py:15-147). Returns ``(recall_list, mrr_list)``, one entry per
    cutoff. ``items`` restricts rank competitors to the given item list
    (reference: evaluation.py:104-105). ``tiebreaking`` adds a 1e-10 uniform
    dither from a ``torch.Generator`` seeded with ``seed + 1``: its results
    agree with the JAX package's in distribution, not event by event.

    On a CUDA device the steps replay one captured step (:class:`_EvalGraph`),
    bit-equal to the eager loop of the same object uncaptured, its plain
    version: the CPU runs that loop, and so do an evaluation of at most
    ``WARMUP_STEPS`` steps, a gloo ``mesh`` (its collectives run on host
    threads, which a graph cannot capture) and ``_eager=True``; an NCCL
    mesh captures its step, collectives included. A graph is captured once per evaluator: the
    config, ``n_items``, the cutoffs, the tie mode, the batch, the subset
    and its length, the mesh's shape and this rank, and the (pointer, shape,
    dtype) of every parameter it reads.
    ``_graphs`` (a caller-owned dict) keeps the graphs across calls by that
    key: ``fit`` keeps one per call, since it validates the same live
    parameters every epoch. Without it the call frees its graph and gives
    the graph's pool back to the device (``torch.cuda.empty_cache``) when
    it returns. ``_sched_cache`` memoizes the schedule
    (:func:`_eval_schedule`).

    The call is the span ``gru4rec.evaluate``, with the children
    ``gru4rec.evaluate.schedule`` (hit or miss), ``.upload``, the table's
    ``.cast`` where the runner rounds one (:class:`_EvalGraph`), the
    graph's ``.warmup``, ``gru4rec.graph.capture`` and ``.replay`` (or the
    eager loop, ``.steps``, with ``.cast`` inside), ``.fetch`` and, for a
    standalone graph, ``.release``; on the full-catalog eager route and
    the kernel's elementwise mode, ``gru4rec.evaluate.rank`` in each eager
    step and at the capture. A
    single-device call counts its route in ``eval_routes``.

    ``mesh`` (``parallel.make_mesh``) evaluates on every rank of the mesh
    (module doc), which must all call it; ``batch_size`` is rounded down to
    a multiple of the data axis, as in JAX. The canonical parameters are
    sharded for the call, or ``_shards`` (a rank's live training shards,
    in-fit validation) are taken as they are. Every rank returns the
    metrics. Tiebreaking dithers each model shard from its own generator."""
    with span("gru4rec.evaluate"):
        if mesh is not None:
            check_mesh(mesh)
            nd = mesh.shape["data"]
            if batch_size % nd:
                # metrics average per event, so the lane count does not change them
                adj = max(nd, batch_size - batch_size % nd)
                print(f"evaluate: batch_size {batch_size} -> {adj} "
                      f"(must divide the {nd}-wide data axis)")
                batch_size = adj
        if gru_model.error_during_train:
            raise Exception("Training ended with an error; model is unusable.")
        cutoffs = list(cut_off) if isinstance(cut_off, (list, tuple)) else [cut_off]
        print("Measuring Recall@{} and MRR@{}".format(
            ",".join(str(c) for c in cutoffs), ",".join(str(c) for c in cutoffs)))
        cfg = gru_model.config
        if mesh is None:
            params = gru_model._serving_params()
        elif _shards is None:
            detect_scratch_layout(gru_model.params, gru_model.n_items, cfg, mesh)
            params = shard_params(gru_model.params, cfg, mesh)
        else:
            params = _shards
        dev = params["Wy"].device
        with span("gru4rec.evaluate.schedule"):
            sched = _eval_schedule(gru_model, test_data, batch_size, session_key, item_key,
                                   time_key, _sched_cache)
        n = float(sched.n_events)
        if n == 0:
            raise ValueError(
                "test set produced no evaluable events: every session has fewer "
                "than two events after inner-joining items to the training "
                "vocabulary"
            )
        items_subset = items is not None
        item_idx = None
        layout = StackLayout(batch_size, 0)
        with span("gru4rec.evaluate.upload"):
            if items_subset:
                item_idx = torch.from_numpy(
                    gru_model.itemidmap[items].values.astype(np.int32)).to(dev)
            # the whole schedule in one upload
            stack = layout.pack(sched.in_idx, sched.out_idx, sched.valid, sched.reset, None,
                                None, dev)
        seed = cfg.seed + 1
        table_cols = None
        if mesh is None:
            step = make_eval_step(cfg, gru_model.n_items, cutoffs, mode, items_subset)
            lanes = batch_size
            capturable = dev.type == "cuda"
            table_cols = _table_cols(cfg, mode, items_subset)
            eval_routes[_eval_route(cfg, mode, items_subset, params["Wy"])] += 1
        else:
            step = make_dist_eval_step(cfg, gru_model.n_items, cutoffs, mode, mesh,
                                       batch_size, items_subset)
            seed += mesh.mi * SHARD_SEED_STRIDE
            lanes = mesh.lanes(batch_size)[1]
            capturable = mesh.capturable
        # every rank of a mesh has the same schedule, so all decide alike
        graphed = capturable and not _eager and sched.n_steps > WARMUP_STEPS
        n_subset = None if item_idx is None else len(item_idx)
        args = (step, cfg, batch_size, lanes, len(cutoffs), n_subset, dev, graphed, table_cols)
        if graphed:
            key = (json.dumps(cfg.to_dict(), sort_keys=True, default=str),
                   gru_model.n_items, tuple(int(c) for c in cutoffs), mode, batch_size,
                   items_subset, n_subset,
                   None if mesh is None else (tuple(mesh.shape.values()), mesh.rank),
                   binding(params))
            graphs = {} if _graphs is None else _graphs
            if key not in graphs:
                graphs[key] = _EvalGraph(*args)
            rec, mrr = graphs[key].count(params, stack, seed, item_idx)
        else:
            runner = _EvalGraph(*args)
            with span("gru4rec.evaluate.steps"):
                rec, mrr = runner.count(params, stack, seed, item_idx)
        combo = torch.cat([rec, mrr])
        if mesh is not None:
            mesh.all_reduce(combo, "data")
        with span("gru4rec.evaluate.fetch"):
            combo = combo.cpu().numpy()
        if graphed and _graphs is None:
            # a standalone call gives its graph's pool back to the device
            with span("gru4rec.evaluate.release"):
                del graphs, rec, mrr
                torch.cuda.empty_cache()
        k = len(cutoffs)
        return ([float(r) / n for r in combo[:k]],
                [float(m) / n for m in combo[k:2 * k]])


# API-parity alias with the reference module name (evaluation.evaluate_gpu).
evaluate_gpu = evaluate


def evaluate_sessions_batch(pr, test_data, items=None, cut_off=20, batch_size=100,
                            mode="standard", session_key="SessionId",
                            item_key="ItemId", time_key="Time"):
    """Legacy batch evaluator driving the stateful ``predict_next_batch``
    serving path (reference: evaluation.py:149-245 — which is bit-rotted
    there, using the long-removed DataFrame.ix; modernized here). Slower than
    ``evaluate`` (host round-trip per step) but exercises the exact serving
    code path. Single cutoff only, like the reference."""
    print("Measuring Recall@{} and MRR@{}".format(cut_off, cut_off))
    if items is not None:
        # same semantics as the compiled evaluator, whose subset lookup
        # (``itemidmap[items]``, evaluate() above) KeyErrors on items the
        # model never saw — an out-of-vocab subset item used to be silently
        # scored 0 here via fillna, ranking it instead of erroring
        items_arr = np.asarray(items)
        miss = ~np.isin(items_arr, pr.itemidmap.index.values)
        if miss.any():
            missing = pd.unique(items_arr[miss])
            raise KeyError(
                f"items subset contains IDs not in the training vocabulary: "
                f"{list(missing[:5])}{'...' if len(missing) > 5 else ''}"
            )
    test_data = pd.merge(
        test_data,
        pd.DataFrame({"ItemIdx": pr.itemidmap.values, item_key: pr.itemidmap.index}),
        on=item_key, how="inner",
    )
    test_data.sort_values([session_key, time_key, item_key], inplace=True)
    offset_sessions = compute_offset(test_data, session_key)
    if len(offset_sessions) - 1 < batch_size:
        batch_size = len(offset_sessions) - 1
    if batch_size < 1:
        raise ValueError(
            "test set produced no evaluable sessions after inner-joining "
            "items to the training vocabulary"
        )
    iters = np.arange(batch_size).astype(np.int64)
    maxiter = iters.max()
    start = offset_sessions[iters].copy()
    end = offset_sessions[iters + 1].copy()
    item_vals = test_data[item_key].values
    rng = np.random.RandomState(pr.config.seed + 2)
    n_points, recall, mrr = 0, 0.0, 0.0
    in_ids = np.zeros(batch_size, dtype=object)
    while True:
        valid_mask = iters >= 0
        if valid_mask.sum() == 0:
            break
        start_valid = start[valid_mask]
        minlen = (end[valid_mask] - start_valid).min()
        in_ids[valid_mask] = item_vals[start_valid]
        for i in range(int(minlen) - 1):
            out_ids = item_vals[start_valid + i + 1]
            if items is not None:
                # score the item list plus any targets outside it
                # (reference: evaluation.py:207-208)
                uniq_out = np.unique(out_ids)
                predict_for = np.hstack([items, uniq_out[~np.isin(uniq_out, items)]])
                preds = pr.predict_next_batch(iters, in_ids, predict_for, batch_size)
            else:
                preds = pr.predict_next_batch(iters, in_ids, None, batch_size)
            in_ids[valid_mask] = out_ids
            scores = preds.values.T  # (batch, n_scored)
            if mode == "tiebreaking":
                scores = scores + 1e-10 * rng.rand(*scores.shape)
            tgt_pos = preds.index.get_indexer(out_ids)
            tgt = scores[valid_mask, :][np.arange(int(valid_mask.sum())), tgt_pos]
            if items is not None:
                others = scores[valid_mask, :][:, preds.index.get_indexer(items)]
            else:
                others = scores[valid_mask, :]
            if mode == "conservative":
                ranks = (others >= tgt[:, None]).sum(axis=1).astype(float)
            elif mode == "median":
                ranks = ((others > tgt[:, None]).sum(axis=1)
                         + 0.5 * ((others == tgt[:, None]).sum(axis=1) - 1) + 1)
            else:
                ranks = (others > tgt[:, None]).sum(axis=1) + 1
            if items is not None and mode in ("conservative", "median"):
                # count the self-comparison exactly once when the target is
                # outside the subset columns — same adjustment as the
                # compiled evaluator (see make_eval_chunk_fn); without it
                # 'conservative' yields rank 0 (inf MRR) whenever the target
                # outscores the whole subset
                in_sub = np.isin(out_ids, items)
                ranks = ranks + np.where(
                    in_sub, 0.0, 1.0 if mode == "conservative" else 0.5)
            ok = ranks <= cut_off
            recall += ok.sum()
            mrr += (1.0 / ranks * ok).sum()
            n_points += len(ranks)
        start = start + minlen - 1
        finished = np.arange(len(iters))[valid_mask & (end - start <= 1)]
        for idx in finished:
            maxiter += 1
            if maxiter >= len(offset_sessions) - 1:
                iters[idx] = -1
            else:
                iters[idx] = maxiter
                start[idx] = offset_sessions[maxiter]
                end[idx] = offset_sessions[maxiter + 1]
    if n_points == 0:
        raise ValueError(
            "test set produced no evaluable events: every session has fewer "
            "than two events after inner-joining items to the training "
            "vocabulary"
        )
    return recall / n_points, mrr / n_points


def evaluate_sessions(pr, test_data, train_data, items=None, cut_off=20,
                      session_key="SessionId", item_key="ItemId", time_key="Time",
                      rng=None):
    """Session-vectorized evaluator for baseline predictors (the protocol of
    reference evaluation.py:247-301, re-designed).

    Predictors exposing ``predict_session(session_id, session_items,
    predict_for_item_ids) -> (len(session_items)-1, n) score matrix`` (all
    shipped baselines do) are driven one call per session, with random
    tie-breaking and rank computation vectorized over the session's events —
    orders of magnitude fewer Python-level steps than the reference's
    per-event loop. Predictors implementing only
    ``predict_next(session_id, input_item_id, predict_for_item_ids)`` fall
    back to per-event calls. Ranks are strict-greater counts + 1 under a
    1e-8 uniform dither, scored as ``rank <= cut_off`` — the reference's
    strict ``<`` (evaluation.py:296) is a documented off-by-one that
    SURVEY.md §2.5 flags as not-to-replicate.

    When ``items`` is given, an event's rank competitors are ``items`` plus
    the target itself (reference: evaluation.py:288-291); the vectorized path
    scores each session's out-of-list targets as extra columns — under a
    strict ``>`` the target's self-comparison contributes nothing, so the
    extra columns never change the rank.
    """
    if rng is None:
        rng = np.random.RandomState(0)
    test_data = test_data.sort_values([session_key, time_key])
    vocab = train_data[item_key].unique()
    sids = test_data[session_key].values
    iids = test_data[item_key].values
    bounds = np.concatenate(
        [[0], np.nonzero(sids[1:] != sids[:-1])[0] + 1, [len(sids)]]
    )
    use_session_api = hasattr(pr, "predict_session")
    items_arr = np.asarray(items) if items is not None else None
    n_points, recall, mrr = 0, 0.0, 0.0
    for k in range(len(bounds) - 1):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        if hi - lo < 2:
            continue  # a 1-event session has nothing to predict
        sess = iids[lo:hi]
        targets = sess[1:]
        if use_session_api:
            if items_arr is None:
                cols, cand_mask = vocab, None
            else:
                extra = pd.unique(targets[~np.isin(targets, items_arr)])
                cols = np.hstack([items_arr, extra])
                cand_mask = np.zeros(len(cols), bool)
                cand_mask[: len(items_arr)] = True
            scores = np.asarray(
                pr.predict_session(sids[lo], sess, cols), dtype=np.float64
            )
            scores = np.nan_to_num(scores, nan=0.0)
            scores = scores + 1e-8 * rng.rand(*scores.shape)
            tcol = pd.Index(cols).get_indexer(targets)
            if (tcol < 0).any():
                # a -1 indexer would silently score the LAST column as the
                # target; the reference KeyErrors on unknown targets
                # (evaluation.py:294) — fail loudly the same way
                missing = pd.unique(targets[tcol < 0])
                raise KeyError(
                    f"test items not present in the training vocabulary: "
                    f"{list(missing[:5])}{'...' if len(missing) > 5 else ''}"
                )
            tscore = scores[np.arange(len(targets)), tcol]
            cand = scores if cand_mask is None else scores[:, cand_mask]
            ranks = (cand > tscore[:, None]).sum(axis=1) + 1.0
        else:
            ranks = np.empty(len(targets))
            prev = sess[0]
            for t, tgt in enumerate(targets):
                if items_arr is None:
                    predict_for = vocab
                elif (items_arr == tgt).any():
                    predict_for = items_arr
                else:
                    predict_for = np.hstack(([tgt], items_arr))
                preds = pr.predict_next(sids[lo], prev, predict_for)
                preds[np.isnan(preds)] = 0
                preds = preds + 1e-8 * rng.rand(len(preds))
                ranks[t] = (preds > preds[tgt]).sum() + 1
                prev = tgt
        ok = ranks <= cut_off
        recall += int(ok.sum())
        mrr += float((1.0 / ranks[ok]).sum())
        n_points += len(ranks)
    if n_points == 0:
        raise ValueError(
            "test set produced no evaluable events: every session has fewer "
            "than two events after inner-joining items to the training "
            "vocabulary"
        )
    return recall / n_points, mrr / n_points
