"""Recall@N / MRR@N evaluation over session-parallel lanes.

PyTorch counterpart of ``gru4rec_tpu/eval/evaluation.py``: ``evaluate``
(and its alias ``evaluate_gpu``), and the legacy evaluators
``evaluate_sessions_batch`` (the stateful ``predict_next_batch`` serving
path) and ``evaluate_sessions`` (baseline predictors), which are host
numpy and pandas around the model's predict call.

``evaluate`` (reference: evaluate_gpu, evaluation.py:15-147) keeps the
same session-parallel lane iteration (the shared schedule), the same rank
graph with four tie-break modes (evaluation.py:62-66), several cutoffs
accumulated in one pass, a Python loop over steps, and only the final
counters read back.

Semantics kept from the JAX package:
* test items are inner-joined to the training vocabulary (unseen items are
  dropped, evaluation.py:77);
* events are sorted by (session, time, item) (evaluation.py:78);
* metrics average per *event*;
* ranks use ``<= cutoff``.

Ranks are always taken on ACTIVATED scores, the reference's semantics. (The
JAX evaluator ranks full-catalog scores on pre-activation logits for
"rank-invariant" activations, where float32 saturation of elu/tanh/sigmoid
can change ties; this port does not copy that.)
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from gru4rec_tpu_torch.data.scheduler import build_schedule
from gru4rec_tpu_torch.data.tools import compute_offset
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.ops.ranking import TIE_MODES, compute_ranks


def make_eval_step(cfg, n_items: int, cutoffs, tie_mode: str,
                   items_subset: bool = False):
    """Build the per-step evaluation function ``step(params, H, in_idx,
    out_idx, valid, reset, rec, mrr, gen, item_idx=None) -> H``; ``rec``
    and ``mrr`` (len(cutoffs),) accumulate in place."""
    if tie_mode not in TIE_MODES:
        raise NotImplementedError(f"Unknown tie mode: {tie_mode!r}")
    mode = gru.input_mode(cfg)
    cutoffs = tuple(int(c) for c in cutoffs)

    def step(params, H, in_idx, out_idx, valid, reset, rec, mrr, gen,
             item_idx=None):
        Wy = params["Wy"]
        H = [torch.where(reset[:, None], 0.0, h) for h in H]
        Xg = torch.where(valid, in_idx, 0)
        if mode == "constrained":
            srows = {"WyS": Wy[Xg]}
        elif mode == "embedding":
            srows = {"E": params["E"][Xg]}
        else:
            srows = {"Wx0": params["Wx"][0][Xg]}
        b = in_idx.shape[0]
        lanes = torch.arange(b, device=Wy.device)
        if items_subset:
            # score only the target + the item list (evaluation.py:104-105)
            srows["Wy"] = torch.cat([Wy[torch.where(valid, out_idx, 0)], Wy[item_idx]])
            H_new, yhat = gru.forward(params, srows, H, cfg, M=b, training=False,
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
        else:
            self_adj = 0.0  # full catalog: the self-comparison is in `others`
            item_valid = torch.arange(Wy.shape[0], device=Wy.device) < n_items
            H_new, yhat = gru.forward(params, srows, H, cfg, M=b, training=False,
                                      full_catalog=True, item_valid=item_valid)
            yhat = torch.where(item_valid, yhat, -torch.inf)
            if tie_mode == "tiebreaking":
                yhat = yhat + torch.rand(yhat.shape, generator=gen,
                                         device=yhat.device) * 1e-10
            target = yhat[lanes, torch.where(valid, out_idx, 0)]
            others = yhat
        ranks = compute_ranks(others, target, tie_mode) + self_adj
        vf = valid.float()
        for k, c in enumerate(cutoffs):
            hit = (ranks <= c).float() * vf
            rec[k] += torch.sum(hit)
            mrr[k] += torch.sum(hit / ranks)
        return [torch.where(valid[:, None], hn, ho) for hn, ho in zip(H_new, H)]

    return step


@torch.no_grad()
def evaluate(gru_model, test_data, items=None, session_key="SessionId",
             item_key="ItemId", time_key="Time", cut_off=[20], batch_size=100,
             mode="standard", mesh=None):
    """Measure Recall@N and MRR@N of a trained model (reference: evaluate_gpu,
    evaluation.py:15-147). Returns ``(recall_list, mrr_list)``, one entry per
    cutoff. ``items`` restricts rank competitors to the given item list
    (reference: evaluation.py:104-105). ``tiebreaking`` adds a 1e-10 uniform
    dither from a ``torch.Generator`` seeded with ``seed + 1``: its results
    agree with the JAX package's in distribution, not event by event."""
    if mesh is not None:
        raise NotImplementedError("evaluate(mesh=...) is not ported to "
                                  "gru4rec_tpu_torch yet")
    if gru_model.error_during_train:
        raise Exception("Training ended with an error; model is unusable.")
    cutoffs = list(cut_off) if isinstance(cut_off, (list, tuple)) else [cut_off]
    print("Measuring Recall@{} and MRR@{}".format(
        ",".join(str(c) for c in cutoffs), ",".join(str(c) for c in cutoffs)))
    cfg = gru_model.config
    params = gru_model.params
    dev = params["Wy"].device
    itemidmap = gru_model.itemidmap
    test_data = pd.merge(
        test_data,
        pd.DataFrame({"ItemIdx": itemidmap.values, item_key: itemidmap.index}),
        on=item_key,
        how="inner",
    )
    test_data.sort_values([session_key, time_key, item_key], inplace=True)
    offsets = compute_offset(test_data, session_key)
    order = np.arange(len(offsets) - 1, dtype=np.int64)
    sched = build_schedule(test_data["ItemIdx"].values.astype(np.int32), offsets,
                           order, batch_size)

    items_subset = items is not None
    item_idx = None
    if items_subset:
        item_idx = torch.from_numpy(
            itemidmap[items].values.astype(np.int32)).to(dev)
    step = make_eval_step(cfg, gru_model.n_items, cutoffs, mode, items_subset)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)
    H = gru.init_hidden(cfg, batch_size, dev)
    rec = torch.zeros(len(cutoffs), dtype=torch.float32, device=dev)
    mrr = torch.zeros(len(cutoffs), dtype=torch.float32, device=dev)
    in_d, out_d, valid_d, reset_d = (torch.from_numpy(a).to(dev) for a in (
        sched.in_idx, sched.out_idx, sched.valid, sched.reset))
    for t in range(sched.n_steps):
        H = step(params, H, in_d[t], out_d[t], valid_d[t], reset_d[t], rec, mrr,
                 gen, item_idx)
    n = float(sched.n_events)
    if n == 0:
        raise ValueError(
            "test set produced no evaluable events: every session has fewer "
            "than two events after inner-joining items to the training "
            "vocabulary"
        )
    combo = torch.cat([rec, mrr]).cpu().numpy()
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
