"""Rank computation with the four tie-break modes of the reference evaluator.

PyTorch counterpart of ``gru4rec_tpu/ops/ranking.py`` (reference:
evaluation.py:62-66). ``others`` are the scores the target competes against
(may include the target's own score — self-comparisons are strict and
contribute nothing under 'standard'); ``target`` is the positive item's
score per row. Returns float ranks (median mode is fractional).
"""

from __future__ import annotations

import torch

TIE_MODES = ("standard", "conservative", "median", "tiebreaking")


def ranks_from_counts(gt, ge_or_eq, mode: str):
    """Rank from per-row comparison counts.

    ``gt`` is the greater-than count; the second argument is the
    greater-or-equal count for 'conservative' and the equal count for
    'median' (unused otherwise, may be None).
    """
    if mode == "conservative":
        return ge_or_eq.float()
    if mode == "median":
        return (gt + 0.5 * (ge_or_eq - 1) + 1).float()
    if mode in ("standard", "tiebreaking"):
        # 'tiebreaking' expects the caller to have dithered the scores
        return (gt + 1).float()
    raise NotImplementedError(f"Unknown tie mode: {mode!r}")


def rank_counts(others, target, mode: str):
    """The per-row counts :func:`ranks_from_counts` takes: ``(gt, second)``,
    ``second`` None unless the mode needs it."""
    t = target[:, None]
    gt = torch.sum(others > t, dim=1)
    second = None
    if mode == "conservative":
        second = torch.sum(others >= t, dim=1)
    elif mode == "median":
        second = torch.sum(others == t, dim=1)
    return gt, second


def compute_ranks(others, target, mode: str):
    """ranks[i] of target[i] among others[i, :] under the given tie mode."""
    return ranks_from_counts(*rank_counts(others, target, mode), mode)
