"""The numbers that decide ``correct``: the program's outputs against the
reference's, each as one number that a limit of its own bounds.

Training (the first steps of ``fit``, through the window's own call): each
step's cost; the norm of each leaf's first gradient, as the optimizer got
it; the norm of each leaf's change over the checked steps. Norms are
compared by the worst leaf: the gap between the two norms over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out (none of this model's is). The negatives that the program
draws for a chunk of the window, against the sampling distribution
``pop ** alpha``. Evaluation: recall and MRR at each
cutoff of each call. Serving: each served item's activated score against
the reference's score of that item, and how far that lies below the
reference's score at the same place of its own top-k.
"""

from __future__ import annotations

import statistics

NEGLIGIBLE = 1e-3  # a leaf whose gradient is under this share of the median's


def _norm_gap(prog: dict, ref: dict, keep) -> float:
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"costs": [...], "grad_norms": {leaf: x},
    "change_norms": {leaf: x}}``."""
    if len(prog["costs"]) != len(ref["costs"]):
        raise ValueError("the program and the reference ran different step counts")
    med = statistics.median(ref["grad_norms"].values())
    keep = [k for k, v in ref["grad_norms"].items() if v >= NEGLIGIBLE * med]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["costs"], ref["costs"])),
        "grad_gap": _norm_gap(prog["grad_norms"], ref["grad_norms"], keep),
        "change_gap": _norm_gap(prog["change_norms"], ref["change_norms"], keep),
    }


SAMPLER_BINS = 16


def sampler_gap(drawn, pop, alpha: float, bins: int = SAMPLER_BINS) -> float:
    """How far the drawn negatives' distribution lies from ``pop ** alpha``:
    the items, most probable first, cut into ``bins`` bins of about equal
    probability; the largest gap between a bin's share of the draws and
    its probability, over that probability. A draw outside the catalog
    reads infinity."""
    import numpy as np

    drawn = np.asarray(drawn).ravel()
    n = len(pop)
    if drawn.size == 0 or drawn.min() < 0 or drawn.max() >= n:
        return float("inf")
    p = np.asarray(pop, dtype=np.float64) ** alpha
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    mid = np.cumsum(p[order]) - p[order] / 2
    bin_of = np.empty(n, dtype=np.int64)
    bin_of[order] = np.minimum((mid * bins).astype(np.int64), bins - 1)
    expected = np.bincount(bin_of, weights=p, minlength=bins)
    seen = np.bincount(bin_of[drawn], minlength=bins) / drawn.size
    return float(np.max(np.abs(seen - expected) / expected))


def eval_numbers(calls, ref) -> dict:
    """``calls``: every ``(recall list, mrr list)`` the program returned;
    ``ref``: the reference's."""
    return {
        "recall_gap": max(abs(p - r) for rec, _ in calls for p, r in zip(rec, ref[0])),
        "mrr_gap": max(abs(p - r) for _, mrr in calls for p, r in zip(mrr, ref[1])),
    }


def serve_numbers(served, ref_at, ref_best) -> dict:
    """Arrays (queries, k): the program's scores, the reference's scores of
    the program's items, the reference's own top-k scores."""
    import numpy as np

    return {
        "score_gap": float(np.max(np.abs(served - ref_at))),
        "order_gap": float(max(0.0, np.max(ref_best - ref_at))),
    }
