"""Operations and bytes from the configuration's shapes, and the card's peaks.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, at the
full 700 W power limit); a run prints the card's power limit beside every
share of them. Model FLOPs count what the model needs, once: nothing
recomputed, no padding row or column, and the backward pass as twice the
forward.
"""

from __future__ import annotations

BF16_PEAK_FLOP_S = 989e12   # dense bfloat16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12   # HBM3 bandwidth


def pad_items(n_items: int, multiple: int = 128) -> int:
    """Rows of the program's item tables: the smallest multiple of
    ``multiple`` at least 8 rows above ``n_items`` (its archive layout)."""
    return ((n_items + 7 + multiple) // multiple) * multiple


def pad_cols(width: int) -> int:
    """Columns of the program's output table: ``h + 1`` (the bias in column
    ``h``) rounded up to a multiple of 128."""
    return ((width + 127) // 128) * 128


def gru_flops(d_in: int, h: int) -> float:
    """FLOPs of one GRU step of one row: the input projection and the two
    recurrent products, ``2 (d_in + h) 3h``."""
    return 2.0 * (d_in + h) * 3 * h


def train_flops_per_event(d_in: int, h: int, batch: int, n_sample: int) -> float:
    """Model FLOPs of one training event (one live lane of one step): the
    GRU step and its scores against the batch's targets and the shared
    negatives, ``2 h (batch + n_sample)``, forward, and the backward as
    twice the forward."""
    return 3.0 * (gru_flops(d_in, h) + 2.0 * h * (batch + n_sample))


def eval_flops_per_event(d_in: int, h: int, n_items: int) -> float:
    """Model FLOPs of one ranked event: the GRU step and the scores of the
    whole catalog, ``2 h n_items``."""
    return gru_flops(d_in, h) + 2.0 * h * n_items


def product_bound_s(M: int, K: int, N: int, operand_bytes: int = 4) -> float:
    """The least time of an (M, K) x (K, N) product on the card: the
    operands read once (``operand_bytes`` an element) and the float32
    result written once over the HBM bandwidth, or ``2MKN`` at the
    bfloat16 peak, whichever is larger. With float32 operands (the
    default) it is ``chip_smoke.py``'s ``bound_ms``, in seconds."""
    flops = 2.0 * M * K * N
    moved = operand_bytes * (M * K + K * N) + 4.0 * M * N
    return max(moved / HBM_BYTES_PER_S, flops / BF16_PEAK_FLOP_S)


def eval_step_products(batch: int, d_in: int, h: int, n_pad: int):
    """The (M, K, N) of every product of one evaluation step of a one-layer
    model: the input projection, the two recurrent products and the scores
    of the (padded) catalog."""
    return [(batch, d_in, 3 * h), (batch, h, 2 * h), (batch, h, h), (batch, h, n_pad)]
