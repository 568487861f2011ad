"""What the work of a full-catalog evaluation step after its matrix
products must move, and the device time it took, kept with the benchmark.

The scores product writes a (batch, ``pad_items(n_items)``) float32 score
matrix; whatever ranks each lane's target among its columns (an
activation, masks, a gather and comparison counts, or one kernel that does
all of them) has to read that matrix at least once. No implementation that
ranks the written scores moves less.

The time is that of every kernel of a traced ``evaluate`` call that is not
a matrix product (:data:`PRODUCT`), per step: the bias, the final
activation, the masks, the target gather, the rank counts and the tallies,
the GRU's elementwise work and any bfloat16 cast of an operand. It is read
only where the trace holds the span :data:`RANK_SPAN`, which the program
opens around the elementwise ranking: the ranking kernel's elementwise
mode on the card, the eager full-catalog route elsewhere. The kernel's
softmax mode opens no such span and has readers of its own.
"""

from __future__ import annotations

from benchmark.yardstick.counts import HBM_BYTES_PER_S

SCORE_BYTES = 4  # float32
RANK_SPAN = "gru4rec.evaluate.rank"
# the names of the matrix-product kernels cuBLAS runs for the evaluation
# step's bfloat16 products on the H100 (nvjet_tss_* for the scores, and
# the GRU's small products)
PRODUCT = ("gemm", "nvjet", "xmma", "cutlass")


def score_bytes(batch: int, n_pad: int) -> int:
    """Bytes of one read of a step's (batch, n_pad) float32 scores."""
    return batch * n_pad * SCORE_BYTES


def read_bound_s(batch: int, n_pad: int) -> float:
    """The least time of one read of those scores, over the HBM bandwidth."""
    return score_bytes(batch, n_pad) / HBM_BYTES_PER_S


def is_product(name: str) -> bool:
    return any(s in name.lower() for s in PRODUCT)


def elementwise_s_per_step(layer):
    """Seconds a step of the traced evaluation's kernels that are no
    matrix product, or None where the trace holds no elementwise ranking
    span or the call ran no such kernel."""
    if layer is None or layer.get("kind") != "eval":
        return None
    region = layer["region"]
    if not any(e.get("name") == RANK_SPAN for e in region.host):
        return None
    seconds, n = region.kernel_time_s(lambda name: not is_product(name))
    return seconds / layer["steps"] if n else None
