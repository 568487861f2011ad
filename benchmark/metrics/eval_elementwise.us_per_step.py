"""eval_elementwise.us_per_step: the device time of every kernel of the
traced ``evaluate`` call that is not a matrix product, per evaluation
step, in microseconds (``yardstick/score_bytes.py``: the table's per-step
cast, the bias, the final activation, the masks, the target gather, the
rank counts and the tallies); nothing where the call did not rank through
the eager full-catalog route (no ``gru4rec.evaluate.rank`` span in the
trace, as on the card's fused ranking route)."""

from benchmark.yardstick import score_bytes


def read(layer):
    s = score_bytes.elementwise_s_per_step(layer)
    return None if s is None else s * 1e6
