"""eval_elementwise.us_per_step: the device time of every kernel of the
traced ``evaluate`` call that is not a matrix product, per evaluation
step, in microseconds (``yardstick/score_bytes.py``: the bias, the final
activation, the masks, the target gather and the rank counts, whether the
ranking kernel's elementwise mode or the eager route runs them, the
tallies, the GRU's elementwise work and any bfloat16 cast); nothing where
the call did not rank under an elementwise activation (no
``gru4rec.evaluate.rank`` span in the trace, as on the softmax mode)."""

from benchmark.yardstick import score_bytes


def read(layer):
    s = score_bytes.elementwise_s_per_step(layer)
    return None if s is None else s * 1e6
