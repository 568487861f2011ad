"""eval_elementwise_roofline: one read of an evaluation step's
(batch, padded catalog) float32 scores at 3.35 TB/s
(``yardstick/score_bytes.py``; 88,080,384 B, 26.3 us at 512 x 43,008) over
the step's device time of the kernels that are no matrix product
(``eval_elementwise.us_per_step``: the elementwise ranking, whether the
ranking kernel's elementwise mode or the eager route runs it, and the
step's other such kernels), in percent. That work has to read the scores
at least once, so the share cannot pass 100% unless the bytes are counted
too high or the time misses part of the work; it is not capped. Nothing
where ``eval_elementwise.us_per_step`` reads nothing."""

from benchmark.yardstick import counts, score_bytes


def read(layer):
    s = score_bytes.elementwise_s_per_step(layer)
    if s is None:
        return None
    bound = score_bytes.read_bound_s(int(layer["traffic"]["batch_size"]),
                                     counts.pad_items(int(layer["config"]["n_items"])))
    return 100.0 * bound / s
