"""score_rank.us_per_step: device time of the full-catalog ranking kernel
(``csrc/score_rank.cu``, every kernel whose name holds ``score_rank``) in
the traced ``evaluate`` call, per evaluation step, in microseconds; nothing
where no such kernel ran."""


def read(layer):
    if layer is None or layer.get("kind") != "eval":
        return None
    seconds, n = layer["region"].kernel_time_s(lambda name: "score_rank" in name)
    return seconds / layer["steps"] * 1e6 if n else None
