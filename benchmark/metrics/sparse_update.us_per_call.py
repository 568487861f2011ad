"""sparse_update.us_per_call: device time of the row-sparse update kernel
(K1, ``csrc/sparse_update.cu``'s ``sparse_update_kernel``) per launch in the
traced training steps, in microseconds; nothing where no such kernel ran."""


def read(layer):
    if layer is None or layer.get("kind") != "train":
        return None
    seconds, n = layer["region"].kernel_time_s(lambda name: "sparse_update" in name)
    return seconds / n * 1e6 if n else None
