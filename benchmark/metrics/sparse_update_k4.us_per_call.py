"""sparse_update_k4.us_per_call: device time of the row-sparse update kernel
in its K4 mode (``csrc/sparse_update.cu``'s ``sparse_update_kernel`` tagged
``k4_any_width``: a non-SR update of a table whose width is no multiple of
128, the one-hot model's ``Wx0``) per launch in the traced training steps,
in microseconds; nothing where no kernel of that name ran (a program whose
K4 launches carry K1's name, or a model with no such table)."""

K4 = "k4_any_width"


def read(layer):
    if layer is None or layer.get("kind") != "train":
        return None
    seconds, n = layer["region"].kernel_time_s(lambda name: "sparse_update" in name
                                               and K4 in name)
    return seconds / n * 1e6 if n else None
