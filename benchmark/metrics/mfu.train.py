"""mfu.train: the model FLOPs of the traced training steps
(``counts.train_flops_per_event`` per live lane-step) over the traced
region's wall time, as a percentage of the card's dense bfloat16 peak."""

from benchmark.yardstick import counts


def read(layer):
    if layer is None or layer.get("kind") != "train":
        return None
    p = layer["config"]["params"]
    h = int(p["layers"][0])
    flops = counts.train_flops_per_event(h, h, int(p["batch_size"]), int(p["n_sample"]))
    return 100.0 * flops * layer["events"] / layer["region"].wall_s / counts.BF16_PEAK_FLOP_S
