"""mfu.eval: the model FLOPs of the traced evaluate call
(``counts.eval_flops_per_event`` per ranked event) over the call's wall
time, as a percentage of the card's dense bfloat16 peak."""

from benchmark.yardstick import counts


def read(layer):
    if layer is None or layer.get("kind") != "eval":
        return None
    h = int(layer["config"]["params"]["layers"][0])
    flops = counts.eval_flops_per_event(h, h, int(layer["config"]["n_items"]))
    return 100.0 * flops * layer["events"] / layer["region"].wall_s / counts.BF16_PEAK_FLOP_S
