"""idle_share.train: the share of the traced training steps' wall time in
which no device operation ran (1 - the union of the operations' intervals
over the wall time), in percent."""


def read(layer):
    if layer is None or layer.get("kind") != "train":
        return None
    r = layer["region"]
    return 100.0 * (1.0 - r.busy_s / r.wall_s)
