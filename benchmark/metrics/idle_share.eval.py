"""idle_share.eval: the share of the traced evaluate call's wall time in
which no device operation ran, in percent."""


def read(layer):
    if layer is None or layer.get("kind") != "eval":
        return None
    r = layer["region"]
    return 100.0 * (1.0 - r.busy_s / r.wall_s)
