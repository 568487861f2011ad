"""idle_share.serve: the share of the traced predict_topk calls' wall time
in which no device operation ran, in percent."""


def read(layer):
    if layer is None or layer.get("kind") != "serve":
        return None
    calls = layer["region"].call_times()
    if not calls:
        return None
    return 100.0 * (1.0 - sum(b for _, b in calls) / sum(w for w, _ in calls))
