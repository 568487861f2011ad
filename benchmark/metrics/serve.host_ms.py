"""serve.host_ms: the median over the traced predict_topk calls of each
call's wall time (its span) less the device's busy time inside it, in ms."""

import statistics


def read(layer):
    if layer is None or layer.get("kind") != "serve":
        return None
    calls = layer["region"].call_times()
    if not calls:
        return None
    return statistics.median(w - b for w, b in calls) * 1e3
