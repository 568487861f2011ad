"""graph_setup_ms.eval: the host time the traced evaluate call spends on
its captured step's set-up, in ms: the program's spans
``gru4rec.evaluate.warmup`` (the eager steps before the capture),
``gru4rec.graph.capture`` and ``gru4rec.evaluate.release`` (the graph freed
and its pool given back) inside each ``gru4rec.evaluate`` span, per span;
0 for a call that replayed a kept graph.

The trace alone says whether the program opens spans: one that holds any
``gru4rec.*`` span but no ``gru4rec.evaluate`` is an error, not a missing
reading; one that holds no ``gru4rec.*`` span gives no reading."""

CALL = "gru4rec.evaluate"
SETUP = ("gru4rec.evaluate.warmup", "gru4rec.graph.capture", "gru4rec.evaluate.release")


def read(layer):
    if layer is None or layer.get("kind") != "eval":
        return None
    host = layer["region"].host
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == CALL]
    if not calls:
        if any(e.get("cat") == "user_annotation" and e["name"].startswith("gru4rec.")
               for e in host):
            raise RuntimeError(f"graph_setup_ms.eval: the trace holds no {CALL} span")
        return None
    us = sum(e["dur"] for e in host if e["name"] in SETUP
             and any(a <= e["ts"] < b for a, b in calls))
    return us / 1e3 / len(calls)
