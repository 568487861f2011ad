"""schedule_ms.eval: the host time of the traced evaluate call's schedule,
in ms: the program's span ``gru4rec.evaluate.schedule`` (the test clicks
joined to the catalog, sorted, cut into sessions and walked over the
lanes: ``eval/evaluation.py::_eval_schedule`` and ``data/scheduler.py``),
per ``gru4rec.evaluate`` span.

The trace alone says whether the program opens spans: one that holds any
``gru4rec.*`` span but no ``gru4rec.evaluate`` is an error, not a missing
reading; one that holds no ``gru4rec.*`` span gives no reading."""

CALL = "gru4rec.evaluate"
SCHEDULE = "gru4rec.evaluate.schedule"


def read(layer):
    if layer is None or layer.get("kind") != "eval":
        return None
    host = layer["region"].host
    calls = [e for e in host if e["name"] == CALL]
    if not calls:
        if any(e.get("cat") == "user_annotation" and e["name"].startswith("gru4rec.")
               for e in host):
            raise RuntimeError(f"schedule_ms.eval: the trace holds no {CALL} span")
        return None
    return sum(e["dur"] for e in host if e["name"] == SCHEDULE) / 1e3 / len(calls)
