"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) resolves to its configuration's file
(``configs[].file``), its traffic mix ``traffic/<traffic>.json``, its
limits ``limits/<cell>.json``, its end-to-end metrics (those whose
``workloads`` list it, or that have none) and its per-layer metrics (those
whose ``workloads`` list it, or that have none and move an end-to-end
metric the cell reports), each read by ``metrics/<name>.py``. A cell that
``BENCHMARK.json`` does not hold is looked for in ``deferred.json``, which
holds cells left out, with the metrics only they report, in the same form.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _load(path):
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Cell:
    spec = load_spec(root)
    if name not in {x["name"] for x in spec["workloads"]}:
        deferred = _load(os.path.join(HERE, "deferred.json"))
        if name not in {x["name"] for x in deferred["workloads"]}:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        spec = {**spec, **{k: spec[k] + deferred[k]
                           for k in ("workloads", "end_to_end", "per_layer")}}
    w = {x["name"]: x for x in spec["workloads"]}[name]
    conf = {x["name"]: x for x in spec["configs"]}[w["config"]]

    def applies(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_load(os.path.join(root, conf["file"])),
                traffic=_load(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
                limits=_load(os.path.join(HERE, "limits", name + ".json")),
                end_to_end=e2e, per_layer=layer)


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", name + ".py")
