"""A tiny cell of the one-hot configuration, for CPU runs of its job:
``rsc15``'s loss, activation, optimizer and precision at a width and a
catalog a CPU test holds (``tiny.py``'s sizes, for the kind ``fit_onehot``)."""

from __future__ import annotations

import copy

from benchmark import spec
from benchmark.tests.tiny import TRAFFIC

SIZE = {"layers": [16], "batch_size": 8, "n_sample": 64, "n_items": 300}


def tiny_cell(n_sample: int = SIZE["n_sample"]) -> spec.Cell:
    cell = copy.deepcopy(spec.cell("rsc15.train.onehot"))
    cell.config["n_items"] = SIZE["n_items"]
    cell.config["params"].update(layers=SIZE["layers"], batch_size=SIZE["batch_size"],
                                 n_sample=n_sample)
    cell.traffic.update(TRAFFIC["fit"])
    return cell
