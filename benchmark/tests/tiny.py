"""Tiny cells of each kind, for CPU runs of the jobs: the configurations'
loss, activation, optimizer and precision at widths and catalogs a CPU
test holds."""

from __future__ import annotations

import copy

from benchmark import spec

# 1,024 negatives: a chunk's draw (200-300 steps here) holds enough of them
# for ``sampler_gap`` to read the sampler rather than its noise
SIZES = {"retailrocket": {"layers": [16], "batch_size": 8, "n_sample": 1024, "n_items": 300},
         "rees46": {"layers": [24], "batch_size": 12, "n_sample": 1024, "n_items": 500}}
TRAFFIC = {"fit": {"clicks_per_epoch": 3000, "nominal_epoch_s": 1.0, "traced_steps": 0},
           "evaluate": {"clicks": 2000, "batch_size": 16},
           "serve": {"lanes": 4, "warmup_calls": 3, "max_calls_per_s": 100,
                     "checked_calls": 8}}


def tiny_cell(workload: str) -> spec.Cell:
    cell = copy.deepcopy(spec.cell(workload))
    size = SIZES[cell.config["name"]]
    cell.config["n_items"] = size["n_items"]
    cell.config["params"].update({k: v for k, v in size.items() if k != "n_items"})
    cell.traffic.update(TRAFFIC[cell.traffic["kind"]])
    return cell
