"""What the jobs share: the run's settings, the program's model built on the
benchmark's weights, and device housekeeping.

A job's ``run(cell, run)`` sets up, measures its window, reads the memory
peak, frees the program's state, runs the reference and returns::

    {"metrics": {end-to-end name: value}, "attempted": n, "failed": n,
     "memory_peak_bytes": n, "numbers": {compared name: value},
     "layer": {what the per-layer readers read} or None, "info": {...}}
"""

from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.yardstick.generators import seed32

now = time.perf_counter


@dataclass
class Run:
    seed: int
    seconds: float
    trace: bool
    device: object                 # a torch.device
    t_start: float = 0.0           # process start, on time.perf_counter's clock
    window: list = field(default_factory=list)  # [start, end] of the window
    card_after: object = None      # card_state() just after the window

    def stream(self, name: str) -> int:
        return seed32(self.seed, name)

    def setup_s(self) -> float:
        return self.window[0] - self.t_start


def program_config(cell, seed: int):
    """The program's configuration: the published parameters, the program
    settings the configuration states, and the generator seed."""
    from gru4rec_tpu_torch import GRU4RecConfig

    with quiet():
        return GRU4RecConfig(**cell.config["params"], **cell.config["program"], seed=seed)


def program_model(cell, params: dict, seed: int, device):
    """A ``GRU4Rec`` holding the benchmark's weights over the catalog ``0 ..
    n_items - 1`` (item id ``i`` is row ``i``), as a loaded model would."""
    import pandas as pd

    from gru4rec_tpu_torch import GRU4Rec

    n = int(cell.config["n_items"])
    with quiet():
        model = GRU4Rec(program_config(cell, seed), device=device)
    model.params = params
    model.n_items = n
    model.itemidmap = pd.Series(np.arange(n, dtype=np.int64), index=np.arange(n, dtype=np.int64),
                                name="ItemIdx")
    return model


@contextlib.contextmanager
def quiet():
    """The program's prints go to stderr: stdout carries the result alone."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


SMI_QUERY = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"


def card_state():
    """``nvidia-smi``'s reading of the card: name, power limit and draw,
    SM and memory clocks, temperature (None where it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()


def close_window(run) -> None:
    """The window's end, and the card's state just after it."""
    run.window.append(now())
    if run.device.type == "cuda":
        run.card_after = card_state()


def reset_peak(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


