"""The one-hot model's weights, made on the device from a seed.

:mod:`benchmark.yardstick.weights` does the same for the constrained
embedding; this is its counterpart for the one-hot input of GRU4Rec's
original architecture (``constrained_embedding`` false, ``embedding`` 0),
in the program's layout (``gru4rec_tpu_torch/models/gru.py::
init_params_numpy``): ``Wx[0]`` is an item table of its own, (rows padded
to :func:`counts.pad_items`, 3h) with column blocks [h | r | z], each block
uniform with Glorot's width ``sqrt(6 / (n_items + h))`` (the three blocks
share that width, so one draw makes them) and its padded rows zero; ``Wh``
(h, h) and ``Wrz`` (h, 2h) as in ``weights.py``; ``Bh`` zero; ``Wy`` (rows
padded, h + 1 columns padded to a multiple of 128) with its item rows
uniform at Glorot's width times ``item_row_scale`` and the output bias
``-OUTPUT_BIAS_SCALE * zipf * ln(i + 1)`` in column h, as ``weights.py``
makes it. One ``torch.Generator`` on the device draws every matrix in one
call each, in float32, in the order ``Wy``, ``Wx``, ``Wh``, ``Wrz``.
"""

from __future__ import annotations

import math

import torch

from benchmark.yardstick.counts import pad_cols, pad_items
from benchmark.yardstick.weights import OUTPUT_BIAS_SCALE


def make_params(config: dict, seed: int, device) -> dict:
    p = config["params"]
    if p["constrained_embedding"] or p["embedding"] or len(p["layers"]) != 1:
        raise NotImplementedError("weights for one-layer one-hot models only")
    h = int(p["layers"][0])
    n = int(config["n_items"])
    n_pad = pad_items(n)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def uniform(shape, rows, cols, scale=1.0):
        s = scale * math.sqrt(6.0 / (rows + cols))
        return torch.rand(shape, generator=gen, device=device).mul_(2 * s).sub_(s)

    Wy = torch.zeros((n_pad, pad_cols(h + 1)), device=device)
    Wy[:n, :h] = uniform((n, h), n, h, float(config["weights"]["item_row_scale"]))
    bias = OUTPUT_BIAS_SCALE * config["clicks"]["zipf"]
    Wy[:n, h] = -bias * torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32))
    Wx = torch.zeros((n_pad, 3 * h), device=device)
    Wx[:n] = uniform((n, 3 * h), n, h)
    return {"Wx": [Wx], "Wh": [uniform((h, h), h, h)], "Wrz": [uniform((h, 2 * h), h, h)],
            "Bh": [torch.zeros(3 * h, device=device)], "Wy": Wy}
