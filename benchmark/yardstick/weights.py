"""The model's weights, made on the device from a seed.

One ``torch.Generator`` on the device draws every matrix in one call each,
in float32 (the type the program trains and serves), in the program's
archive layout (``Wx`` (d_in, 3h) with column blocks [h | r | z], ``Wh``
(h, h), ``Wrz`` (h, 2h), ``Bh`` (3h,), ``Wy`` (rows padded to
:func:`counts.pad_items`, h + 1 columns padded to a multiple of 128, the
output bias in column h), and only for the one-layer, constrained-embedding
models of the benchmark's configurations. Every matrix is uniform with the
reference code's Glorot width ``sqrt(6 / (rows + cols))`` per block, the
item rows of ``Wy`` with that width times the configuration's
``item_row_scale`` (an assumption of the configuration, chosen so that
its controls move the ranks its checks compare); the biases of the GRU
are zero. The output bias is ``-OUTPUT_BIAS_SCALE * zipf * ln(i + 1)`` for
item ``i`` (the logarithm of its popularity in the click stream, scaled),
so that rankings follow popularity in part, as a trained model's do, and
metrics such as recall are not all noise.
"""

from __future__ import annotations

import math

import torch

from benchmark.yardstick.counts import pad_cols, pad_items

OUTPUT_BIAS_SCALE = 0.05


def make_params(config: dict, seed: int, device) -> dict:
    if not config["params"]["constrained_embedding"] or len(config["params"]["layers"]) != 1:
        raise NotImplementedError("weights for one-layer constrained-embedding models only")
    h = int(config["params"]["layers"][0])
    n = int(config["n_items"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def uniform(shape, rows, cols, scale=1.0):
        s = scale * math.sqrt(6.0 / (rows + cols))
        return torch.rand(shape, generator=gen, device=device).mul_(2 * s).sub_(s)

    Wy = torch.zeros((pad_items(n), pad_cols(h + 1)), device=device)
    Wy[:n, :h] = uniform((n, h), n, h, float(config["weights"]["item_row_scale"]))
    bias = OUTPUT_BIAS_SCALE * config["clicks"]["zipf"]
    Wy[:n, h] = -bias * torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32))
    return {"Wx": [uniform((h, 3 * h), h, h)], "Wh": [uniform((h, h), h, h)],
            "Wrz": [uniform((h, 2 * h), h, h)],
            "Bh": [torch.zeros(3 * h, device=device)], "Wy": Wy}


def flat(params: dict) -> dict:
    """``{"Wx": tensor, ...}``: the one layer's matrices by name."""
    return {k: (v[0] if isinstance(v, list) else v) for k, v in params.items()}
