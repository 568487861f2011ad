"""Carry weights and optimizer state across from the JAX package.

The port keeps the JAX package's layouts (``models/gru.py``,
``train/optimizers.py``), so conversion is a mapping of the same pytree onto
tensors plus dtype handling. The inputs are numpy arrays — e.g.
``jax.tree_util.tree_map(np.asarray, state.params)`` — so nothing here
imports JAX. bfloat16 arrives as ``ml_dtypes.bfloat16`` arrays (what
``np.asarray`` of a JAX bfloat16 array gives) or as raw ``uint16`` bit
patterns; both become ``torch.bfloat16``. ``device=None`` means the card,
as for every entry point of the port (``models.gru4rec.resolve_device``);
pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from gru4rec_tpu_torch.models.gru4rec import resolve_device


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A tensor holding a copy of ``a`` (``np.asarray`` of a JAX array may
    share the JAX buffer, which the port's in-place updates must not
    touch)."""
    a = np.array(a)
    device = resolve_device(device)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def params_from_jax(np_params, device=None):
    """The port's parameter dict from the JAX package's params pytree
    ({'Wx', 'Wh', 'Wrz', 'Bh': lists, 'Wy' [, 'E']}) as numpy arrays."""
    return _convert(np_params, device)


def opt_state_from_jax(np_state, device=None):
    """The port's optimizer state from the JAX package's
    ``{'dense': {group: (per-layer dicts)}, 'sparse': {table: dict}}`` as
    numpy arrays. Tuples become lists; dtypes (float32 / bfloat16) are
    kept."""
    return _convert(np_state, device)
