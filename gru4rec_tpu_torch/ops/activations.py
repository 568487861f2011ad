"""Activation registry with the reference's string-parameterized grammar.

Supports: linear, tanh, relu, sigmoid, softmax, softmax_logit, and the
parameterized ``leaky-<X>``, ``elu-<X>``, ``selu-<X>-<Y>`` names whose
parameters are parsed out of the string (reference: gru4rec.py:144-161,
188-223). PyTorch counterpart of ``gru4rec_tpu/ops/activations.py``.

Softmax-family activations take an optional column-validity mask so that
masked (dead) lanes are excluded from the normalization: batches keep a
static width and dead lanes are masked instead of removed.
"""

from __future__ import annotations

from functools import partial

import torch

NEG_INF = -1e30


def masked_softmax(x, col_valid=None, dim=-1):
    """Numerically-stable softmax excluding masked columns (reference softmax: gru4rec.py:193-195)."""
    if col_valid is not None:
        x = torch.where(col_valid, x, NEG_INF)
    x = x - torch.amax(x, dim=dim, keepdim=True)
    e_x = torch.exp(x)
    if col_valid is not None:
        e_x = torch.where(col_valid, e_x, 0.0)
    return e_x / torch.sum(e_x, dim=dim, keepdim=True)


def masked_softmax_logit(x, col_valid=None, dim=-1):
    """-log softmax(x) (reference softmax_logit: gru4rec.py:196-198)."""
    if col_valid is not None:
        x = torch.where(col_valid, x, NEG_INF)
    x = x - torch.amax(x, dim=dim, keepdim=True)
    e_x = torch.exp(x)
    if col_valid is not None:
        e_x = torch.where(col_valid, e_x, 0.0)
    return torch.log(torch.sum(e_x, dim=dim, keepdim=True)) - x


def softmax_neg(x, col_valid=None, diag_offset=0):
    """Softmax over each row's *negatives*: the entry holding the row's own
    positive is masked out (reference softmax_neg: gru4rec.py:199-203).
    2D input only; the positive of row i sits at column i + diag_offset."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    hm = (cols != rows + diag_offset).to(x.dtype)
    if col_valid is not None:
        hm = hm * col_valid.to(x.dtype)
    x = x * hm
    e_x = torch.exp(x - torch.amax(x, dim=1, keepdim=True)) * hm
    return e_x / torch.sum(e_x, dim=1, keepdim=True)


def _linear(x, col_valid=None):
    return x


def _tanh(x, col_valid=None):
    return torch.tanh(x)


def _relu(x, col_valid=None):
    # torch.maximum splits the gradient of a tie evenly, as jnp.maximum
    # does: the derivative at x == 0 is 0.5 (clamp's would be 1)
    return torch.maximum(x, x.new_zeros(()))


def _sigmoid(x, col_valid=None):
    return 1.0 / (1.0 + torch.exp(-x))


def _leaky(leak, x, col_valid=None):
    return torch.where(x >= 0, x, leak * x)


def _elu(alpha, x, col_valid=None):
    return torch.where(x >= 0, x, alpha * (torch.exp(torch.clamp(x, max=0.0)) - 1.0))


def _selu(lmbd, alpha, x, col_valid=None):
    return lmbd * torch.where(x >= 0, x, alpha * (torch.exp(torch.clamp(x, max=0.0)) - 1.0))


def rank_invariant(name: str) -> bool:
    """True when the activation is strictly increasing per element, i.e.
    ranking on pre-activation scores yields the same ranks as ranking on
    activated scores. The port's evaluator does not use it: it always ranks
    activated scores (the reference's semantics); it is kept to document
    which activations the JAX evaluator ranks on logits."""
    if name in ("linear", "tanh", "sigmoid", "softmax", "softmax_logit"):
        return True
    try:
        if name.startswith("leaky-"):
            return float(name.split("-")[1]) > 0
        if name.startswith("elu-"):
            return float(name.split("-")[1]) > 0
        if name.startswith("selu-"):
            parts = [float(x) for x in name.split("-")[1:]]
            return len(parts) == 2 and parts[0] > 0 and parts[1] > 0
    except ValueError:
        return False
    return False


def get_activation(name: str):
    """Resolve an activation by its (possibly parameterized) string name."""
    if name == "linear":
        return _linear
    if name == "tanh":
        return _tanh
    if name == "relu":
        return _relu
    if name == "sigmoid":
        return _sigmoid
    if name == "softmax":
        return masked_softmax
    if name == "softmax_logit":
        return masked_softmax_logit
    if name.startswith("leaky-"):
        return partial(_leaky, float(name.split("-")[1]))
    if name.startswith("elu-"):
        return partial(_elu, float(name.split("-")[1]))
    if name.startswith("selu-"):
        parts = [float(x) for x in name.split("-")[1:]]
        return partial(_selu, *parts)
    raise NotImplementedError(f"Unknown activation: {name!r}")
