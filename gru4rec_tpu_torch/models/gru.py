"""GRU stack: parameter initialization and the single-step forward pass.

PyTorch counterpart of ``gru4rec_tpu/models/gru.py`` (reference:
gru4rec.py:267-294 init, gru4rec.py:433-506 model):

* the three input modes — one-hot (the input row-gather *is* the input
  matmul), separate embedding, and constrained (output table reused as input
  embedding);
* gathered rows enter the differentiated function as explicit leaf tensors,
  so gradients w.r.t. item tables stay row-sparse (the reference
  differentiates w.r.t. the gathered subtensors, gru4rec.py:384);
* hidden-state reset is applied *before* the step from the schedule's reset
  mask.

The parameter layout is the JAX package's, so weights carry across
unchanged (``io/convert.py``): ``Wx[i]`` is (in, 3h) with column blocks
[h | r | z], ``Wrz[i]`` is (h, 2h) with blocks [r | z], ``Bh[i]`` is (3h,),
and the output bias is column ``h`` of ``Wy``, which is
(pad_items(n_items), pad_cols(h+1)).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.ops.activations import get_activation
from gru4rec_tpu_torch.ops.mixed_mm import mixed_mm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def input_mode(cfg: GRU4RecConfig) -> str:
    if cfg.constrained_embedding:
        return "constrained"
    if cfg.embedding:
        return "embedding"
    return "onehot"


def input_rows(params, idx, mode: str, gather_rows=lambda table, idx: table[idx]):
    """The rows of a step's inputs ``idx`` by input mode (``WyS``, ``E`` or
    ``Wx0``: the srows entry ``forward`` reads), from ``gather_rows`` (a
    take; a mesh passes its row gather)."""
    if mode == "constrained":
        return {"WyS": gather_rows(params["Wy"], idx)}
    if mode == "embedding":
        return {"E": gather_rows(params["E"], idx)}
    return {"Wx0": gather_rows(params["Wx"][0], idx)}


def pad_items(n_items: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` at least 8 rows greater than
    n_items (the JAX package's table layout; the spare rows are zero)."""
    return ((n_items + 7 + multiple) // multiple) * multiple


def pad_cols(width: int) -> int:
    """Round a table width up to a multiple of 128 (the JAX package's
    layout; the extra columns are zero and never read by the model)."""
    return ((width + 127) // 128) * 128


def init_params_numpy(cfg: GRU4RecConfig, n_items: int) -> Dict:
    """Initialize all weights with the reference's scheme and RNG call order
    (gru4rec.py:252-294): Glorot-width uniform/normal draws from a seeded
    NumPy RNG; E (if any), then per layer Wx (3 blocks), Wh, Wrz (2 blocks),
    then Wy. Bh/By start at zero. Item-dimensioned tables are padded to
    ``cfg.item_pad_multiple`` rows; padded rows are zero."""
    rng = np.random.RandomState(cfg.seed)
    dtype = np.dtype(cfg.param_dtype)
    mode = input_mode(cfg)
    layers = list(cfg.layers)
    n_pad = pad_items(n_items, cfg.item_pad_multiple)

    def init_matrix(shape, pad_rows=0):
        if cfg.sigma != 0:
            sigma = cfg.sigma
        else:
            sigma = np.sqrt(6.0 / (shape[0] + shape[1]))
        if cfg.init_as_normal:
            m = (rng.randn(*shape) * sigma).astype(dtype)
        else:
            m = (rng.rand(*shape) * sigma * 2 - sigma).astype(dtype)
        if pad_rows:
            m = np.concatenate([m, np.zeros((pad_rows, shape[1]), dtype=dtype)], axis=0)
        return m

    params: Dict = {"Wx": [], "Wh": [], "Wrz": [], "Bh": []}
    if mode == "constrained":
        n_features = layers[-1]
    elif mode == "embedding":
        params["E"] = init_matrix((n_items, cfg.embedding), pad_rows=n_pad - n_items)
        n_features = cfg.embedding
    else:
        n_features = n_items

    for i in range(len(layers)):
        in_dim = layers[i - 1] if i > 0 else n_features
        pad = (n_pad - n_items) if (i == 0 and mode == "onehot") else 0
        blocks = [init_matrix((in_dim, layers[i]), pad_rows=pad) for _ in range(3)]
        params["Wx"].append(np.hstack(blocks))
        params["Wh"].append(init_matrix((layers[i], layers[i])))
        m2 = [init_matrix((layers[i], layers[i])) for _ in range(2)]
        params["Wrz"].append(np.hstack(m2))
        params["Bh"].append(np.zeros((layers[i] * 3,), dtype=dtype))
    wy = init_matrix((n_items, layers[-1]), pad_rows=n_pad - n_items)
    wcols = pad_cols(layers[-1] + 1)
    params["Wy"] = np.concatenate(
        [wy, np.zeros((n_pad, wcols - layers[-1]), dtype=dtype)], axis=1
    )
    return params


def map_params(fn, params: Dict) -> Dict:
    """A parameter dict with ``fn`` applied to every array (the per-layer
    lists stay lists)."""
    return {k: ([fn(a) for a in v] if isinstance(v, list) else fn(v))
            for k, v in params.items()}


def init_params(cfg: GRU4RecConfig, n_items: int, device) -> Dict:
    """:func:`init_params_numpy`, as tensors on ``device``."""
    return map_params(lambda a: torch.from_numpy(a).to(device),
                      init_params_numpy(cfg, n_items))


def init_hidden(cfg: GRU4RecConfig, batch_size: int, device) -> List[torch.Tensor]:
    return [torch.zeros((batch_size, h), dtype=torch_dtype(cfg.param_dtype),
                        device=device) for h in cfg.layers]


def _dropout(x, p, gen, lanes=None):
    """Inverted dropout of ``x`` (rows = lanes). ``lanes = (lo, batch)``:
    ``x`` holds lanes ``[lo, lo + len(x))`` of a batch of ``batch``; the
    mask is drawn for the whole batch and its rows of ``x`` are kept, so
    every lane block draws as one whole-batch call would."""
    if p <= 0.0:
        return x
    keep = 1.0 - p
    shape = x.shape if lanes is None else (lanes[1],) + tuple(x.shape[1:])
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    if lanes is not None:
        mask = mask[lanes[0]:lanes[0] + x.shape[0]]
    return torch.where(mask, x / keep, 0.0)


def make_mm(cfg: GRU4RecConfig):
    """Matmul in ``compute_dtype`` with float32 accumulation — the JAX
    package's ``dot(a.astype(cdt), b.astype(cdt),
    preferred_element_type=f32)``. bfloat16 is :func:`ops.mixed_mm.mixed_mm`:
    the card's bf16 tensor cores, forward and backward, on CUDA tensors, and
    on the CPU the operands rounded to bfloat16, widened back and multiplied
    in float32. Float32 products run in full float32 on the card (TF32 off,
    which ``GRU4Rec`` sets), as JAX's ``Precision.HIGHEST`` asks."""
    if torch_dtype(cfg.compute_dtype) == torch.float32:
        def mm32(a, b):
            return torch.matmul(a.float(), b.float())

        return mm32
    return mixed_mm


def gru_cell(vec, H, Wrz, Wh, hidden_act, hdim, mm=torch.matmul):
    """One GRU cell given the precomputed input projection ``vec = x·Wx + Bh``
    (B, 3h) with column blocks [h | r | z] (reference: gru4rec.py:471-479)."""
    rz = torch.sigmoid(vec[:, hdim:] + mm(H, Wrz))
    r = rz[:, :hdim]
    z = rz[:, hdim:]
    hbar = hidden_act(mm(H * r, Wh) + vec[:, :hdim])
    return (1.0 - z) * H + z * hbar


def forward_stack(
    params: Dict,
    srows: Dict,
    H: List,
    cfg: GRU4RecConfig,
    *,
    M=None,
    training: bool,
    gen: Optional[torch.Generator] = None,
    full_catalog: bool = False,
    dropout_lanes=None,
):
    """The GRU stack of :func:`forward`, without its scoring: ``(H_new
    list, y)``, ``y`` (B, h) the last layer's output, which the scores
    multiply by the item table."""
    mode = input_mode(cfg)
    hidden_act = get_activation(cfg.hidden_act)
    layers = cfg.layers
    mm = make_mm(cfg)
    drop = training and gen is not None

    h_last = layers[-1]
    H_new = []
    if mode == "constrained":
        S = srows["WyS"]
        # keep the matrix part only (bias at column h_last, then padding)
        Sx = (S[:M] if not full_catalog else S)[:, :h_last]
        y = _dropout(Sx, cfg.dropout_p_embed, gen, dropout_lanes) if drop else Sx
        start = 0
    elif mode == "embedding":
        Sx = srows["E"]
        y = _dropout(Sx, cfg.dropout_p_embed, gen, dropout_lanes) if drop else Sx
        start = 0
    else:
        Sx = srows["Wx0"]
        vec = Sx + params["Bh"][0]
        h = gru_cell(vec, H[0], params["Wrz"][0], params["Wh"][0], hidden_act, layers[0], mm)
        h = _dropout(h, cfg.dropout_p_hidden, gen, dropout_lanes) if drop else h
        y = h
        H_new.append(h)
        start = 1

    for i in range(start, len(layers)):
        vec = mm(y, params["Wx"][i]) + params["Bh"][i]
        h = gru_cell(vec, H[i], params["Wrz"][i], params["Wh"][i], hidden_act, layers[i], mm)
        h = _dropout(h, cfg.dropout_p_hidden, gen, dropout_lanes) if drop else h
        y = h
        H_new.append(h)
    return H_new, y


def forward(
    params: Dict,
    srows: Dict,
    H: List,
    cfg: GRU4RecConfig,
    *,
    M=None,
    training: bool,
    gen: Optional[torch.Generator] = None,
    col_valid=None,
    logq_correction=None,
    full_catalog: bool = False,
    item_valid=None,
    dropout_lanes=None,
):
    """Single-step forward.

    ``srows`` carries the gathered rows (differentiation targets); Wy rows
    include the folded bias column at index h plus padding (w =
    pad_cols(h+1)):
      one-hot:      {'Wx0': (B, 3h), 'Wy': (N, w)}
      embedding:    {'E': (B, d_e), 'Wy': (N, w)}
      constrained:  {'WyS': (B+N, w)}  — single concat gather
    For ``full_catalog`` scoring (predict/eval), the full (padded) Wy table
    is used instead of gathered rows. ``gen`` draws the dropout masks;
    ``dropout_lanes = (lo, batch)`` says that the rows are lanes ``lo ..``
    of a batch of ``batch`` (a mesh rank's block, ``parallel/dist_step.py``).

    Returns (H_new list, yhat (B, N) or (B, n_items_pad)).
    """
    H_new, y = forward_stack(params, srows, H, cfg, M=M, training=training, gen=gen,
                             full_catalog=full_catalog, dropout_lanes=dropout_lanes)
    scores = score(params, srows, y, cfg, M=M, full_catalog=full_catalog)
    if training and logq_correction is not None:
        scores = scores - logq_correction  # pre-activation (gru4rec.py:494-495)
    valid = item_valid if full_catalog else col_valid
    return H_new, activate(scores, cfg, training=training, valid=valid,
                           full_catalog=full_catalog)


def score(params: Dict, srows: Dict, y, cfg: GRU4RecConfig, *, M=None,
          full_catalog: bool = False):
    """The scores of :func:`forward`, before the final activation: ``y``
    times the item rows, plus their bias column."""
    h_last = cfg.layers[-1]
    if full_catalog:
        Syb = params["Wy"]
    else:
        # at predict time the constrained mode re-gathers Wy[Y] explicitly
        # (reference: gru4rec.py:481-485); during training it reuses the
        # concatenated gather's tail
        Syb = srows["Wy"] if "Wy" in srows else srows["WyS"][M:]
    return make_mm(cfg)(y, Syb[:, :h_last].T) + Syb[:, h_last]


def activate(scores, cfg: GRU4RecConfig, *, training: bool, valid=None,
             full_catalog: bool = False):
    """The final activation of :func:`forward` over ``scores``: a softmax
    over the ``valid`` columns, or an elementwise activation whose invalid
    full-catalog columns read ``-inf``."""
    final_act_name = cfg.final_act
    fact = get_activation(final_act_name)
    if not training and final_act_name == "softmax_logit":
        # predict path swaps softmax_logit for softmax (gru4rec.py:490-491,499-500)
        fact = get_activation("softmax")
    if final_act_name in ("softmax", "softmax_logit"):
        return fact(scores, valid)
    yhat = fact(scores)
    if full_catalog and valid is not None:
        yhat = torch.where(valid, yhat, -torch.inf)
    return yhat
