"""The training step and the chunk runner.

PyTorch counterpart of ``gru4rec_tpu/train/step.py``. Where the JAX package
fuses a chunk of ``cfg.chunk_size`` steps into one ``lax.scan`` program,
this runs a plain Python loop over the chunk's steps; negatives for the
whole chunk are still drawn in one call, as there.

Gradients w.r.t. the item tables stay row-sparse: the gathered rows are
leaf tensors that autograd differentiates (the reference's sampled-params
gradients, gru4rec.py:384), so no dense (n_items, d) gradient is ever formed;
they are applied with the fused row-sparse update
(``ops/kernels/sparse_update.py``). Parameters and optimizer state are
updated in place.

Under ``opt_state_dtype="bfloat16_sr"`` each sparse table's update gets its
own stochastic-rounding seed per step, ``ops.sr.step_seed(cfg.seed, step,
SR_TABLE_SALT[table])``: a host computation, so the step issues no device
synchronisation for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.ops.losses import get_loss
from gru4rec_tpu_torch.ops.sr import step_seed
from gru4rec_tpu_torch.ops.sampling import draw_negatives
from gru4rec_tpu_torch.train.optimizers import SENTINEL, make_optimizer

DENSE_GROUPS = ("Wx", "Wh", "Wrz", "Bh")
# Per-table salt of the stochastic-rounding seed, keyed on state names (the
# JAX package's values): without it the tables updated in one step would
# share one dither stream. 0x5352 = ASCII "SR".
SR_TABLE_SALT = {"Wx0": 0x53520001, "E": 0x53520002, "Wy": 0x53520003}


@dataclass
class TrainState:
    params: Dict
    opt_state: Dict
    H: List[torch.Tensor]
    gen: torch.Generator  # draws negatives and dropout masks
    step: int = 0         # global step counter


def make_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def init_train_state(cfg: GRU4RecConfig, n_items: int, device) -> TrainState:
    params = gru.init_params(cfg, n_items, device)
    return TrainState(params, init_opt_state(cfg, params),
                      gru.init_hidden(cfg, cfg.batch_size, device),
                      make_generator(cfg.seed, device))


def init_opt_state(cfg: GRU4RecConfig, params: Dict) -> Dict:
    opt = make_optimizer(cfg)
    mode = gru.input_mode(cfg)
    dense, sparse_names = split_params(params, mode)
    return {
        "dense": {k: [opt.init_state(p) for p in v] for k, v in dense.items()},
        "sparse": {name: opt.init_state(_sparse_table(params, name), sparse=True)
                   for name in sparse_names},
    }


def split_params(params: Dict, mode: str):
    """Split the parameter dict into the densely-updated groups and the
    names of row-sparsely-updated item tables (reference: gru4rec.py:578)."""
    dense = {
        "Wx": list(params["Wx"][1:] if mode == "onehot" else params["Wx"]),
        "Wh": list(params["Wh"]),
        "Wrz": list(params["Wrz"]),
        "Bh": list(params["Bh"]),
    }
    return dense, sparse_table_names(mode)


def sparse_table_names(mode: str):
    """State names of the row-sparsely updated item tables of ``mode``."""
    return {"onehot": ("Wx0", "Wy"), "embedding": ("E", "Wy")}.get(mode, ("Wy",))


def merge_dense(params: Dict, dense: Dict, mode: str) -> Dict:
    out = dict(params)
    if mode == "onehot":
        out["Wx"] = [params["Wx"][0]] + list(dense["Wx"])
    else:
        out["Wx"] = list(dense["Wx"])
    out["Wh"] = list(dense["Wh"])
    out["Wrz"] = list(dense["Wrz"])
    out["Bh"] = list(dense["Bh"])
    return out


def _sparse_table(params: Dict, name: str):
    return params["Wx"][0] if name == "Wx0" else params[name]


def make_chunk_fn(cfg: GRU4RecConfig, n_items: int):
    """Build the per-chunk training function.

    Signature: ``chunk_fn(state, in_c, out_c, valid_c, reset_c, samp1, logp0,
    neg=None, sr_seeds=None) -> (loss_weighted_sum, event_count)``. The
    ``*_c`` arguments are (chunk, B) numpy schedule slices (host arrays: the
    step gating and the event count need no device round trip); ``samp1`` is
    the sampler table on the device; ``neg`` (chunk, n_sample), when given,
    replaces the chunk's negative draw, and ``sr_seeds`` ({state name:
    (chunk,) int32}), when given, the stochastic-rounding seeds of each
    sparse table's update (tests inject the JAX package's). ``state``
    is updated in place. Loss bookkeeping follows the reference: the
    per-step cost is divided by the *static* batch size (gru4rec.py:577) and
    the returned loss sum weights steps by live-lane count (a device
    scalar).
    """
    mode = gru.input_mode(cfg)
    loss_fn = get_loss(cfg.loss, cfg.n_sample, cfg.smoothing, cfg.bpreg)
    opt = make_optimizer(cfg)
    B = cfg.batch_size
    n_sample = cfg.n_sample
    use_logq = bool(cfg.logq)
    sparse_names = sparse_table_names(mode)

    def step_fn(state, in_d, out_d, valid_d, reset_d, neg_t, Mf, logp0, seeds):
        params, opt_state = state.params, state.opt_state
        dev = params["Wy"].device
        row_valid = valid_d
        if n_sample > 0:
            col_valid = torch.cat([valid_d, torch.ones(n_sample, dtype=torch.bool, device=dev)])
            Y = torch.cat([torch.where(valid_d, out_d, 0), neg_t])
            Y_scatter = torch.cat([torch.where(valid_d, out_d, SENTINEL), neg_t])
        else:
            col_valid = valid_d
            Y = torch.where(valid_d, out_d, 0)
            Y_scatter = torch.where(valid_d, out_d, SENTINEL)
        Xg = torch.where(valid_d, in_d, 0)
        X_scatter = torch.where(valid_d, in_d, SENTINEL)

        # pre-step hidden reset (see data/scheduler.py on reset semantics)
        H = [torch.where(reset_d[:, None], 0.0, h) for h in state.H]

        # gathered rows are leaf tensors => row-sparse gradients
        def leaf(rows):
            return rows.detach().requires_grad_(True)

        if mode == "onehot":
            srows = {"Wx0": leaf(params["Wx"][0][Xg]), "Wy": leaf(params["Wy"][Y])}
            scatter_idx = {"Wx0": X_scatter, "Wy": Y_scatter}
        elif mode == "embedding":
            srows = {"E": leaf(params["E"][Xg]), "Wy": leaf(params["Wy"][Y])}
            scatter_idx = {"E": X_scatter, "Wy": Y_scatter}
        else:  # constrained: single concatenated gather (gru4rec.py:438-448)
            srows = {"WyS": leaf(params["Wy"][torch.cat([Xg, Y])])}
            scatter_idx = {"WyS": torch.cat([X_scatter, Y_scatter])}

        logq_corr = None
        if use_logq:
            # score -= logq*log(concat(P0[pos], P0[neg]^alpha)) (gru4rec.py:494-495)
            lp_pos = logp0[(Y[:B] if n_sample > 0 else Y).long()]
            if n_sample > 0:
                lp_neg = cfg.sample_alpha * logp0[neg_t.long()]
                logq_corr = cfg.logq * torch.cat([lp_pos, lp_neg])
            else:
                logq_corr = cfg.logq * lp_pos

        dense, _ = split_params(params, mode)
        dense_leaves = {k: [p.detach().requires_grad_(True) for p in v]
                        for k, v in dense.items()}
        H_new, yhat = gru.forward(
            merge_dense(params, dense_leaves, mode), srows, H, cfg, M=B,
            training=True, gen=state.gen, col_valid=col_valid,
            logq_correction=logq_corr,
        )
        cost = loss_fn(yhat, Mf, row_valid, col_valid) / B
        flat_dense = [p for k in DENSE_GROUPS for p in dense_leaves[k]]
        names = list(srows)
        grads = torch.autograd.grad(cost, flat_dense + [srows[n] for n in names])
        g_dense, g_sparse = opt.clip_by_global_norm(
            list(grads[:len(flat_dense)]), list(grads[len(flat_dense):]))

        with torch.no_grad():
            gi = iter(g_dense)
            for k in DENSE_GROUPS:
                for p, st in zip(dense[k], opt_state["dense"][k]):
                    opt.apply_dense(p, next(gi), st)
            for name, g in zip(names, g_sparse):
                sname = "Wy" if name == "WyS" else name
                opt.apply_sparse(_sparse_table(params, sname), scatter_idx[name],
                                 g, opt_state["sparse"][sname],
                                 sr_seed=None if seeds is None else (seeds[sname], 0))
            state.H = [torch.where(valid_d[:, None], hn.detach(), ho)
                       for hn, ho in zip(H_new, H)]
        return cost.detach() * Mf

    def chunk_fn(state: TrainState, in_c, out_c, valid_c, reset_c, samp1,
                 logp0, neg=None, sr_seeds=None):
        chunk = in_c.shape[0]
        dev = state.params["Wy"].device
        if n_sample > 0 and neg is None:
            neg = draw_negatives(state.gen, samp1, chunk, n_sample, n_items,
                                 cfg.sample_alpha, cfg.sampler)
        # one upload per chunk; a blocking copy per step would drain the
        # stream every step
        in_d, out_d, valid_d, reset_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                         for a in (in_c, out_c, valid_c, reset_c))
        counts = valid_c.sum(axis=1)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(chunk):
            # a fully-padded step is a no-op (the JAX package's any_valid
            # gate): no update of any parameter or optimizer state
            if counts[t] > 0:
                neg_t = neg[t].to(device=dev, dtype=torch.int32) if n_sample > 0 else None
                seeds = None
                if opt.state_sr:
                    seeds = ({k: int(v[t]) for k, v in sr_seeds.items()}
                             if sr_seeds is not None else
                             {k: step_seed(cfg.seed, state.step, SR_TABLE_SALT[k])
                              for k in sparse_names})
                loss_sum = loss_sum + step_fn(state, in_d[t], out_d[t], valid_d[t],
                                              reset_d[t], neg_t, float(counts[t]), logp0,
                                              seeds)
            state.step += 1
        return loss_sum, int(counts.sum())

    return chunk_fn
