"""GRU4Rec's original one-hot input, plainly: the training step of a
one-layer model whose input is the one-hot vector of the clicked item
(Hidasi et al., ICLR 2016; the reference code's ``constrained_embedding``
false and ``embedding`` 0).

The product of a one-hot row with ``Wx`` (n_items, 3h) is row ``i`` of
``Wx``, so the input projection is a gather:

    vec = Wx[i] + Bh                   (column blocks [h | r | z])
    [r | z] = sigmoid(vec[r|z] + H Wrz)
    H' = (1 - z) H + z tanh((H * r) Wh + vec[h])

and the score of item ``j`` is ``H' . Wy[j, :h] + Wy[j, h]`` with ``Wy`` a
table of its own. Both item tables are updated only at the rows the step
touched: ``Wx`` at the live lanes' inputs, ``Wy`` at their targets and the
shared negatives, each with the sum of the row's gradients entering adagrad
and its momentum stored in ``opt_state_dtype`` (round to nearest) while
the row moves by the unrounded value (``gru4rec.Trainer._adagrad_rows``'s
semantics); ``Wh``, ``Wrz`` and ``Bh`` are updated in full.

Precision: float32 throughout (TF32 off, ``gru4rec.strict_float32``); the
stated bfloat16 products round their operands and the operands' gradients
(``gru4rec.mm``), and nothing rounds the gathered input rows, which no
product computes.

Departures from the published description: the loss's activation, the
bpr-max loss, adagrad with momentum and the lanes are
:mod:`benchmark.reference.gru4rec`'s, with its departures (duplicate rows
summed before adagrad, the cost divided by the static batch size); no
dropout of the input (a one-hot row has none in the program either, and
the published configuration sets both dropouts to 0).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import gru4rec as ref

DENSE = ("Wh", "Wrz", "Bh")
TABLES = ("Wx", "Wy")  # the item tables: Wx is the one-hot input's Wx[0]


def onehot_step(P, rows, H, rnd):
    """One GRU step from the gathered input rows ``rows`` = ``Wx[i]``."""
    h = H.shape[1]
    vec = rows + P["Bh"]
    rz = torch.sigmoid(vec[:, h:] + ref.mm(H, P["Wrz"], rnd))
    r, z = rz[:, :h], rz[:, h:]
    hbar = torch.tanh(ref.mm(H * r, P["Wh"], rnd) + vec[:, :h])
    return (1.0 - z) * H + z * hbar


class Trainer(ref.Trainer):
    """:class:`benchmark.reference.gru4rec.Trainer`'s step for the one-hot
    input: two row-sparse item tables, the dense ``Wh``, ``Wrz``, ``Bh``."""

    def __init__(self, cfg: dict, params: dict, pop: np.ndarray, rnd, device):
        super().__init__(cfg, params, pop, rnd, device)
        if self.mom > 0:  # Wx is an item table: its momentum is stored as Wy's
            self.vel["Wx"] = torch.zeros_like(self.P["Wx"], dtype=self.vel["Wy"].dtype)

    def step(self, inputs, targets, live, fresh, neg, gen):
        """One step; returns ``(cost, {leaf: gradient})``."""
        cfg, rnd, h, dev = self.cfg, self.rnd, self.h, self.device
        self.H[torch.from_numpy(fresh).to(dev)] = 0.0
        p_h = float(cfg["dropout_p_hidden"])
        mask_h = (torch.rand((self.B, h), generator=gen, device=dev) < 1.0 - p_h
                  if p_h > 0 else None)
        lanes = torch.from_numpy(np.flatnonzero(live)).to(dev)
        x_idx = torch.from_numpy(inputs[live]).to(dev)
        y_idx = torch.from_numpy(targets[live]).to(dev)
        neg = neg.to(dev).long()
        leaves = {k: self.P[k].detach().requires_grad_(True) for k in (*DENSE, *TABLES)}
        hn = onehot_step(leaves, leaves["Wx"][x_idx], self.H[lanes], rnd)
        if mask_h is not None:
            hn = torch.where(mask_h[lanes], hn / (1.0 - p_h), 0.0)
        S = leaves["Wy"][torch.cat([y_idx, neg])]
        scores = ref.mm(hn, S[:, :h].T, rnd) + S[:, h]
        if float(cfg["logq"]):
            scores = scores - float(cfg["logq"]) * torch.cat(
                [self.logp[y_idx], float(cfg["sample_alpha"]) * self.logp[neg]])
        y = ref.final_activation(cfg["final_act"], scores)
        if cfg["loss"] == "bpr-max":
            loss = ref.bpr_max(y, float(cfg["bpreg"]))
        elif cfg["loss"] == "cross-entropy":
            loss = ref.cross_entropy(y)
        else:
            raise NotImplementedError(f"no reference for loss={cfg['loss']!r}")
        cost = loss / self.norm
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(cost, [leaves[k] for k in names])))
        with torch.no_grad():
            for k in DENSE:
                self._adagrad(self.P[k], grads[k], self.acc[k], self.vel.get(k))
            for k, touched in (("Wx", x_idx), ("Wy", torch.cat([y_idx, neg]))):
                rows = torch.unique(touched)
                self._adagrad_table(k, rows, grads[k][rows])
            self.H[lanes] = hn.detach()
        return float(cost.detach()), grads

    def _adagrad_table(self, name, rows, g):
        """``_adagrad_rows`` on the item table ``name``."""
        W, acc = self.P[name], self.acc[name]
        a = acc[rows] + g * g
        acc[rows] = a
        upd = self.lr * (g / torch.sqrt(a + ref.ADAGRAD_EPS))
        if self.mom > 0:
            vel = self.vel[name]
            v = self.mom * vel[rows].float() - upd
            vel[rows] = v.to(vel.dtype)
            W[rows] = W[rows] + v
        else:
            W[rows] = W[rows] - upd
