"""GRU4Rec, plainly: the GRU step, the final activations, the two ranking
losses, adagrad with momentum on dense and sampled rows, full-catalog
ranking and top-k.

Equations (Hidasi et al., ICLR 2016; Hidasi & Karatzoglou, CIKM 2018; the
parameter layout of the GRU4Rec reference code): with ``x`` the input row
and ``H`` the hidden state,

    vec = x Wx + Bh                    (column blocks [h | r | z])
    [r | z] = sigmoid(vec[r|z] + H Wrz)
    H' = (1 - z) H + z tanh((H * r) Wh + vec[h])

and the score of item ``j`` is ``H' . Wy[j, :h] + Wy[j, h]`` (the bias
folded into column ``h`` of the output table). Under a constrained
embedding the input row of item ``i`` is ``Wy[i, :h]``.

Precision: every float32 operation runs in float32 (TF32 off,
:func:`strict_float32`). The configuration states bfloat16 products with
float32 accumulation: each product's operands are rounded to bfloat16
before a float32 product, and each operand's gradient is rounded to
bfloat16 (:func:`mm` with :func:`round_bf16`). The control of the
comparison rounds them to float8 instead (:func:`round_fp8`, per-tensor
scaled, e4m3).

Lanes are handled as the model defines them and not as the program
schedules them: training keeps ``batch`` lanes that take sessions in
order (:class:`LaneWalk`), and computes on the live lanes alone (a
shrinking batch); evaluation and serving run each session from its first
click, many sessions at once.
"""

from __future__ import annotations

import numpy as np
import torch

ADAGRAD_EPS = 1e-6
LOG_EPS = 1e-24
FP8_MAX = 448.0  # largest finite float8 e4m3fn value


def strict_float32() -> None:
    """float32 products in float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor, its largest magnitude at 448."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.float() * scale


ROUNDINGS = {"bfloat16": round_bf16, "float8": round_fp8}


class _Round(torch.autograd.Function):
    """An operand rounded on the way in, its gradient rounded on the way
    back (the transpose of a cast)."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def mm(a, b, rnd):
    """``a @ b`` with both operands rounded by ``rnd``, in float32."""
    return _Round.apply(a, rnd) @ _Round.apply(b, rnd)


def final_activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The output activation over a row of scores (every column live)."""
    if name == "softmax":
        return torch.softmax(x, dim=1)
    if name.startswith("elu-"):
        a = float(name[4:])
        return torch.where(x >= 0, x, a * (torch.exp(torch.clamp(x, max=0.0)) - 1.0))
    raise NotImplementedError(f"no reference for final_act={name!r}")


def gru_step(P, x, H, rnd):
    """One GRU step of the rows ``x`` from the states ``H``."""
    h = H.shape[1]
    vec = mm(x, P["Wx"], rnd) + P["Bh"]
    rz = torch.sigmoid(vec[:, h:] + mm(H, P["Wrz"], rnd))
    r, z = rz[:, :h], rz[:, h:]
    hbar = torch.tanh(mm(H * r, P["Wh"], rnd) + vec[:, :h])
    return (1.0 - z) * H + z * hbar


def bpr_max(y: torch.Tensor, bpreg: float) -> torch.Tensor:
    """BPR-max over rows whose positive sits on the diagonal: the sum over
    rows of ``-log sum_j s_j sigmoid(r_i - r_j) + bpreg sum_j s_j r_j^2``,
    ``s`` the softmax over the row's negatives."""
    m = y.shape[0]
    neg = torch.ones_like(y, dtype=torch.bool)
    neg[torch.arange(m), torch.arange(m)] = False
    pos = y.diagonal()[:, None]
    x = torch.where(neg, y, 0.0)
    e = torch.exp(x - x.amax(dim=1, keepdim=True)) * neg
    s = e / e.sum(dim=1, keepdim=True)
    per_row = (-torch.log((torch.sigmoid(pos - y) * s).sum(dim=1) + LOG_EPS)
               + bpreg * (y * y * s).sum(dim=1))
    return per_row.sum()


def cross_entropy(y: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of softmax outputs whose positive sits on the
    diagonal, summed over rows."""
    return -torch.log(y.diagonal() + LOG_EPS).sum()


class LaneWalk:
    """Session-parallel lanes: lane ``b`` starts with session ``b``; a lane
    whose session has no next click takes the next session in order (lanes
    that end at one step take them in lane order), and retires when none is
    left. :meth:`step` gives ``(inputs, targets, live, fresh)`` per lane,
    ``fresh`` marking a lane's first step in a session, or None when every
    lane has retired."""

    def __init__(self, items: np.ndarray, offsets: np.ndarray, batch: int):
        self.items, self.off = items, offsets
        self.n = len(offsets) - 1
        k = min(batch, self.n)
        self.sess = np.full(batch, -1, dtype=np.int64)
        self.sess[:k] = np.arange(k)
        self.pos = np.zeros(batch, dtype=np.int64)
        self.fresh = np.ones(batch, dtype=bool)
        self.next = k

    def step(self):
        live = self.sess >= 0
        if not live.any():
            return None
        s = self.sess[live]
        at = self.off[s] + self.pos[live]
        inputs = np.zeros(len(self.sess), dtype=np.int64)
        targets = np.zeros(len(self.sess), dtype=np.int64)
        inputs[live], targets[live] = self.items[at], self.items[at + 1]
        fresh = self.fresh & live
        self.fresh[:] = False
        self.pos[live] += 1
        for lane in np.flatnonzero(live):
            s = self.sess[lane]
            if self.off[s] + self.pos[lane] + 1 >= self.off[s + 1]:
                if self.next < self.n:
                    self.sess[lane], self.pos[lane] = self.next, 0
                    self.fresh[lane] = True
                    self.next += 1
                else:
                    self.sess[lane] = -1
        return inputs, targets, live, fresh


def count_steps(offsets: np.ndarray, batch: int) -> int:
    """Steps of the session-parallel walk of these sessions over ``batch``
    lanes."""
    walk = LaneWalk(np.zeros(int(offsets[-1]), dtype=np.int64), offsets, batch)
    n = 0
    while walk.step() is not None:
        n += 1
    return n


DENSE = ("Wx", "Wh", "Wrz", "Bh")


class Trainer:
    """The training step of a one-layer model with a constrained embedding
    (the input row of item ``i`` is ``Wy[i, :h]``), adagrad, optional
    momentum, optional dropout of the input and the hidden state, a loss
    over the batch's targets and the shared negatives (scores ``- logq *
    log p`` before the activation, ``p`` the target's count and a
    negative's count to the ``sample_alpha``), divided by the batch size.

    The item table's rows are updated only where the step touched them (a
    live lane's input or target, or a negative): the sum of the row's
    gradients enters adagrad, and the momentum of the table's rows is
    stored in ``opt_state_dtype`` (round to nearest) while the row moves by
    the unrounded value. The dense weights are updated in full."""

    def __init__(self, cfg: dict, params: dict, pop: np.ndarray, rnd, device):
        self.cfg = cfg
        self.rnd = rnd
        self.B = int(cfg["batch_size"])
        self.norm = self.B  # the cost is the loss over the batch size
        self.P = {k: v.detach().clone().to(device) for k, v in params.items()}
        self.h = self.P["Wh"].shape[0]
        self.lr, self.mom = float(cfg["learning_rate"]), float(cfg["momentum"])
        self.acc = {k: torch.zeros_like(self.P[k]) for k in (*DENSE, "Wy")}
        self.vel = {}
        if self.mom > 0:
            self.vel = {k: torch.zeros_like(self.P[k]) for k in DENSE}
            self.vel["Wy"] = torch.zeros_like(self.P["Wy"], dtype=getattr(
                torch, "bfloat16" if cfg["opt_state_dtype"] == "bfloat16" else "float32"))
        n_pad = self.P["Wy"].shape[0]
        logp = np.zeros(n_pad, dtype=np.float32)
        logp[:len(pop)] = np.log(np.maximum(pop, 1).astype(np.float64))
        self.logp = torch.from_numpy(logp).to(device)
        self.H = torch.zeros((self.B, self.h), device=device)
        self.device = device

    def step(self, inputs, targets, live, fresh, neg, gen):
        """One step; returns ``(cost, {leaf: gradient})``."""
        cfg, rnd, h, dev = self.cfg, self.rnd, self.h, self.device
        self.H[torch.from_numpy(fresh).to(dev)] = 0.0
        p_e, p_h = float(cfg["dropout_p_embed"]), float(cfg["dropout_p_hidden"])
        mask_e = (torch.rand((self.B, h), generator=gen, device=dev) < 1.0 - p_e
                  if p_e > 0 else None)
        mask_h = (torch.rand((self.B, h), generator=gen, device=dev) < 1.0 - p_h
                  if p_h > 0 else None)
        lanes = torch.from_numpy(np.flatnonzero(live)).to(dev)
        x_idx = torch.from_numpy(inputs[live]).to(dev)
        y_idx = torch.from_numpy(targets[live]).to(dev)
        neg = neg.to(dev).long()
        leaves = {k: self.P[k].detach().requires_grad_(True) for k in (*DENSE, "Wy")}
        Wy = leaves["Wy"]
        x = Wy[x_idx][:, :h]
        if mask_e is not None:
            x = torch.where(mask_e[lanes], x / (1.0 - p_e), 0.0)
        hn = gru_step(leaves, x, self.H[lanes], rnd)
        if mask_h is not None:
            hn = torch.where(mask_h[lanes], hn / (1.0 - p_h), 0.0)
        cols = torch.cat([y_idx, neg])
        S = Wy[cols]
        scores = mm(hn, S[:, :h].T, rnd) + S[:, h]
        if float(cfg["logq"]):
            scores = scores - float(cfg["logq"]) * torch.cat(
                [self.logp[y_idx], float(cfg["sample_alpha"]) * self.logp[neg]])
        y = final_activation(cfg["final_act"], scores)
        if cfg["loss"] == "bpr-max":
            loss = bpr_max(y, float(cfg["bpreg"]))
        elif cfg["loss"] == "cross-entropy":
            loss = cross_entropy(y)
        else:
            raise NotImplementedError(f"no reference for loss={cfg['loss']!r}")
        cost = loss / self.norm
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(cost, [leaves[k] for k in names])))
        with torch.no_grad():
            for k in DENSE:
                self._adagrad(self.P[k], grads[k], self.acc[k], self.vel.get(k))
            rows = torch.unique(torch.cat([x_idx, y_idx, neg]))
            self._adagrad_rows(rows, grads["Wy"][rows])
            self.H[lanes] = hn.detach()
        return float(cost.detach()), grads

    def _adagrad(self, p, g, acc, vel):
        acc += g * g
        upd = self.lr * (g / torch.sqrt(acc + ADAGRAD_EPS))
        if vel is None:
            p -= upd
        else:
            vel.mul_(self.mom).sub_(upd)
            p += vel

    def _adagrad_rows(self, rows, g):
        W, acc = self.P["Wy"], self.acc["Wy"]
        a = acc[rows] + g * g
        acc[rows] = a
        upd = self.lr * (g / torch.sqrt(a + ADAGRAD_EPS))
        if self.mom > 0:
            v = self.mom * self.vel["Wy"][rows].float() - upd
            self.vel["Wy"][rows] = v.to(self.vel["Wy"].dtype)
            W[rows] = W[rows] + v
        else:
            W[rows] = W[rows] - upd


def _session_states(P, items, offsets, lengths, rnd, block):
    """Hidden states after the first ``lengths[s]`` clicks of each session
    ``s`` (all sessions at once, ``block`` rows per product)."""
    h = P["Wh"].shape[0]
    H = torch.zeros((len(lengths), h), device=P["Wy"].device, dtype=P["Wy"].dtype)
    for p in range(int(lengths.max())):
        act = np.flatnonzero(lengths > p)
        for i in range(0, len(act), block):
            blk = act[i:i + block]
            idx = torch.from_numpy(items[offsets[blk] + p]).to(H.device)
            rows = torch.from_numpy(blk).to(H.device)
            H[rows] = gru_step(P, P["Wy"][idx][:, :h], H[rows], rnd)
    return H


def ranking_metrics(ranks, cutoffs):
    """Recall@c and MRR@c of per-event ranks: the share of events ranked
    within ``c``, and the mean of ``1 / rank`` over them (0 outside)."""
    ranks = np.asarray(ranks, dtype=np.float64)
    rec = [float(np.mean(ranks <= c)) for c in cutoffs]
    mrr = [float(np.mean(np.where(ranks <= c, 1.0 / ranks, 0.0))) for c in cutoffs]
    return rec, mrr


@torch.no_grad()
def event_ranks(P, items, offsets, n_items, final_act, rnd, block=1024):
    """The rank of every next click (each session's clicks but its last)
    among all ``n_items`` items by activated score: 1 + the items scored
    strictly higher."""
    h = P["Wh"].shape[0]
    dev = P["Wy"].device
    Wq = rnd(P["Wy"][:n_items, :h])
    bias = P["Wy"][:n_items, h]
    lens = np.diff(offsets)
    H = torch.zeros((len(lens), h), device=dev, dtype=P["Wy"].dtype)
    ranks = []
    for p in range(int(lens.max()) - 1):
        act = np.flatnonzero(lens > p + 1)
        for i in range(0, len(act), block):
            blk = act[i:i + block]
            rows = torch.from_numpy(blk).to(dev)
            x = P["Wy"][torch.from_numpy(items[offsets[blk] + p]).to(dev)][:, :h]
            hn = gru_step(P, x, H[rows], rnd)
            H[rows] = hn
            y = final_activation(final_act, rnd(hn) @ Wq.T + bias)
            tgt = torch.from_numpy(items[offsets[blk] + p + 1]).to(dev)
            t = y[torch.arange(len(blk), device=dev), tgt]
            ranks.append((1 + (y > t[:, None]).sum(dim=1)).cpu())
    return torch.cat(ranks).numpy()


def evaluate(P, items, offsets, n_items, cutoffs, final_act, rnd, block=1024):
    """Recall@c and MRR@c of next-click prediction over the whole catalog,
    and the number of events ranked."""
    ranks = event_ranks(P, items, offsets, n_items, final_act, rnd, block)
    rec, mrr = ranking_metrics(ranks, cutoffs)
    return rec, mrr, len(ranks)


@torch.no_grad()
def serve_scores(P, items, offsets, lengths, n_items, k, final_act, rnd, served_idx,
                 block=1024):
    """For each query ``q`` (session ``q``'s first ``lengths[q]`` clicks,
    ``items[offsets[q]:]``): the activated scores of the served items
    ``served_idx[q]``, and the ``k`` best activated scores over all
    ``n_items`` items, best first, with their items."""
    h = P["Wh"].shape[0]
    dev = P["Wy"].device
    H = _session_states(P, items, offsets, lengths, rnd, block)
    Wq = rnd(P["Wy"][:n_items, :h])
    bias = P["Wy"][:n_items, h]
    at, best, best_idx = [], [], []
    for i in range(0, len(lengths), block):
        y = final_activation(final_act, rnd(H[i:i + block]) @ Wq.T + bias)
        sel = torch.from_numpy(served_idx[i:i + block]).to(dev)
        at.append(torch.gather(y, 1, sel).cpu())
        top = torch.topk(y, k, dim=1, sorted=True)
        best.append(top.values.cpu())
        best_idx.append(top.indices.cpu())
    return torch.cat(at).numpy(), torch.cat(best).numpy(), torch.cat(best_idx).numpy()
