"""The five optimizers of GRU4Rec with dense and row-sparse paths.

PyTorch counterpart of ``gru4rec_tpu/train/optimizers.py`` (reference:
gru4rec.py:300-432: adagrad/rmsprop/adadelta/adam + plain SGD, each with a
dense path and a sampled-row path, plus Nesterov momentum, L2, and
global-norm clipping). The same two deliberate divergences from the
reference: duplicate row indices are summed first (deterministic dedup), and
adam is textbook adam.

Unlike the JAX package, updates happen IN PLACE: the parameter and state
tensors passed in are modified and returned, and no state entry is ever
rebound to a new tensor, so a captured CUDA graph of the training step
(``train/step.py``) goes on updating the buffers it recorded. Each in-place
form does the out-of-place expression's operations in the same order, so
the values are bit-identical to it. Every row-sparse update of a
CUDA tensor goes through the hand-written kernel
(``ops/kernels/sparse_update.py``); the torch-op path here
(:meth:`Optimizer.apply_sparse_plain`) is that kernel's plain version and
the CPU path.

``opt_state_dtype="bfloat16_sr"`` stores adagrad's accumulator and adam's
merged state of the item tables in bfloat16 with stochastic rounding
(``ops/sr.py``), as the JAX package does: the unrounded float32 state
drives the step's update, the rounded value is stored.
"""

from __future__ import annotations

from typing import Dict

import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.ops import sr
from gru4rec_tpu_torch.ops.kernels import sparse_update
from gru4rec_tpu_torch.ops.kernels.sparse_update import EPSILON
from gru4rec_tpu_torch.ops.kernels.sparse_update import log_decay as _ln

SENTINEL = 2**31 - 1


def dedup_rows(idx, g):
    """Sum gradients of duplicate row indices; static output shapes.

    Returns ``(uidx, g_sum)`` of the same length as ``idx``: position k holds
    the k-th distinct index and the sum of its gradient rows (summed in the
    order of a stable sort); unused tail positions hold the sentinel
    (int32 max) with zero gradient. Entries of ``idx`` already equal to the
    sentinel (masked lanes) sort to the tail and stay dropped. The sums
    are deterministic on every device.
    """
    n = idx.shape[0]
    sidx, order = torch.sort(idx.to(torch.int32), stable=True)
    sg = g[order]
    head = torch.ones(n, dtype=torch.bool, device=idx.device)
    head[1:] = sidx[1:] != sidx[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    g_sum = torch.zeros_like(g)
    if g.is_cuda:
        # index_add_ adds with atomics on the card, in no fixed order; the
        # sort-based accumulate adds each row's run in one fixed order, so
        # every call (eager or replayed) gives the same bits (not always
        # the CPU's, which adds in position order)
        g_sum.index_put_((seg,), sg, accumulate=True)
    else:
        g_sum.index_add_(0, seg, sg)
    uidx = torch.full((n,), SENTINEL, dtype=torch.int32, device=idx.device)
    uidx[seg] = sidx
    return uidx, g_sum


def _take_rows(table, uidx, fill=0.0):
    """Rows at ``uidx`` promoted to float32; sentinel (>= n_rows) rows read
    as ``fill``. Math always runs in float32; narrow state widens on read."""
    valid = uidx < table.shape[0]
    rows = table[torch.where(valid, uidx, 0).long()].float()
    return torch.where(valid.view((-1,) + (1,) * (rows.dim() - 1)), rows, fill)


def _put_rows(table, uidx, rows):
    """Counterpart of :func:`_take_rows`: rounds to the table's storage
    dtype and writes in place; sentinel rows are dropped.

    ``uidx`` is :func:`dedup_rows`' (distinct indices, the sentinel tail
    last). A sentinel lane writes the first lane's row again with the value
    that row gets, or row 0 its own value when no lane is valid, so the
    write has a static shape: no host-side count, which a captured step
    could not wait for."""
    valid = uidx < table.shape[0]
    rows = rows.to(table.dtype)
    head = torch.where(valid[:1], uidx[:1], 0).long()
    fill = torch.where(valid[:1].view((1,) + (1,) * (rows.dim() - 1)), rows[:1],
                       table.index_select(0, head))
    target = torch.where(valid, uidx.long(), head)
    table.index_put_((target,), torch.where(
        valid.view((-1,) + (1,) * (rows.dim() - 1)), rows, fill))
    return table


class Optimizer:
    """Optimizer bundle parameterized by the config."""

    def __init__(self, cfg: GRU4RecConfig):
        self.adapt = cfg.adapt
        self.lr = cfg.learning_rate
        self.momentum = cfg.momentum
        self.lmbd = cfg.lmbd
        self.grad_cap = cfg.grad_cap
        # "bfloat16_sr": bfloat16 also where the decay gate would force
        # float32 (adagrad's acc, adam's merged state), kept unbiased by
        # stochastic rounding; only the slots whose updates implement SR
        # narrow that way (init_state)
        self.state_sr = cfg.opt_state_dtype == "bfloat16_sr"
        self.sparse_state_dtype = (torch.bfloat16 if cfg.opt_state_dtype
                                   in ("bfloat16", "bfloat16_sr") else torch.float32)
        ap = cfg.adapt_params
        self.v1 = ap[0] if ap else 0.9
        self.v2 = ap[1] if len(ap) > 1 else 0.999
        # under SR, adam's first moment is rounded stochastically too when
        # its decay is slow enough to freeze under round-to-nearest
        self.sr_first_moment = self.adapt == "adam" and self.v1 > 0.99

    # ------------------------------------------------------------------ #
    def _ema_dtype(self, decay, param):
        """Storage dtype for sparse EMA state with the given decay constant.

        An EMA near steady state changes by ~(1-decay) relative per step;
        stored narrower than bfloat16's rounding threshold it silently
        freezes. Narrow storage is only allowed for decay <= 0.99; slower
        EMAs stay in the parameter dtype (gru4rec_tpu's _ema_dtype)."""
        if decay <= 0.99:
            return self.sparse_state_dtype
        return param.dtype

    def init_state(self, param, sparse: bool = False) -> Dict:
        """Fresh optimizer state for ``param``; the layouts are the JAX
        package's. Sparse (row-updated item-table) state may be narrow
        (``opt_state_dtype``); adagrad's monotone accumulator stays in the
        parameter dtype. Two-slot optimizers store sparse 2-D state merged:
        adadelta (n, 2d) = [acc | upd]; adam (n, 2d + 128) = [acc | meang |
        count block], whose 128 lanes all hold the per-row step count.
        Under ``bfloat16_sr`` a sparse 2-D adagrad ``acc`` and adam ``acc2``
        are bfloat16; adam's count block then holds the count as base-256
        limbs in lanes 0..2 and zeros in lanes 3..127."""
        def zeros(dtype):
            return torch.zeros(param.shape, dtype=dtype, device=param.device)

        def ema(decay):
            return self._ema_dtype(decay, param) if sparse else param.dtype

        two_slot = self.adapt in ("adam", "adadelta")
        merged = sparse and two_slot and param.dim() == 2
        narrow_sr = self.state_sr and sparse and param.dim() == 2
        st: Dict = {}
        if self.adapt == "adagrad":
            st["acc"] = zeros(torch.bfloat16 if narrow_sr else param.dtype)
        elif self.adapt == "rmsprop":
            st["acc"] = zeros(ema(self.v1))
        elif merged and self.adapt == "adadelta":
            st["acc2"] = torch.zeros((param.shape[0], 2 * param.shape[1]),
                                     dtype=ema(self.v1), device=param.device)
        elif merged:  # adam: [acc | meang | count-column block]
            st["acc2"] = torch.zeros((param.shape[0], 2 * param.shape[1] + 128),
                                     dtype=torch.bfloat16 if narrow_sr else torch.float32,
                                     device=param.device)
        elif self.adapt == "adadelta":
            st["acc"] = zeros(ema(self.v1))
            st["upd"] = zeros(ema(self.v1))
        elif self.adapt == "adam":
            st["acc"] = zeros(ema(self.v2))
            st["meang"] = zeros(ema(self.v1))
        if self.adapt == "adam" and not merged:
            st["count"] = torch.zeros(param.shape[:1], dtype=torch.float32,
                                      device=param.device)
        if self.momentum > 0:
            st["velocity"] = zeros(ema(self.momentum))
        return st

    # ------------------------------------------------------------------ #
    def _adapt_dense(self, g, st):
        """Dense adaptation, the state updated in place: ``v * s + (1 - v)
        * x`` as ``s.mul_(v).add_((1 - v) * x)``, the same two roundings."""
        a = self.adapt
        if a == "adagrad":
            acc = st["acc"].add_(g**2)
            return g / torch.sqrt(acc + EPSILON)
        if a == "rmsprop":
            acc = st["acc"].mul_(self.v1).add_((1.0 - self.v1) * g**2)
            return g / torch.sqrt(acc + EPSILON)
        if a == "adadelta":
            acc = st["acc"].mul_(self.v1).add_((1.0 - self.v1) * g**2)
            scaling = (st["upd"] + EPSILON) / (acc + EPSILON)
            st["upd"].mul_(self.v1).add_((1.0 - self.v1) * scaling * g**2)
            return g * torch.sqrt(scaling)
        if a == "adam":
            acc = st["acc"].mul_(self.v2).add_((1.0 - self.v2) * g**2)
            meang = st["meang"].mul_(self.v1).add_((1.0 - self.v1) * g)
            count = st["count"].add_(1.0)
            t = count if count.dim() == 0 else count[0]
            # 1 - v^t as -expm1(t ln v): the naive form cancels
            # catastrophically when v^t ~ 1 (v2=0.999, small t)
            mhat = meang / -torch.expm1(t * _ln(self.v1))
            vhat = acc / -torch.expm1(t * _ln(self.v2))
            return mhat / (torch.sqrt(vhat) + EPSILON)
        return g  # plain SGD

    def sr_active(self, st) -> bool:
        """Whether this sparse state is stored with stochastic rounding."""
        if not self.state_sr:
            return False
        if self.adapt == "adagrad":
            return st["acc"].dtype == torch.bfloat16
        return (self.adapt == "adam" and "acc2" in st
                and st["acc2"].dtype == torch.bfloat16)

    def _adapt_sparse(self, uidx, g, st, sr_seed=None):
        """Row-sparse adaptation; ``uidx`` is deduped with a sentinel tail.
        Writes the state rows in place and returns the scaled gradient.
        ``sr_seed`` = (seed, global row offset) keys the dither of the
        stochastically rounded slots (see :meth:`apply_sparse`)."""
        a = self.adapt
        sr_on = sr_seed is not None

        def sr_store(rows, col_offset=0):
            bits = sr.sr_bits16(sr_seed[0], uidx.to(torch.int64) + sr_seed[1],
                                rows.shape[1], col_offset=col_offset)
            return sr.sr_round_bf16(rows, bits)

        if a == "adagrad":
            rows = _take_rows(st["acc"], uidx) + g**2
            _put_rows(st["acc"], uidx, sr_store(rows) if sr_on else rows)
            return g / torch.sqrt(rows + EPSILON)
        if a == "rmsprop":
            rows = self.v1 * _take_rows(st["acc"], uidx) + (1.0 - self.v1) * g**2
            _put_rows(st["acc"], uidx, rows)
            return g / torch.sqrt(rows + EPSILON)
        if a == "adadelta":
            if "acc2" in st:  # merged [acc | upd] layout (see init_state)
                d = g.shape[1]
                au = _take_rows(st["acc2"], uidx)
                acc_old, upd_rows_old = au[:, :d], au[:, d:]
            else:
                acc_old = _take_rows(st["acc"], uidx)
                upd_rows_old = _take_rows(st["upd"], uidx)
            acc_rows = self.v1 * acc_old + (1.0 - self.v1) * g**2
            scaling = (upd_rows_old + EPSILON) / (acc_rows + EPSILON)
            upd_rows = self.v1 * upd_rows_old + (1.0 - self.v1) * scaling * g**2
            if "acc2" in st:
                _put_rows(st["acc2"], uidx, torch.cat([acc_rows, upd_rows], dim=1))
            else:
                _put_rows(st["acc"], uidx, acc_rows)
                _put_rows(st["upd"], uidx, upd_rows)
            return g * torch.sqrt(scaling)
        if a == "adam":
            if "acc2" in st:  # merged [acc | meang | count-column block]
                d = g.shape[1]
                W = st["acc2"].shape[1]
                am = _take_rows(st["acc2"], uidx)
                acc_old, meang_old = am[:, :d], am[:, d:2 * d]
                if sr_on:  # the count as base-256 limbs in lanes 0..2
                    cnt = sr.limbs_decode(am[:, 2 * d], am[:, 2 * d + 1],
                                          am[:, 2 * d + 2]) + 1.0
                else:
                    cnt = am[:, 2 * d] + 1.0
            else:
                acc_old = _take_rows(st["acc"], uidx)
                meang_old = _take_rows(st["meang"], uidx)
                cnt = _take_rows(st["count"], uidx) + 1.0
            acc_rows = self.v2 * acc_old + (1.0 - self.v2) * g**2
            meang_rows = self.v1 * meang_old + (1.0 - self.v1) * g
            corr1 = -torch.expm1(cnt * _ln(self.v1))
            corr2 = -torch.expm1(cnt * _ln(self.v2))
            if g.dim() > 1:
                corr1 = corr1[:, None]
                corr2 = corr2[:, None]
            if sr_on:
                # second moment SR; first moment SR (on its own buffer
                # columns) only for a slow v1 that round-to-nearest would
                # freeze; limbs in lanes 0..2, zeros in the rest
                lo, mid, hi = sr.limbs_encode(cnt[:, None])
                cnt_block = torch.cat(
                    [lo, mid, hi, torch.zeros((cnt.shape[0], W - 2 * d - 3),
                                              device=cnt.device)], dim=1)
                meang_stored = (sr_store(meang_rows, col_offset=d) if self.sr_first_moment
                                else meang_rows.to(torch.bfloat16))
                _put_rows(st["acc2"], uidx,
                          torch.cat([sr_store(acc_rows), meang_stored,
                                     cnt_block.to(torch.bfloat16)], dim=1))
            elif "acc2" in st:
                # the count fills ALL lanes of its block
                cnt_block = cnt[:, None].expand(cnt.shape[0], W - 2 * d)
                _put_rows(st["acc2"], uidx,
                          torch.cat([acc_rows, meang_rows, cnt_block], dim=1))
            else:
                _put_rows(st["acc"], uidx, acc_rows)
                _put_rows(st["meang"], uidx, meang_rows)
                _put_rows(st["count"], uidx, cnt)
            return (meang_rows / corr1) / (torch.sqrt(acc_rows / corr2) + EPSILON)
        return g

    # ------------------------------------------------------------------ #
    def apply_dense(self, p, g, st):
        """Update dense parameter ``p`` in place with gradient ``g``."""
        g = self._adapt_dense(g, st)
        if self.momentum > 0:
            vel = st["velocity"].mul_(self.momentum).sub_(self.lr * (g + self.lmbd * p))
            p.add_(vel)
        else:
            p.copy_(p * (1.0 - self.lr * self.lmbd) - self.lr * g)
        return p, st

    def sr_seed_for(self, st, sr_seed):
        """``sr_seed`` = (seed, row_offset) when ``st`` is stored with
        stochastic rounding, else None: the offset an int, the seed an int
        or a 0-d int32 tensor (a step's seed on the device, which is never
        read back to the host); SR state without a seed raises, as in the
        JAX package."""
        if not self.sr_active(st):
            return None
        if sr_seed is None:
            raise ValueError("opt_state_dtype='bfloat16_sr' requires a per-step "
                             "seed (sr_seed) for the stochastic-rounding dither")
        seed, offset = sr_seed
        return (seed if torch.is_tensor(seed) else int(seed)), int(offset)

    def apply_sparse(self, table, idx, g, st, sr_seed=None):
        """Update ``table`` rows at (possibly duplicated / sentinel-masked)
        ``idx`` in place. With an adaptive optimizer this is the fused
        row-sparse kernel on the card and its plain version on the CPU;
        plain SGD keeps the torch-op path (no state to fuse).

        ``sr_seed`` = (seed, global row offset) keys the
        stochastic-rounding dither (the seed an int or a 0-d int32 tensor,
        :meth:`sr_seed_for`) of ``bfloat16_sr`` state: the dither
        hashes (seed, row_offset + row, column), so kernel, plain version
        and the JAX package store bit-identical state for the same seed."""
        if self.adapt is None:
            return self.apply_sparse_plain(table, idx, g, st)
        return sparse_update.fused_update(self, table, idx, g, st, sr_seed=sr_seed)

    def apply_sparse_plain(self, table, idx, g, st, sr_seed=None):
        """The torch-op row-sparse update: dedup, adapt, momentum, L2 — the
        fused kernel's plain version (gru4rec_tpu's XLA path)."""
        sr_seed = self.sr_seed_for(st, sr_seed)
        uidx, g = dedup_rows(idx, g)
        g = self._adapt_sparse(uidx, g, st, sr_seed)
        if self.lmbd > 0:
            delta = self.lr * (g + self.lmbd * _take_rows(table, uidx))
        else:
            delta = self.lr * g
        if self.momentum > 0:
            v2 = self.momentum * _take_rows(st["velocity"], uidx) - delta
            _put_rows(st["velocity"], uidx, v2)
            new_rows = _take_rows(table, uidx) + v2
        else:
            new_rows = _take_rows(table, uidx) - delta
        _put_rows(table, uidx, new_rows)
        return table, st

    # ------------------------------------------------------------------ #
    def clip_by_global_norm(self, dense_grads, sparse_grads):
        """Global-norm gradient clipping over all grads (gru4rec.py:386-389);
        both arguments are lists of tensors, scaled in place."""
        if self.grad_cap <= 0:
            return dense_grads, sparse_grads
        grads = list(dense_grads) + list(sparse_grads)
        norm = torch.sqrt(sum(torch.sum(g**2) for g in grads))
        scale = torch.where(norm >= self.grad_cap, self.grad_cap / norm, 1.0)
        for g in grads:
            g.mul_(scale)
        return dense_grads, sparse_grads


def make_optimizer(cfg: GRU4RecConfig) -> Optimizer:
    return Optimizer(cfg)
