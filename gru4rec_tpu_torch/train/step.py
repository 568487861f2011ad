"""The training step and the chunk runner.

PyTorch counterpart of ``gru4rec_tpu/train/step.py``. The JAX package runs
a chunk of ``cfg.chunk_size`` steps as one device program (``lax.scan``
over the steps, the state donated as carry). Its counterpart here is a
CUDA graph: on a CUDA device one training step is captured once per chunk
function (once per ``fit`` call; the step's shapes are fixed) and replayed
once per step that has a live lane, so the host issues a copy and a graph
launch per step instead of the step's few hundred launches
(:class:`_StepRunner`, a ``utils/cuda_graph.py::ReplayLoop``). The scan's
per-step inputs are one packed int32 stack per chunk (:class:`StackLayout`),
uploaded once; negatives for the whole chunk are drawn in one call, as
there. The eager loop over the same
step, the same runner uncaptured, is the graph's plain version: the CPU
runs it, and on a card it is reached only through ``make_chunk_fn(...,
_eager=True)``.

Gradients w.r.t. the item tables stay row-sparse: the gathered rows are
leaf tensors that autograd differentiates (the reference's sampled-params
gradients, gru4rec.py:384), so no dense (n_items, d) gradient is ever formed;
they are applied with the fused row-sparse update
(``ops/kernels/sparse_update.py``). Parameters and optimizer state are
updated in place.

Under ``opt_state_dtype="bfloat16_sr"`` each sparse table's update gets its
own stochastic-rounding seed per step, ``ops.sr.step_seed(cfg.seed, step,
SR_TABLE_SALT[table])``: computed on the host for the whole chunk
(``ops.sr.step_seeds``), carried in the stack, and read by the kernel on
the device, so a replayed step uses its own seed and a resumed run
reproduces every seed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.ops.losses import get_loss
from gru4rec_tpu_torch.ops.sr import MASK32, step_seeds
from gru4rec_tpu_torch.ops.sampling import draw_negatives
from gru4rec_tpu_torch.train.optimizers import SENTINEL, make_optimizer
from gru4rec_tpu_torch.utils.cuda_graph import WARMUP_STEPS, ReplayLoop, binding
from gru4rec_tpu_torch.utils.profiling import Pace, span

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
    # the epoch's pace counters (utils/profiling.py), set by fit; the chunk
    # functions count into them when set
    pace: Optional[Pace] = None


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


class StackLayout:
    """The columns of a chunk's packed int32 step stack, one row per step:
    ``in | out | valid | reset | neg | sr seeds`` (B, B, B, B, n_sample and
    one seed per sparse table under ``bfloat16_sr``). The JAX scan's ``xs``;
    a replayed step reads its row from the graph's input slot."""

    def __init__(self, batch_size: int, n_sample: int, seed_names=()):
        self.B = batch_size
        self.n_sample = n_sample
        self.seed_names = tuple(seed_names)
        self.width = 4 * batch_size + n_sample + len(self.seed_names)

    def pack(self, in_c, out_c, valid_c, reset_c, neg, seeds, device) -> torch.Tensor:
        """The (chunk, width) stack on ``device``: the schedule slices and
        the seeds (``{name: (chunk,) ints}``) in one host array and one
        upload, the negatives ((chunk, n_sample), any device) joined on
        ``device``."""
        chunk = in_c.shape[0]
        host = np.empty((chunk, 4 * self.B + len(self.seed_names)), dtype=np.int32)
        for i, a in enumerate((in_c, out_c, valid_c, reset_c)):
            host[:, i * self.B:(i + 1) * self.B] = a
        for i, name in enumerate(self.seed_names):
            v = np.asarray(seeds[name], dtype=np.int64) & MASK32
            host[:, 4 * self.B + i] = v.astype(np.uint32).view(np.int32)
        stack = torch.from_numpy(host).to(device)
        if self.n_sample == 0:
            return stack
        neg = torch.as_tensor(neg).to(device=device, dtype=torch.int32)
        return torch.cat([stack[:, :4 * self.B], neg, stack[:, 4 * self.B:]], dim=1)

    def split(self, row: torch.Tensor):
        """Views of one step's row: ``(in, out, valid, reset, neg, seeds)``,
        ``valid`` and ``reset`` as bool, ``neg`` None without negatives and
        ``seeds`` ({name: 0-d int32 view}) None without seeds."""
        B, o = self.B, 4 * self.B
        neg = row[o:o + self.n_sample] if self.n_sample > 0 else None
        o += self.n_sample
        seeds = {name: row[o + i] for i, name in enumerate(self.seed_names)}
        return (row[:B], row[B:2 * B], row[2 * B:3 * B] != 0, row[3 * B:4 * B] != 0,
                neg, seeds or None)


class _StepRunner(ReplayLoop):
    """A chunk function's training steps (``chunk_fn.runner``), on the first
    chunk's device, captured there where ``may_capture`` and it is a CUDA
    device. Each step adds its weighted loss to the device scalar ``loss``.
    The graph reads and writes the state's tensors in place and draws its
    dropout masks from ``state.gen``, registered with it (the generator's
    offset advances by the step's draws per replay, so every replay draws
    the eager step's masks). A chunk whose state tensors or generator are
    not the captured ones raises. The warm-up is the span
    ``gru4rec.train.warmup``; a replay opens none, and adds the captured
    step's launches (``graph.tally``) to the launch counters.
    """

    def __init__(self, step_fn, width: int, may_capture: bool):
        super().__init__(WARMUP_STEPS, warmup_span="gru4rec.train.warmup")
        self.step_fn = step_fn
        self.width = width
        self.may_capture = may_capture
        self.loss = None

    def fn(self, row, state: TrainState, logp0):
        return self.loss.add_(self.step_fn(state, row, logp0))

    def start(self, state: TrainState, logp0) -> None:
        """Ready the runner for a chunk of ``state``: placed on its device at
        the first chunk, the binding checked once captured, the loss
        zeroed."""
        if self.slot is None:
            dev = state.params["Wy"].device
            self.place(torch.zeros(self.width, dtype=torch.int32, device=dev),
                       self.may_capture and dev.type == "cuda")
            self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        if self.stream is not None:
            bound = binding(logp0, state.H, state.params, state.opt_state, state.gen)
            if self.graph is None:
                self.bound, self.generators = bound, (state.gen,)
            elif bound != self.bound:
                raise RuntimeError("the training state's tensors are not the ones the step "
                                   "graph was captured on: rebind them before the first "
                                   "chunk, or update them in place")
        self.loss.zero_()


def run_steps(runner: _StepRunner, state: TrainState, stack, counts, logp0) -> torch.Tensor:
    """The live steps of a chunk (``counts`` > 0; a fully-padded step is a
    no-op, the JAX package's ``any_valid`` gate: no update of any parameter
    or optimizer state) by ``runner``, in the spans
    ``gru4rec.train.steps`` and ``gru4rec.train.loss`` (the read of the
    chunk's loss sum, a device scalar, which it returns); counted into
    ``state.pace`` when set (``issue``, and on a CUDA device the chunk's
    timing events)."""
    rows = np.flatnonzero(counts > 0).tolist()
    pace = state.pace
    with span("gru4rec.train.steps"):
        if pace is not None:
            pace.begin_steps()
        runner.start(state, logp0)
        runner.run(stack, state, logp0, order=rows[:-1])
        if pace is not None:
            pace.before_last_step()
        runner.run(stack, state, logp0, order=rows[-1:])
        if pace is not None:
            pace.end_steps()
    with span("gru4rec.train.loss"):
        return runner.loss.clone()


def build_chunk_fn(cfg: GRU4RecConfig, n_items: int, layout: StackLayout, step_fn,
                   may_capture: bool, lanes=slice(None)):
    """The chunk function of :func:`make_chunk_fn` and, on a mesh,
    ``parallel/dist_step.py::make_dist_chunk_fn`` around their
    ``step_fn(state, row, logp0)``: the chunk's negative draw, its SR
    seeds, one upload of the stack with the schedule's lanes ``lanes``, the
    live-step gate and :func:`run_steps` on one :class:`_StepRunner`. The
    gate reads the whole (global) schedule, so the ranks of a mesh replay or
    skip each step together. ``chunk_fn.runner`` is the runner where
    ``may_capture``, else None."""
    runner = _StepRunner(step_fn, layout.width, may_capture)

    def chunk_fn(state: TrainState, in_c, out_c, valid_c, reset_c, samp1,
                 logp0, neg=None, sr_seeds=None):
        chunk = in_c.shape[0]
        dev = state.params["Wy"].device
        pace = state.pace
        with span("gru4rec.train.chunk"):
            if layout.n_sample > 0 and neg is None:
                since = time.perf_counter()
                with span("gru4rec.train.sample"):
                    neg = draw_negatives(state.gen, samp1, chunk, layout.n_sample, n_items,
                                         cfg.sample_alpha, cfg.sampler)
                if pace is not None:
                    pace.add("sample", since)
            seeds = None
            if layout.seed_names:
                seeds = sr_seeds if sr_seeds is not None else {
                    k: step_seeds(cfg.seed, np.arange(state.step, state.step + chunk),
                                  SR_TABLE_SALT[k]) for k in layout.seed_names}
            # one upload per chunk; a blocking copy per step would drain the
            # stream every step
            since = time.perf_counter()
            with span("gru4rec.train.upload"):
                stack = layout.pack(*(a[:, lanes] for a in (in_c, out_c, valid_c, reset_c)),
                                    neg, seeds, dev)
            if pace is not None:
                pace.add("upload", since)
            counts = valid_c.sum(axis=1)
            loss = run_steps(runner, state, stack, counts, logp0)
            state.step += chunk
            return loss, int(counts.sum())

    chunk_fn.runner = runner if may_capture else None
    return chunk_fn


def make_chunk_fn(cfg: GRU4RecConfig, n_items: int, _eager: bool = False):
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

    On a CUDA device the steps replay one captured step (:class:`_StepRunner`,
    ``chunk_fn.runner``); the state's tensors must stay the same from the
    first chunk on. ``_eager=True`` runs the same runner uncaptured there
    instead, the graph's plain version (``chunk_fn.runner`` is then None),
    as the CPU always does.

    A call is the span ``gru4rec.train.chunk``, with the children
    ``gru4rec.train.sample`` (the negative draw), ``.upload`` (the stack),
    ``.steps`` and ``.loss`` (:func:`run_steps`); ``state.pace``, when set,
    counts the host seconds of the first two. Each step that runs eagerly,
    and the captured step once, opens ``gru4rec.train.sparse_update.<table>``
    around each item table's row update (``Wx0``, ``E``, ``Wy``); a replay
    opens none.
    """
    mode = gru.input_mode(cfg)
    loss_fn = get_loss(cfg.loss, cfg.n_sample, cfg.smoothing, cfg.bpreg)
    opt = make_optimizer(cfg)
    B = cfg.batch_size
    n_sample = cfg.n_sample
    use_logq = bool(cfg.logq)
    sparse_names = sparse_table_names(mode)
    layout = StackLayout(B, n_sample, sparse_names if opt.state_sr else ())

    def step_fn(state, row, logp0):
        in_d, out_d, valid_d, reset_d, neg_t, seeds = layout.split(row)
        params, opt_state = state.params, state.opt_state
        dev = params["Wy"].device
        Mf = valid_d.sum(dtype=torch.float32)
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
                with span(f"gru4rec.train.sparse_update.{sname}"):
                    opt.apply_sparse(_sparse_table(params, sname), scatter_idx[name],
                                     g, opt_state["sparse"][sname],
                                     sr_seed=None if seeds is None else (seeds[sname], 0))
            for h, hn, ho in zip(state.H, H_new, H):
                h.copy_(torch.where(valid_d[:, None], hn.detach(), ho))
        return cost.detach() * Mf

    return build_chunk_fn(cfg, n_items, layout, step_fn, not _eager)
