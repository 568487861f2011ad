"""The training step over the (data, model) mesh, and the state's layout.

PyTorch counterpart of ``gru4rec_tpu/parallel/dist_step.py``. Every rank
runs the same program on its share (``parallel/mesh.py``):

* lanes are split over ``data``: a rank runs its block of lanes through the
  GRU and scores it against the *global* target set (within-batch negatives
  couple the lanes), so each step all-gathers the lanes' validity, targets
  and inputs over ``data`` (one small int32 collective);
* the item tables are row-sharded over ``model``: a row gather is a
  shard-local take (rows of other shards read as 0) summed over ``model``
  (:func:`make_row_gather`); a row update is ``Optimizer.apply_sparse`` on
  the local shard, i.e. the row-sparse kernel (K1-K4,
  ``ops/kernels/sparse_update.py``), with the indices mapped to local rows
  (rows of other shards become the sentinel, which the kernel drops) and
  ``sr_seed=(seed, r0)``, so a sharded stochastically rounded update
  rounds each cell as the whole table's update does;
* gradients are taken with respect to the gathered rows (after the
  collective) and the dense leaves, so no collective sits inside the
  differentiated function; the dense gradients, the target rows' gradients
  and the loss are summed over ``data`` in one collective, the input rows'
  gradients all-gathered; then the global-norm clip and the dense updates
  run redundantly on every rank;
* each rank's loss block puts its positives on the diagonal shifted by
  ``di * B_local`` (``ops/losses.py``'s ``diag_offset``).

Random streams: every rank keeps ``state.gen`` in lockstep. The negatives
are one draw on every rank, and the dropout masks are drawn for the whole
batch, each rank keeping its lanes' rows (``models/gru.py``
``dropout_lanes``). So a run on any mesh follows the single-device run's
draws, and a 1 x 1 mesh repeats it bit for bit; no rank has a seed of its
own.

A fully padded step is skipped on the host, as in ``train/step.py``; the
gate reads the global schedule, which every rank holds, so a rank whose own
lanes are all padding still joins the step's collectives.

The JAX package compiles a chunk into one program (``jax.jit`` of
``shard_map`` over ``lax.scan``). Its counterpart on an NCCL mesh is the
single-device one: the step, collectives included, captured once as a CUDA
graph and replayed per live step (:func:`make_dist_chunk_fn`); gloo's
collectives cannot be captured, so a gloo mesh runs the same step eagerly.

The JAX package appends ``SCRATCH_ROWS`` (8) zero rows to every row-shard
because its Pallas grid parks padded grid steps there. The port's kernel
dedups the indices in its own pass and parks nothing, so a shard here is
exactly ``n_pad // n_model`` rows, and :func:`detect_scratch_layout`
accepts the canonical row count only.
"""

from __future__ import annotations

import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.ops.losses import get_loss
from gru4rec_tpu_torch.parallel.mesh import Mesh, local_block, param_specs, state_specs
from gru4rec_tpu_torch.train.optimizers import SENTINEL, make_optimizer
from gru4rec_tpu_torch.train.step import (DENSE_GROUPS, StackLayout, TrainState,
                                          build_chunk_fn, merge_dense, split_params,
                                          sparse_table_names)


def check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a gru4rec_tpu_torch.parallel.Mesh "
                        f"(parallel.make_mesh), got {type(mesh).__name__}")
    return mesh


def _map_specs(tree, specs, sharded, replicated):
    """``tree`` with ``sharded`` applied to the leaves whose spec is
    ``"model"`` and ``replicated`` to the others."""
    if isinstance(specs, dict):
        return {k: _map_specs(tree[k], s, sharded, replicated) for k, s in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(t, s, sharded, replicated) for t, s in zip(tree, specs)]
    return sharded(tree) if specs == "model" else replicated(tree)


def _generator_on(gen: torch.Generator, device: torch.device) -> torch.Generator:
    """``gen``, or a generator on ``device`` that continues its stream."""
    if gen.device == device:
        return gen
    if gen.device.type != device.type:
        raise ValueError(f"a {gen.device.type} generator cannot continue on {device}")
    out = torch.Generator(device=device)
    out.set_state(gen.get_state())
    return out


def shard_params(params, cfg: GRU4RecConfig, mesh: Mesh):
    """This rank's parameters from the canonical (host) ones: its row-shard
    of each item table, a copy of every other leaf, on ``mesh.device``."""
    dev, nm = mesh.device, mesh.shape["model"]
    return _map_specs(params, param_specs(params, gru.input_mode(cfg)),
                      lambda t: local_block(t, nm, mesh.mi, dev),
                      lambda t: t.to(dev, copy=True))


def shard_train_state(state: TrainState, cfg: GRU4RecConfig, mesh: Mesh) -> TrainState:
    """This rank's training state from a canonical one: the parameters and
    optimizer state as :func:`shard_params` lays them out, and its lane
    block of the hidden state."""
    dev, nm = mesh.device, mesh.shape["model"]
    lo, n = mesh.lanes(cfg.batch_size)
    opt_state = _map_specs(state.opt_state, state_specs(state.opt_state),
                           lambda t: local_block(t, nm, mesh.mi, dev),
                           lambda t: t.to(dev, copy=True))
    return TrainState(shard_params(state.params, cfg, mesh), opt_state,
                      [h[lo:lo + n].to(dev, copy=True) for h in state.H],
                      _generator_on(state.gen, dev), state.step)


def unshard_params(params, cfg: GRU4RecConfig, mesh: Mesh):
    """The canonical parameters as CPU tensors on every rank, gathered one
    shard at a time (no device holds a whole item table)."""
    return _map_specs(params, param_specs(params, gru.input_mode(cfg)),
                      lambda t: mesh.fetch_to_host(t, "model"),
                      lambda t: t.to("cpu", copy=True))


def unshard_train_state(state: TrainState, cfg: GRU4RecConfig, mesh: Mesh) -> TrainState:
    """The canonical training state on every rank: parameters, optimizer
    state and the whole batch's hidden state as CPU tensors; the generator
    and step as they are (identical on every rank)."""
    opt_state = _map_specs(state.opt_state, state_specs(state.opt_state),
                           lambda t: mesh.fetch_to_host(t, "model"),
                           lambda t: t.to("cpu", copy=True))
    return TrainState(unshard_params(state.params, cfg, mesh), opt_state,
                      [mesh.fetch_to_host(h, "data") for h in state.H],
                      state.gen, state.step)


def detect_scratch_layout(params, n_items: int, cfg: GRU4RecConfig, mesh: Mesh) -> int:
    """0 if ``params`` are in the canonical layout; raises on any other row
    count. (JAX also accepts its training layout with per-shard scratch
    rows, which the port does not have; module doc.) Shared by the mesh
    evaluation and serving entry points."""
    n_pad = gru.pad_items(n_items, cfg.item_pad_multiple)
    wy_rows = int(params["Wy"].shape[0])
    if wy_rows != n_pad:
        raise ValueError(f"Wy has {wy_rows} rows; expected {n_pad} (canonical)")
    if n_pad % mesh.shape["model"]:
        raise ValueError(f"padded item count {n_pad} must divide over model axis "
                         f"{mesh.shape['model']}; adjust item_pad_multiple or the "
                         f"mesh shape")
    return 0


def make_row_gather(r0: int, rows_local: int, mesh: Mesh):
    """Shard-local row gather summed over the ``model`` axis: rows at
    global indices ``idx``; a shard reads the rows it owns and 0 for the
    others, so the sum is exact. One definition serves the train, eval and
    serving steps."""

    def gather_rows(shard, idx):
        owned = (idx >= r0) & (idx < r0 + rows_local)
        rows = torch.where(owned[:, None], shard[torch.where(owned, idx - r0, 0)], 0.0)
        return mesh.all_reduce(rows, "model")

    return gather_rows


def make_dist_chunk_fn(cfg: GRU4RecConfig, n_items: int, mesh: Mesh, _eager: bool = False):
    """The per-chunk training function on ``mesh``: the contract of
    ``train/step.py::make_chunk_fn`` (``chunk_fn(state, in_c, out_c,
    valid_c, reset_c, samp1, logp0, neg=None, sr_seeds=None) ->
    (loss_weighted_sum, event_count)``), with ``state`` this rank's sharded
    state (:func:`shard_train_state`) and the ``*_c`` the global (chunk, B)
    host schedule. Every rank returns the global loss sum and event count.

    The chunk is the single-device one (``train/step.py::build_chunk_fn``:
    its spans, pace counters, runner and ``chunk_fn.runner``) with the
    rank's lane block of the schedule in the stack (JAX's ``sched_spec =
    P(None, "data")``) and this step, whose live count ``Mf`` is the
    gathered lanes' validity summed on the device. On a capturable mesh
    (NCCL, ``Mesh.capturable``) the step is captured with its collectives;
    a gloo mesh, like ``_eager=True``, runs it uncaptured."""
    check_mesh(mesh)
    mode = gru.input_mode(cfg)
    loss_fn = get_loss(cfg.loss, cfg.n_sample, cfg.smoothing, cfg.bpreg)
    opt = make_optimizer(cfg)
    B = cfg.batch_size
    n_sample = cfg.n_sample
    use_logq = bool(cfg.logq)
    lo, bl = mesh.lanes(B)
    layout = StackLayout(bl, n_sample, sparse_table_names(mode) if opt.state_sr else ())

    def step_fn(state, row, logp0):
        in_l, out_l, valid_l, reset_l, neg_t, seeds = layout.split(row)
        params, opt_state = state.params, state.opt_state
        dev = params["Wy"].device
        rows_local = params["Wy"].shape[0]
        r0 = mesh.mi * rows_local
        gather_rows = make_row_gather(r0, rows_local, mesh)

        lanes = mesh.all_gather(torch.stack([valid_l.to(torch.int32), out_l, in_l], dim=1),
                                "data")
        valid_all, out_all, in_all = lanes[:, 0].bool(), lanes[:, 1], lanes[:, 2]
        Mf = valid_all.sum(dtype=torch.float32)  # the step's global live count
        if n_sample > 0:
            col_valid = torch.cat([valid_all, torch.ones(n_sample, dtype=torch.bool, device=dev)])
            Y = torch.cat([torch.where(valid_all, out_all, 0), neg_t])
            Y_scatter = torch.cat([torch.where(valid_all, out_all, SENTINEL), neg_t])
        else:
            col_valid = valid_all
            Y = torch.where(valid_all, out_all, 0)
            Y_scatter = torch.where(valid_all, out_all, SENTINEL)
        Xg = torch.where(valid_l, in_l, 0)
        X_scatter_all = torch.where(valid_all, in_all, SENTINEL)

        H = [torch.where(reset_l[:, None], 0.0, h) for h in state.H]

        def leaf(rows):
            return rows.detach().requires_grad_(True)

        if mode == "onehot":
            xname = "Wx0"
            srows = {"Wx0": leaf(gather_rows(params["Wx"][0], Xg)),
                     "Wy": leaf(gather_rows(params["Wy"], Y))}
        elif mode == "embedding":
            xname = "E"
            srows = {"E": leaf(gather_rows(params["E"], Xg)),
                     "Wy": leaf(gather_rows(params["Wy"], Y))}
        else:  # constrained: one gather of the inputs' and the targets' rows
            srows = {"WyS": leaf(gather_rows(params["Wy"], torch.cat([Xg, Y])))}

        logq_corr = None
        if use_logq:
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
            merge_dense(params, dense_leaves, mode), srows, H, cfg, M=bl,
            training=True, gen=state.gen, col_valid=col_valid,
            logq_correction=logq_corr, dropout_lanes=(lo, B),
        )
        cost_local = loss_fn(yhat, Mf, valid_l, col_valid, lo) / B
        flat_dense = [p for k in DENSE_GROUPS for p in dense_leaves[k]]
        names = list(srows)
        grads = torch.autograd.grad(cost_local, flat_dense + [srows[n] for n in names])
        g_dense, g_rows = list(grads[:len(flat_dense)]), dict(zip(names, grads[len(flat_dense):]))

        # the input rows' gradients: each lane's rows come from its own
        # rank; the target rows' gradients are summed over the lane blocks
        if mode == "constrained":
            gX, gY = g_rows["WyS"][:bl], g_rows["WyS"][bl:]
        else:
            gX, gY = g_rows[xname], g_rows["Wy"]
        summed = g_dense + [gY, cost_local.detach().reshape(1)]
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in summed]), "data")
        summed = [f.view_as(g) for f, g in zip(torch.split(flat, [g.numel() for g in summed]),
                                               summed)]
        g_dense, gY, cost = summed[:-2], summed[-2], summed[-1][0]
        gX = mesh.all_gather(gX, "data")
        if mode == "constrained":
            scatter = {"Wy": (torch.cat([X_scatter_all, Y_scatter]), torch.cat([gX, gY]))}
        else:
            scatter = {xname: (X_scatter_all, gX), "Wy": (Y_scatter, gY)}
        g_dense, g_sparse = opt.clip_by_global_norm(g_dense, [g for _, g in scatter.values()])

        with torch.no_grad():
            gi = iter(g_dense)
            for k in DENSE_GROUPS:
                for p, st in zip(dense[k], opt_state["dense"][k]):
                    opt.apply_dense(p, next(gi), st)
            for (name, (idx, _)), g in zip(scatter.items(), g_sparse):
                table = params["Wx"][0] if name == "Wx0" else params[name]
                idx_l = torch.where((idx >= r0) & (idx < r0 + rows_local), idx - r0, SENTINEL)
                opt.apply_sparse(table, idx_l, g, opt_state["sparse"][name],
                                 sr_seed=None if seeds is None else (seeds[name], r0))
            for h, hn, ho in zip(state.H, H_new, H):
                h.copy_(torch.where(valid_l[:, None], hn.detach(), ho))
        return cost * Mf

    return build_chunk_fn(cfg, n_items, layout, step_fn, not _eager and mesh.capturable,
                          slice(lo, lo + bl))
