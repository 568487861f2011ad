"""The user-facing GRU4Rec model: fit / predict / save / load.

PyTorch counterpart of ``gru4rec_tpu/models/gru4rec.py`` (reference:
gru4rec.py:27-781): the same constructor keyword set and ``set_params``
string coercion; ``fit(data)`` trains on one device through
``train/step.py`` (on the card, one captured CUDA graph of the training
step replayed per step, the counterpart of JAX's one program per chunk;
the training state changes in place only), with JAX's options (in-fit
validation with early stopping and ``keep_best``, training checkpoints
and exact resume, ``retrain`` over a grown catalog, a profiler trace, the
per-chunk NaN abort with a state dump; in-fit validation builds its
schedule once and keeps its captured step for the call); stateful serving
through ``predict_next_batch`` and ``predict_topk`` (on the card, captured
calls replayed, :meth:`GRU4Rec._serve_graph`); ``cast_for_serving``;
``savemodel`` / ``loadmodel`` (``io/checkpoint.py``, archives shared with
the JAX package). All three
input modes train, under every ``opt_state_dtype``, including
``"bfloat16_sr"``. ``fit``, ``predict_topk`` and ``evaluate`` take a
``mesh=`` (``parallel/mesh.py``): every rank of the mesh calls them, lanes
run data-parallel and the item tables are row-sharded over the ranks; after
``fit(mesh=)`` the parameters are canonical CPU tensors on every rank, which
mesh calls shard again and single-device calls copy to the model's device.

The model runs on the card (``device=None`` means ``"cuda"``) unless the
caller asks for the CPU with ``device="cpu"``; asking for CUDA where there
is none raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import pandas as pd
import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap
from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order
from gru4rec_tpu_torch.data.tools import compute_offset, sort_if_needed
from gru4rec_tpu_torch.eval.evaluation import evaluate, make_dist_topk_fn
from gru4rec_tpu_torch.io.checkpoint import (_is_primary_process, load_model,
                                             load_train_checkpoint, save_model,
                                             save_train_checkpoint)
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.ops.sampling import build_alias_table, popularity_cdf
from gru4rec_tpu_torch.parallel.dist_step import (check_mesh, detect_scratch_layout,
                                                  make_dist_chunk_fn, shard_params,
                                                  shard_train_state, unshard_params,
                                                  unshard_train_state)
from gru4rec_tpu_torch.train.step import (TrainState, init_opt_state, init_train_state,
                                          make_chunk_fn, make_generator)
from gru4rec_tpu_torch.utils.cuda_graph import ReplayLoop, binding
from gru4rec_tpu_torch.utils.logging import get_logger
from gru4rec_tpu_torch.utils.profiling import Pace, span

# Eager calls on the capture stream before a serving call is captured.
SERVE_WARMUP_CALLS = 1


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. CUDA asked for where there is none raises:
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU")
        # float32 matmuls in full float32, as the JAX package's
        # compute_dtype="float32" asks of XLA (Precision.HIGHEST); bfloat16
        # products summed in float32, as its preferred_element_type=f32 does
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def _tree_to(tree, device):
    """A dict/list tree of tensors, each moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


class _LaggedLoss:
    """Per-chunk loss sums read back two chunks late: each chunk's sum is
    copied to host memory behind its own event, so reading chunk ``ci - 2``
    after dispatching chunk ``ci`` waits for that copy only, never for the
    chunks in flight (the JAX package reads a finished array the same way,
    gru4rec.py:413-424)."""

    def __init__(self, n_chunks: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = torch.empty(n_chunks, dtype=torch.float32, pin_memory=self.cuda)
        self.events = []

    def push(self, loss: torch.Tensor) -> None:
        self.host[len(self.events)].copy_(loss, non_blocking=True)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        self.events.append(ev)

    def is_nan(self, ci: int) -> bool:
        if self.events[ci] is not None:
            self.events[ci].synchronize()
        return math.isnan(float(self.host[ci]))


class GRU4Rec:
    """GRU4Rec session-based recommender on PyTorch."""

    def __init__(self, config: Optional[GRU4RecConfig] = None, device=None,
                 **kwargs):
        if config is None:
            config = GRU4RecConfig()
        self.config = config
        if kwargs:
            self.config.set_params(**kwargs)
        self.device = resolve_device(device)
        self.params = None
        self.n_items = 0
        self.itemidmap: Optional[pd.Series] = None
        self.H = None
        self.error_during_train = False
        self._train_state = None
        self._predict_batch = None
        self._current_session = None
        self._completed_epochs = 0
        self._device_params = None  # (params, their copy on self.device)
        self._mesh_params = None    # (params, mesh, this rank's shards)
        # the captured serving calls on a CUDA device, by ("topk", batch, k)
        # or ("next", batch); None serves eagerly there too (their plain
        # version, which the CPU always runs)
        self._serve_graphs = {}

    def set_params(self, **kwargs):
        self.config.set_params(**kwargs)
        return self

    def __getattr__(self, name):
        # reference-style attribute access (gru.layers, gru.loss, ...) is
        # forwarded for config fields only
        cfg = object.__getattribute__(self, "config")
        if name in {f.name for f in dataclasses.fields(cfg)}:
            return getattr(cfg, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    # ------------------------------------------------------------------ #
    def fit(self, data: pd.DataFrame, sample_store: int = 10_000_000,
            store_type: str = "gpu", n_epochs: Optional[int] = None,
            retrain: bool = False, checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None, resume: Optional[str] = None,
            profile_dir: Optional[str] = None, mesh=None,
            eval_data: Optional[pd.DataFrame] = None, eval_every: int = 1,
            eval_cutoff: int = 20, eval_batch_size: int = 512,
            eval_mode: str = "standard", eval_metric: str = "recall",
            early_stop_patience: int = 0, keep_best: bool = True):
        """Train the network (reference: gru4rec.py:515-664); the JAX
        package's options, ``gru4rec_tpu/models/gru4rec.py:184-543``.

        ``sample_store``/``store_type`` are accepted for API parity;
        negatives are drawn on the device, one block per chunk of
        ``chunk_size`` steps. Per-epoch ``{loss, seconds, steps, events,
        host_s, device_s, behind}`` go to ``self.epoch_stats`` and the JSONL
        ``epoch`` event: the last three are the epoch's pace
        (``utils/profiling.py::Pace``), counted in every run.

        * ``retrain=True`` continues training a fitted (or loaded) model on
          new data, growing the item tables for unseen items.
        * ``checkpoint_every=k`` with ``checkpoint_path`` saves a training
          checkpoint every k epochs; ``resume=path`` continues from one with
          the archive's config (exactly for the port's own archives on the
          same device type, ``io/checkpoint.py``).
        * ``profile_dir`` writes a ``torch.profiler`` Chrome trace of the
          second epoch into that directory.
        * ``eval_data`` evaluates the held-out set every ``eval_every``
          epochs (Recall/MRR@``eval_cutoff``, ``eval_mode`` ties) into
          ``self.valid_stats``; ``early_stop_patience=k`` stops after k
          evaluations without improvement of ``eval_metric`` ("recall" or
          "mrr"), and ``keep_best`` restores the parameters of the best
          evaluation at the end.
        * A NaN loss aborts training (checked per chunk, two chunks behind,
          and per epoch), marks the model unusable (``error_during_train``)
          and dumps the state (:meth:`_dump_nan_state`).
        * ``mesh`` (``parallel.make_mesh``) trains on every rank of the mesh,
          which all call ``fit`` with the same data: lanes data-parallel,
          item tables row-sharded (``parallel/dist_step.py``), on
          ``mesh.device``. In-fit validation runs on the live shards;
          ``keep_best`` snapshots, checkpoints and the NaN dump are gathered
          to the canonical layout (checkpoints written by rank 0 alone);
          ``resume`` and ``retrain`` shard a canonical state. At the end the
          canonical state is on every rank, as CPU tensors.
        """
        if mesh is not None:
            check_mesh(mesh)
        cfg = self.config
        dev = self.device if mesh is None else mesh.device
        # where the canonical state lives: the device, or the host under a mesh
        host = dev if mesh is None else torch.device("cpu")
        # invalidate the serving lane state: fit() ends by pointing self.H
        # at the training hidden state (cfg.batch_size lanes), which a later
        # predict call of that width must not continue from
        self._current_session = None
        self._predict_batch = None
        if self._serve_graphs:
            self._serve_graphs.clear()  # their pools, while training runs
        self._completed_epochs = 0  # resume= overrides with the saved epoch
        self.error_during_train = False
        self.epoch_stats = []  # per-epoch {loss, seconds, steps, events, pace}
        self.valid_stats = []  # per-eval {epoch, recall, mrr}
        best_metric, best_params, stale = -np.inf, None, 0
        logger = get_logger()

        start_epoch = 0
        resumed_state = None
        if resume is not None:
            resumed_state, start_epoch = load_train_checkpoint(resume, self, device=host,
                                                               gen_device=dev)
            # everything below is built from the archive's config
            cfg = self.config
            print(f"Resuming training from {resume} at epoch {start_epoch + 1}")
            self._completed_epochs = start_epoch
            retrain = False
        item_key, session_key, time_key = cfg.item_key, cfg.session_key, cfg.time_key
        if retrain:
            if self.params is None:
                raise ValueError("retrain=True requires a previously trained model")
            if self.params["Wy"].dtype != torch.float32:
                # cast_for_serving narrowed the masters; training on them
                # would silently freeze (config.py's param_dtype guard)
                raise NotImplementedError(
                    "retrain requires float32 master weights, but this "
                    f"model's parameters are {self.params['Wy'].dtype} (cast "
                    "for serving?). Reload the float32 checkpoint to retrain."
                )
            new_items = data[item_key].unique()
            unseen = new_items[~np.isin(new_items, self.itemidmap.index.values)]
            if len(unseen):
                print(f"Extending item tables with {len(unseen)} new items")
                self._extend_items(unseen)
        elif resume is None:
            self.itemidmap = build_itemidmap(data, item_key)
            self.n_items = len(self.itemidmap)
        data = apply_itemidmap(data, self.itemidmap, item_key)
        sort_if_needed(data, [session_key, time_key])
        offsets = compute_offset(data, session_key)

        n_pad = gru.pad_items(self.n_items, cfg.item_pad_multiple)
        pop = (
            data.groupby(item_key).size()
            .reindex(self.itemidmap.index.values, fill_value=0)
            .values
        )
        logp0 = np.zeros((n_pad,), dtype=np.float32)
        logp0[: self.n_items] = np.log(np.maximum(pop, 1).astype(np.float64))
        logp0 = torch.from_numpy(logp0).to(dev)
        if cfg.n_sample and cfg.sample_alpha != 0 and cfg.sampler == "alias":
            samp1 = torch.from_numpy(build_alias_table(pop, cfg.sample_alpha)).to(dev)
        elif cfg.n_sample and cfg.sample_alpha != 0:
            samp1 = torch.from_numpy(popularity_cdf(pop, cfg.sample_alpha)).to(dev)
        else:
            samp1 = torch.zeros((1,), dtype=torch.float32, device=dev)

        if resumed_state is not None:
            state = resumed_state
        elif retrain:
            if self._train_state is not None:
                prev = self._train_state
                opt_state, gen, step = prev.opt_state, prev.gen, prev.step
            else:
                # a model loaded without optimizer entries: fresh
                # accumulators over the existing weights (a warm restart;
                # savemodel(include_optimizer=True) archives restore the
                # real state, io/checkpoint.py)
                print("retrain: no optimizer state on the model — "
                      "reinitializing accumulators")
                opt_state = init_opt_state(cfg, self.params)
                gen, step = make_generator(cfg.seed, dev), 0
            state = TrainState(self.params, opt_state,
                               gru.init_hidden(cfg, cfg.batch_size, host), gen, step)
        else:
            state = init_train_state(cfg, self.n_items, host)
            if mesh is not None:
                state.gen = make_generator(cfg.seed, dev)
        if mesh is not None:
            state = shard_train_state(state, cfg, mesh)
            chunk_fn = make_dist_chunk_fn(cfg, self.n_items, mesh)
        else:
            if state.params["Wy"].device.type != dev.type:
                # retraining on one device after fit(mesh=): canonical CPU state
                state.params = _tree_to(state.params, dev)
                state.opt_state = _tree_to(state.opt_state, dev)
            # on the card, every state tensor the captured step uses is
            # bound by now: from here on the state changes in place only
            chunk_fn = make_chunk_fn(cfg, self.n_items)

        base_order = session_order(data, session_key, time_key, cfg.time_sort,
                                   len(offsets) - 1)
        data_items = data["ItemIdx"].values.astype(np.int32)
        C = cfg.chunk_size
        epochs = cfg.n_epochs if n_epochs is None else n_epochs
        sched = None
        # in-fit validation evaluates one frame on the live parameters every
        # epoch: its schedule is built once and its captured step kept for
        # the call
        eval_sched_cache, eval_graphs = {}, {}
        for epoch in range(start_epoch, epochs):
            # the first epoch of a run pays the kernels' build
            prof = (_start_profile(dev)
                    if profile_dir is not None and epoch == start_epoch + 1 else None)
            t0 = time.time()
            # in place: a captured training step reads and writes these
            # buffers (train/step.py)
            for h in state.H:
                h.zero_()
            with span("gru4rec.fit.schedule"):
                if cfg.train_random_order:
                    # each epoch's permutation is a pure function of (seed,
                    # epoch), so a resumed run replays the orders of an
                    # uninterrupted one
                    order = np.random.default_rng(
                        (cfg.seed, epoch)).permutation(len(offsets) - 1)
                    sched = build_schedule(data_items, offsets, order, cfg.batch_size,
                                           require_two_lanes=(cfg.n_sample == 0))
                elif sched is None:
                    # deterministic session order => the same schedule every epoch
                    sched = build_schedule(data_items, offsets, base_order,
                                           cfg.batch_size,
                                           require_two_lanes=(cfg.n_sample == 0))
            T = sched.n_steps
            loss_parts, total_events = [], 0
            lagged = _LaggedLoss(-(-T // C), dev)
            pace = state.pace = Pace(dev.type == "cuda")
            for ci, t0c in enumerate(range(0, T, C)):
                t1c = min(t0c + C, T)
                ls, ec = chunk_fn(
                    state, sched.in_idx[t0c:t1c], sched.out_idx[t0c:t1c],
                    sched.valid[t0c:t1c], sched.reset[t0c:t1c], samp1, logp0,
                )
                loss_parts.append(ls)
                lagged.push(ls)
                total_events += ec
                # fail fast on divergence (the reference aborts per step,
                # gru4rec.py:626-629): the sum of a chunk two dispatches
                # behind, which never waits on the chunks in flight
                if ci >= 2:
                    since = time.perf_counter()
                    with span("gru4rec.fit.nan_check"):
                        nan = lagged.is_nan(ci - 2)
                    pace.add("nan_wait", since)
                    if nan:
                        _stop_profile(prof, profile_dir, epoch, mesh)
                        return self._nan_abort(state, epoch, checkpoint_path, mesh,
                                               chunk=ci - 2)
            since = time.perf_counter()
            with span("gru4rec.fit.loss_sync"):
                total_loss = float(torch.stack(loss_parts).sum()) if loss_parts else 0.0
            pace.add("loss_sync", since)
            _stop_profile(prof, profile_dir, epoch, mesh)
            avgc = total_loss / max(total_events, 1.0)
            if np.isnan(avgc):
                return self._nan_abort(state, epoch, checkpoint_path, mesh)
            dt = time.time() - t0
            paced = pace.read()
            self.epoch_stats.append(
                {"loss": avgc, "seconds": dt, "steps": T, "events": total_events, **paced})
            # cumulative across resumes: save_checkpoint() stores this
            self._completed_epochs = epoch + 1
            logger.log("epoch", epoch=epoch + 1, loss=avgc, seconds=dt, steps=T,
                       events=total_events, mb_per_s=T / dt, e_per_s=total_events / dt,
                       **paced)
            print(
                "Epoch{} --> loss: {:.6f} \t({:.2f}s) \t[{:.2f} mb/s | {:.0f} e/s]".format(
                    epoch + 1, avgc, dt, T / dt, total_events / dt
                )
            )
            if eval_data is not None and (epoch + 1) % max(eval_every, 1) == 0:
                # self.params points at the live parameters only for the
                # duration of the call; a mesh evaluates the live shards
                prev_params = self.params
                if mesh is None:
                    self.params = state.params
                try:
                    with span("gru4rec.fit.validate"):
                        rec, mrr = evaluate(
                            self, eval_data, cut_off=[eval_cutoff],
                            batch_size=eval_batch_size, mode=eval_mode,
                            session_key=session_key, item_key=item_key,
                            time_key=time_key, mesh=mesh, _sched_cache=eval_sched_cache,
                            _shards=None if mesh is None else state.params,
                            _graphs=eval_graphs,
                        )
                finally:
                    self.params = prev_params
                metric = rec[0] if eval_metric == "recall" else mrr[0]
                self.valid_stats.append(
                    {"epoch": epoch + 1, "recall": rec[0], "mrr": mrr[0]})
                logger.log("valid", epoch=epoch + 1, recall=rec[0], mrr=mrr[0])
                print("Validation Recall@{}: {:.6f} MRR@{}: {:.6f}".format(
                    eval_cutoff, rec[0], eval_cutoff, mrr[0]))
                if metric > best_metric:
                    best_metric, stale = metric, 0
                    if keep_best:
                        # the updates run in place: a snapshot must be a
                        # copy, or it would follow the later epochs; a mesh
                        # gathers the canonical layout to the host
                        best_params = (gru.map_params(torch.clone, state.params)
                                       if mesh is None else
                                       unshard_params(state.params, cfg, mesh))
                else:
                    stale += 1
                    if early_stop_patience and stale >= early_stop_patience:
                        print(
                            f"Early stopping at epoch {epoch + 1} (no "
                            f"{eval_metric} improvement in {stale} evaluations)"
                        )
                        break
            if checkpoint_every and checkpoint_path and (epoch + 1) % checkpoint_every == 0:
                # checkpoints hold the canonical layout; resume shards it again
                with span("gru4rec.fit.checkpoint"):
                    ckpt_state = (state if mesh is None
                                  else unshard_train_state(state, cfg, mesh))
                    self._train_state = ckpt_state
                    self.params = ckpt_state.params
                    save_train_checkpoint(self, ckpt_state, epoch + 1, checkpoint_path)
                if _is_primary_process():
                    print(f"Checkpoint saved to {checkpoint_path} "
                          f"(epoch {epoch + 1})")
        state.pace = None
        if mesh is not None:
            state = unshard_train_state(state, cfg, mesh)
        if best_params is not None:
            # keep_best: serve/save the best-validation parameters (the
            # optimizer state stays at the last epoch)
            state.params = best_params
        self._train_state = state
        self.params = state.params
        self.H = state.H
        return self

    # ------------------------------------------------------------------ #
    def _nan_abort(self, state, epoch, checkpoint_path, mesh=None, chunk=None):
        print(f"Epoch {epoch}: NaN error!")
        get_logger().log("nan_abort", epoch=epoch,
                         **({} if chunk is None else {"chunk": chunk}))
        self.error_during_train = True
        self._dump_nan_state(state, epoch, checkpoint_path, mesh)
        return self

    def _dump_nan_state(self, state, epoch, checkpoint_path, mesh=None) -> None:
        """Best-effort diagnostic dump on a NaN abort: a training checkpoint
        of the live state (up to two chunks past the first NaN chunk), so
        the divergence can be replayed offline. Never masks the abort: a
        failure here is reported, not raised.

        Path: ``<checkpoint_path>.nan.npz`` when checkpointing is configured,
        else ``$GRU4REC_TPU_NAN_DUMP`` (empty disables the dump), else
        ``gru4rec_nan_dump.npz`` in the working directory. A mesh dumps
        the state gathered to the canonical layout (every rank reaches the
        abort together: the loss it reads is reduced over the mesh)."""
        path = (f"{checkpoint_path}.nan.npz" if checkpoint_path
                else os.environ.get("GRU4REC_TPU_NAN_DUMP", "gru4rec_nan_dump.npz"))
        if not path:
            return
        try:
            if mesh is not None:
                state = unshard_train_state(state, self.config, mesh)
            save_train_checkpoint(self, state, epoch, path)
            if _is_primary_process():
                print(f"NaN abort: diverged training state dumped to {path}")
        except Exception as e:  # noqa: BLE001 — diagnostic only
            print(f"NaN abort: state dump failed ({e!r})")

    # ------------------------------------------------------------------ #
    def _extend_items(self, unseen_ids) -> None:
        """Grow every item-dimensioned table and its optimizer state for new
        items seen at retrain time (reference extend_weights,
        gru4rec.py:261-266): new rows drawn with the Glorot width over rows +
        cols + n_new from ``RandomState(seed + 7)`` (the JAX package's
        draws, bit for bit); optimizer-state rows zero in each slot's own
        dtype. The tables are new tensors; the training state is rebuilt
        around them."""
        cfg = self.config
        n_old = self.n_items
        n_new = len(unseen_ids)
        n_total = n_old + n_new
        rng = np.random.RandomState(cfg.seed + 7)
        new_pad = gru.pad_items(n_total, cfg.item_pad_multiple)

        def new_rows(n_cols):
            sigma = cfg.sigma if cfg.sigma != 0 else np.sqrt(6.0 / (n_old + n_cols + n_new))
            if cfg.init_as_normal:
                m = rng.randn(n_new, n_cols) * sigma
            else:
                m = rng.rand(n_new, n_cols) * sigma * 2 - sigma
            return m.astype(cfg.param_dtype)

        def extend(table, rows=None):
            """``table``'s first n_old rows, then ``rows`` (zeros if None),
            then zero padding to the new layout."""
            new = (torch.zeros((n_new,) + table.shape[1:], dtype=table.dtype)
                   if rows is None else torch.from_numpy(rows).to(table.dtype))
            pad = torch.zeros((new_pad - n_total,) + table.shape[1:], dtype=table.dtype)
            return torch.cat([table[:n_old], new.to(table.device),
                              pad.to(table.device)])

        params = dict(self.params)
        mode = gru.input_mode(cfg)
        # Wy carries the folded bias at column h + padding: [glorot(h) | zeros]
        h_last = cfg.layers[-1]
        wy_cols = params["Wy"].shape[1]
        params["Wy"] = extend(params["Wy"], np.concatenate(
            [new_rows(h_last), np.zeros((n_new, wy_cols - h_last), dtype=cfg.param_dtype)],
            axis=1))
        if mode == "embedding":
            params["E"] = extend(params["E"], new_rows(params["E"].shape[1]))
        if mode == "onehot":
            params["Wx"] = ([extend(params["Wx"][0], new_rows(params["Wx"][0].shape[1]))]
                            + list(params["Wx"][1:]))
        self.params = params

        if self._train_state is not None:
            opt_state = dict(self._train_state.opt_state)
            opt_state["sparse"] = {name: {k: extend(a) for k, a in st.items()}
                                   for name, st in opt_state["sparse"].items()}
            self._train_state = dataclasses.replace(
                self._train_state, params=params, opt_state=opt_state)
        new_map = pd.Series(
            data=np.arange(n_old, n_total, dtype=np.int64), index=unseen_ids
        )
        self.itemidmap = pd.concat([self.itemidmap, new_map])
        self.n_items = n_total

    # ------------------------------------------------------------------ #
    def save_checkpoint(self, fname: str) -> None:
        """Save a full training checkpoint (parameters, optimizer state,
        generator state, step and the cumulative epoch count) for exact
        resume."""
        if self._train_state is None:
            raise ValueError("no training state to checkpoint")
        save_train_checkpoint(self, self._train_state, self._completed_epochs, fname)

    # ------------------------------------------------------------------ #
    def _serving_params(self):
        """The parameters on the model's device. After ``fit(mesh=)`` they
        are canonical CPU tensors: a single-device call copies them to the
        device once, and keeps the copy until the parameters change."""
        p = self.params
        if p["Wy"].device.type == self.device.type:
            return p
        if self._device_params is None or self._device_params[0] is not p:
            self._device_params = (p, gru.map_params(lambda t: t.to(self.device), p))
        return self._device_params[1]

    def _build_predict_fn(self, subset: bool):
        """``predict_step(params, H, in_idx, item_idx=None) -> (H_new,
        scores)``: one serving step, scoring the full catalog (sliced to
        ``n_items``) or, with ``subset``, the rows ``item_idx``."""
        cfg = self.config
        mode = gru.input_mode(cfg)
        n_items = self.n_items

        @torch.no_grad()
        def predict_step(params, H, in_idx, item_idx=None):
            srows = gru.input_rows(params, in_idx, mode)
            if subset:
                srows["Wy"] = params["Wy"][item_idx]
                return gru.forward(params, srows, list(H), cfg, M=in_idx.shape[0],
                                   training=False, full_catalog=False)
            n_pad = params["Wy"].shape[0]
            item_valid = torch.arange(n_pad, device=in_idx.device) < n_items
            H_new, yhat = gru.forward(params, srows, list(H), cfg, M=in_idx.shape[0],
                                      training=False, full_catalog=True,
                                      item_valid=item_valid)
            return H_new, yhat[:, :n_items]

        return predict_step

    def _ensure_lanes(self, batch: int) -> None:
        """Fresh lanes when the lane width changes or after fit(): ONLY a
        width change resets the persistent lane state (reference: reset on
        batch change, gru4rec.py:691-711), not a changed
        ``predict_for_item_ids``, which evaluate_sessions_batch varies every
        step mid-session. Fresh lanes are new tensors (a graph bound to the
        old ones is captured again); every call then changes them in
        place."""
        if self._predict_batch != batch or self._current_session is None:
            self.H = gru.init_hidden(self.config, batch, self.device)
            self._current_session = np.ones(batch) * -1
            self._predict_batch = batch

    def _keep_mask(self, session_ids) -> np.ndarray:
        """The lanes whose session is the one of the last predict call
        (bool, batch); records the new session map (reference:
        gru4rec.py:712-716)."""
        session_ids = np.asarray(session_ids)
        keep = session_ids == self._current_session
        if not keep.all():
            self._current_session = session_ids.copy()
        return keep

    def _reset_changed_lanes(self, session_ids) -> None:
        """Zero, in place, the hidden lanes whose session changed since the
        last predict call: a multiply by the keep mask, as JAX does, so a
        NaN lane stays NaN."""
        keep = self._keep_mask(session_ids)
        if not keep.all():
            keep_t = torch.from_numpy(keep).to(self.device)[:, None]
            for h in self.H:
                h.mul_(keep_t)

    def _item_index_array(self, item_ids) -> np.ndarray:
        return self.itemidmap[item_ids].values.astype(np.int64)

    def _item_indices(self, item_ids) -> torch.Tensor:
        return torch.from_numpy(self._item_index_array(item_ids)).to(self.device)

    def _graphed(self, mesh=None) -> bool:
        """Whether a serving call replays a captured graph: on a card, and on
        a mesh only over NCCL with the lanes on the mesh's card (the graph
        updates them in place). The CPU, a gloo mesh and lanes on another
        device than the mesh's serve eagerly."""
        if self._serve_graphs is None or self.device.type != "cuda":
            return False
        return mesh is None or (mesh.capturable and self.H[0].device == mesh.device)

    def _serve_graph(self, key, session_ids, input_item_ids, params, make_call):
        """The outputs of the captured serving call ``key`` on this
        request: the counterpart of JAX's jitted ``predict_step`` and
        ``topk_step``. ``make_call()`` builds the call, ``call(params, H,
        in_idx)``: it updates the lanes ``H`` in place and returns the
        call's outputs; the graph runs it after the lane reset (a multiply
        by the keep mask). Both inputs come from one int64 slot, ``[item
        indices | keep mask]``, one host-to-device copy per call. The call
        is a ``utils/cuda_graph.py::ReplayLoop``: the first
        ``SERVE_WARMUP_CALLS`` calls run eagerly on the capture stream
        (``gru4rec.serve.step``), the next is captured, and every call from
        then on replays (``gru4rec.serve.replay``); a replay's outputs live
        in the graph's pool, and the next replay overwrites them, so the
        caller copies them to the host first. The graph is captured again
        when the parameters or lanes it is bound to change (its ``bound``:
        a new lane width, ``cast_for_serving``, ``loadmodel``, a ``fit``
        that grows the tables, the device copy or the shards of
        ``fit(mesh=)``'s parameters)."""
        bound = (self.n_items, binding(params, self.H))
        graph = self._serve_graphs.get(key)
        if graph is None or graph.bound != bound:
            call = make_call()
            H = list(self.H)
            B = len(H[0])

            def fn(row):
                for h in H:
                    h.mul_(row[B:, None])
                return call(params, H, row[:B])

            graph = ReplayLoop(SERVE_WARMUP_CALLS, fn, "gru4rec.serve.step",
                               "gru4rec.serve.replay").place(
                torch.zeros(2 * B, dtype=torch.int64, device=self.device), True)
            graph.bound = bound
            self._serve_graphs[key] = graph
        with span("gru4rec.serve.keep"):
            keep = self._keep_mask(session_ids)
        with span("gru4rec.serve.lookup"):
            idx = self._item_index_array(input_item_ids)
        with span("gru4rec.serve.upload"):
            graph.slot.copy_(torch.from_numpy(np.concatenate([idx, keep.astype(np.int64)])))
        return graph.run([graph.slot])

    def predict_next_batch(self, session_ids, input_item_ids,
                           predict_for_item_ids=None, batch: int = 100):
        """Stateful batch prediction (reference: gru4rec.py:665-728): hidden
        state persists across calls per lane; lanes whose session ID changed
        are reset. Returns a DataFrame of scores, items x events.

        On a CUDA device the full-catalog call replays one captured call
        per batch width (:meth:`_serve_graph`). The subset call stays eager: its
        item list has any length from call to call."""
        if self.error_during_train:
            raise Exception("Training ended with an error; model is unusable.")
        subset = predict_for_item_ids is not None
        self._ensure_lanes(batch)
        if not subset and self._graphed():
            preds = self._serve_graph(("next", batch), session_ids, input_item_ids,
                                      self._serving_params(),
                                      lambda: self._serving_call(lambda y: y.contiguous()))
            return pd.DataFrame(data=preds.cpu().numpy().T, index=self.itemidmap.index)
        self._reset_changed_lanes(session_ids)
        in_idx = self._item_indices(input_item_ids)
        step = self._build_predict_fn(subset)
        params = self._serving_params()
        if subset:
            H_new, preds = step(params, self.H, in_idx,
                                self._item_indices(predict_for_item_ids))
            index = predict_for_item_ids
        else:
            H_new, preds = step(params, self.H, in_idx)
            index = self.itemidmap.index
        for h, hn in zip(self.H, H_new):
            h.copy_(hn)
        return pd.DataFrame(data=preds.cpu().numpy().T, index=index)

    def predict_topk(self, session_ids, input_item_ids, k: int = 20,
                     batch: int = 100, mesh=None):
        """Top-k recommendation on the device (``torch.topk`` over the
        catalog scores): only k ids and scores per lane cross back to the
        host. Same stateful lanes as :meth:`predict_next_batch` (the two
        share them). Returns ``(items, scores)``: an object array (batch, k)
        of raw item IDs, best first, and a float array (batch, k).

        On a CUDA device the call replays one captured call per (batch, k)
        (:meth:`_serve_graph`: the lane reset, the step and ``torch.topk``), as
        JAX compiles ``topk_step`` per (batch, k).

        The call is the span ``gru4rec.serve``, with the children
        ``gru4rec.serve.keep`` (the keep mask, or the lane reset where the
        call runs eagerly), ``.lookup`` (the id lookup), ``.upload``,
        ``.replay`` (or, eagerly and at the graph's warm-up call, ``.step``),
        ``.fetch`` and ``.idmap`` (the ids back to the catalog's).

        ``mesh`` (``parallel.make_mesh``) serves on every rank of the mesh,
        which all make the call: each rank scores its block of the lanes
        against its row-shard of the catalog, and the per-shard top-k
        candidates are merged (``eval/evaluation.py::make_dist_topk_fn``).
        Every rank returns the whole (batch, k); the lane state is the one
        the single-device calls use. On an NCCL mesh the call replays one
        captured call per (batch, k, mesh), collectives included; a gloo
        mesh serves eagerly (its collectives run on host threads, which a
        graph cannot capture). Using a new mesh drops the graphs of the
        others, with their pools and communicators."""
        if self.error_during_train:
            raise Exception("Training ended with an error; model is unusable.")
        if mesh is not None:
            check_mesh(mesh)
        with span("gru4rec.serve"):
            k = min(int(k), self.n_items)
            self._ensure_lanes(batch)
            if mesh is None:
                key, dev, params = ("topk", batch, k), self.device, self._serving_params()

                def make_call():
                    return self._serving_call(
                        lambda y: torch.topk(y, k, dim=1, sorted=True))
            else:
                key, dev = ("topk", batch, k, mesh), mesh.device
                params = self._mesh_shards(mesh)

                def make_call():
                    return self._mesh_topk_call(
                        make_dist_topk_fn(self.config, self.n_items, k, mesh), batch, mesh)
            if self._graphed(mesh):
                if mesh is not None:
                    for old in [key for key in self._serve_graphs
                                if len(key) == 4 and key[3] is not mesh]:
                        del self._serve_graphs[old]
                scores, idx = self._serve_graph(key, session_ids, input_item_ids, params,
                                                make_call)
            else:
                with span("gru4rec.serve.keep"):
                    self._reset_changed_lanes(session_ids)
                with span("gru4rec.serve.lookup"):
                    in_idx = self._item_indices(input_item_ids)
                with span("gru4rec.serve.step"):
                    # the lanes go to the call's device (a mesh's may be
                    # another) and come back
                    H = [h.to(dev) for h in self.H]
                    scores, idx = make_call()(params, H, in_idx.to(dev))
                    for h, hm in zip(self.H, H):
                        if hm is not h:
                            h.copy_(hm)
            with span("gru4rec.serve.fetch"):
                idx, scores = idx.cpu().numpy(), scores.cpu().numpy()
            with span("gru4rec.serve.idmap"):
                # Arrow-backed string indexes (pandas>=3) reject 2-D fancy
                # indexing: take the batch x k ids flat, as objects (only
                # those, not the whole catalog per call)
                items = np.asarray(self.itemidmap.index[idx.ravel()], dtype=object)
            return items.reshape(idx.shape), scores

    def _serving_call(self, finish):
        """The single-device serving call, captured (:meth:`_serve_graph`)
        or eager: the full-catalog step, the lanes written back, then
        ``finish(scores)``."""
        step = self._build_predict_fn(False)

        def call(params, H, in_idx):
            H_new, yhat = step(params, H, in_idx)
            for h, hn in zip(H, H_new):
                h.copy_(hn)
            return finish(yhat)

        return call

    def _mesh_shards(self, mesh):
        """This rank's shards of the canonical parameters, sharded once and
        kept until the parameters or the mesh change."""
        cache = self._mesh_params
        if cache is None or cache[0] is not self.params or cache[1] is not mesh:
            detect_scratch_layout(self.params, self.n_items, self.config, mesh)
            cache = (self.params, mesh, shard_params(self.params, self.config, mesh))
            self._mesh_params = cache
        return cache[2]

    @staticmethod
    def _mesh_topk_call(topk, batch, mesh):
        """:meth:`predict_topk`'s call on ``mesh`` from ``topk``
        (``make_dist_topk_fn``): the rank's block of the lanes scored
        against its shards, the new lanes written back and ``(scores,
        ids)`` of the whole batch, all gathered over ``data``."""
        lo, bl = mesh.lanes(batch)

        def call(shards, H, in_idx):
            H_new, ids, scores = topk(shards, [h[lo:lo + bl] for h in H], in_idx[lo:lo + bl])
            for h, hn in zip(H, H_new):
                h.copy_(mesh.all_gather(hn, "data"))
            return mesh.all_gather(scores, "data"), mesh.all_gather(ids, "data")

        return call

    # ------------------------------------------------------------------ #
    def cast_for_serving(self, dtype="bfloat16") -> "GRU4Rec":
        """Cast the parameters to a narrower serving dtype in place and
        return self: half the table memory for bfloat16, one storage
        rounding of the weights (~0.4% relative), so the top-k order can
        differ for near-tied candidates. Scoring keeps the float32 hidden
        state and float32 accumulation.

        Serving-only: it drops the training state, and ``fit(retrain=True)``
        refuses the narrowed masters; keep the float32 archive to train
        again. ``savemodel`` round-trips the cast model (dtype tags)."""
        dt = gru.torch_dtype(dtype)
        self.params = gru.map_params(lambda t: t.to(dt), self.params)
        self._train_state = None
        if self._serve_graphs:
            self._serve_graphs.clear()  # bound to the old parameters
        return self

    # ------------------------------------------------------------------ #
    def savemodel(self, fname: str, include_optimizer: bool = False):
        save_model(self, fname, include_optimizer=include_optimizer)

    @classmethod
    def loadmodel(cls, fname: str, device=None) -> "GRU4Rec":
        """A model from an archive of either package, on ``device`` (the
        card unless ``device="cpu"``)."""
        return load_model(fname, lambda cfg: cls(config=cfg, device=device))


def _start_profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, epoch: int, mesh=None) -> None:
    """Stop the profiler (if one runs) and write its Chrome trace as
    ``<profile_dir>/trace_epoch<n>.json`` (``trace_epoch<n>_rank<r>.json``
    on a mesh)."""
    if prof is None:
        return
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    tag = "" if mesh is None else f"_rank{mesh.rank}"
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_epoch{epoch + 1}{tag}.json"))
