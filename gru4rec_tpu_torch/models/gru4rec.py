"""The user-facing GRU4Rec model: construction and ``fit``.

PyTorch counterpart of ``gru4rec_tpu/models/gru4rec.py`` (reference:
gru4rec.py:27-781). The same constructor keyword set and ``set_params``
string coercion; ``fit(data)`` trains on one device through
``train/step.py``; ``evaluate`` (``eval/evaluation.py``) reads the trained
``params``. Serving (``predict_next_batch`` / ``predict_topk``) and
checkpoints are not ported yet; ``fit``'s resume, retrain, checkpoint,
profile, mesh and in-fit validation options raise ``NotImplementedError``.
All three input modes train (constrained, embedding, one-hot), under every
``opt_state_dtype``, including ``"bfloat16_sr"`` (stochastically rounded
bfloat16 item-table state, ``ops/sr.py``).

The model runs on the card (``device=None`` means ``"cuda"``) unless the
caller asks for the CPU with ``device="cpu"``; asking for CUDA where there
is none raises.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import pandas as pd
import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.data.loader import apply_itemidmap, build_itemidmap
from gru4rec_tpu_torch.data.scheduler import build_schedule, session_order
from gru4rec_tpu_torch.data.tools import compute_offset, sort_if_needed
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.ops.sampling import build_alias_table, popularity_cdf
from gru4rec_tpu_torch.train.step import init_train_state, make_chunk_fn


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
        # compute_dtype="float32" asks of XLA (Precision.HIGHEST)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _not_ported(name: str):
    raise NotImplementedError(f"{name} is not ported to gru4rec_tpu_torch yet")


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
        self.error_during_train = False
        self._train_state = None

    def set_params(self, **kwargs):
        self.config.set_params(**kwargs)
        return self

    def __getattr__(self, name):
        # reference-style attribute access (gru.layers, gru.loss, ...) is
        # forwarded for config fields only
        import dataclasses

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
            eval_data: Optional[pd.DataFrame] = None):
        """Train the network (reference: gru4rec.py:515-664).

        ``sample_store``/``store_type`` are accepted for API parity; negatives
        are drawn on the device, one block per chunk of ``chunk_size``
        steps. Per-epoch ``{loss, seconds, steps, events}`` go to
        ``self.epoch_stats``; a NaN epoch loss aborts training and marks the
        model unusable (``error_during_train``)."""
        for name, val in (("retrain", retrain), ("checkpoint_every", checkpoint_every),
                          ("checkpoint_path", checkpoint_path), ("resume", resume),
                          ("profile_dir", profile_dir), ("mesh", mesh),
                          ("eval_data", eval_data)):
            if isinstance(val, pd.DataFrame) or val not in (None, False, 0):
                _not_ported(f"fit({name}=...)")
        cfg = self.config
        dev = self.device
        self.error_during_train = False
        self.epoch_stats = []  # per-epoch {loss, seconds, steps, events}
        item_key, session_key, time_key = cfg.item_key, cfg.session_key, cfg.time_key

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

        state = init_train_state(cfg, self.n_items, dev)
        chunk_fn = make_chunk_fn(cfg, self.n_items)

        base_order = session_order(data, session_key, time_key, cfg.time_sort,
                                   len(offsets) - 1)
        data_items = data["ItemIdx"].values.astype(np.int32)
        C = cfg.chunk_size
        epochs = cfg.n_epochs if n_epochs is None else n_epochs
        sched = None
        for epoch in range(epochs):
            t0 = time.time()
            state.H = gru.init_hidden(cfg, cfg.batch_size, dev)
            if cfg.train_random_order:
                # each epoch's permutation is a pure function of (seed, epoch)
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
            for t0c in range(0, T, C):
                t1c = min(t0c + C, T)
                ls, ec = chunk_fn(
                    state, sched.in_idx[t0c:t1c], sched.out_idx[t0c:t1c],
                    sched.valid[t0c:t1c], sched.reset[t0c:t1c], samp1, logp0,
                )
                loss_parts.append(ls)
                total_events += ec
            total_loss = float(torch.stack(loss_parts).sum()) if loss_parts else 0.0
            avgc = total_loss / max(total_events, 1.0)
            if np.isnan(avgc):
                # the reference aborts on a NaN cost (gru4rec.py:626-629)
                print(f"Epoch {epoch}: NaN error!")
                self.error_during_train = True
                self._train_state = state
                self.params = state.params
                return self
            dt = time.time() - t0
            self.epoch_stats.append(
                {"loss": avgc, "seconds": dt, "steps": T, "events": total_events})
            print(
                "Epoch{} --> loss: {:.6f} \t({:.2f}s) \t[{:.2f} mb/s | {:.0f} e/s]".format(
                    epoch + 1, avgc, dt, T / dt, total_events / dt
                )
            )
        self._train_state = state
        self.params = state.params
        return self
