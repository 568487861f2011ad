"""Structured, pickle-free model checkpoints.

PyTorch counterpart of ``gru4rec_tpu/io/checkpoint.py``: one ``.npz``
archive with the same keys, so archives load across the two packages.

* ``param/{Wx,Wh,Wrz,Bh}{i}`` per layer, ``param/Wy`` and ``param/By``
  apart (the reference layout, no padding columns), ``param/E``;
* ``itemidmap/keys`` (string IDs as fixed-width unicode) and
  ``itemidmap/values``;
* ``meta/config`` (JSON), ``meta/n_items``; ``meta/epoch`` in training
  checkpoints, ``meta/opt_step`` in model archives with optimizer state;
* ``state/H{i}``, and ``state/step`` in training checkpoints;
* ``opt/{i}`` with ``opt_dtype/{i}``: the optimizer leaves in JAX's
  ``tree_flatten`` order (:func:`flatten_opt_state`);
* ``dtype/<key>``: bfloat16 arrays are stored as their uint16 bits with the
  tag ``"bfloat16"`` (npz cannot hold bfloat16).

The one key of its own is the random state. JAX stores its PRNG key
(``state/key``, ``state/key_typed``), which a ``torch.Generator`` cannot
continue; the port stores ``gen.get_state()`` as ``state/torch_gen``
(uint8) beside ``state/torch_gen_device``, the generator's device type.
Resume is exact for the port's own archives on the same device type. A JAX
training checkpoint, or a port archive from another device type (a CUDA
Philox state cannot be set into a CPU generator), resumes with its weights,
optimizer state, step and epoch, but with a generator seeded from
``cfg.seed``; :func:`load_train_checkpoint` prints one line that says so.
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd
import torch

from gru4rec_tpu_torch.config import GRU4RecConfig
from gru4rec_tpu_torch.models import gru
from gru4rec_tpu_torch.train.step import TrainState, init_train_state, make_generator

BF16 = "bfloat16"  # the dtype tag: numpy's name, as the JAX package writes it


def _to_numpy(t: torch.Tensor):
    """``(array, numpy dtype name)``; bfloat16 becomes its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, a.dtype.name


def _to_tensor(a: np.ndarray, dtype_name=None) -> torch.Tensor:
    """Inverse of :func:`_to_numpy` (on the CPU)."""
    if dtype_name == BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _squeeze3(t):
    return t[:, 0, :] if t.dim() == 3 else t


# ------------------------------------------------------------------ #
def flatten_opt_state(tree) -> list:
    """The leaves of an optimizer-state tree in JAX's ``tree_flatten``
    order: dict keys sorted, lists and tuples in order, ``None`` dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten_opt_state(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten_opt_state(v)]
    return [tree]


def unflatten_opt_state(template, leaves: list):
    """``template`` (the port's layout) with its leaves replaced, in
    :func:`flatten_opt_state` order, by ``leaves``."""
    it = iter(leaves)

    def fill(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            out = {k: fill(tree[k]) for k in sorted(tree)}
            return {k: out[k] for k in tree}  # the template's own key order
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        return next(it)

    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more optimizer leaves than the template holds")
    return out


def _from_saved(a: np.ndarray, like_dtype: torch.dtype, saved_dtype=None) -> torch.Tensor:
    """Decode an optimizer leaf: restore the dtype it was SAVED with, then
    cast to the template slot's dtype. ``saved_dtype=None`` means an archive
    written before dtype tagging: a uint16 entry is only acceptable there
    when the template slot itself is bf16 (anything else is ambiguous and
    raises rather than corrupt a resumed run)."""
    if saved_dtype is not None:
        t = _to_tensor(a, saved_dtype)
        return t.to(like_dtype) if t.dtype != like_dtype else t
    if a.dtype == np.uint16:
        if like_dtype == torch.bfloat16:
            return _to_tensor(a, BF16)
        raise ValueError(
            "checkpoint holds a bf16-encoded (uint16) optimizer slot but the "
            f"current optimizer layout expects {like_dtype} there; this archive "
            "predates dtype tagging and cannot be decoded safely — re-save it "
            "with the version that wrote it"
        )
    return _to_tensor(a)


def _decode_opt_leaves(archive, tmpl_leaves, what: str, device) -> list:
    """Decode every ``opt/<i>`` entry against the template's leaves: count
    check, saved-dtype decode (:func:`_from_saved`), per-leaf shape check
    (``gru4rec_tpu/io/checkpoint.py::_decode_opt_leaves``)."""
    n_saved = len([k for k in archive.files if k.startswith("opt/")])
    if n_saved != len(tmpl_leaves):
        raise ValueError(
            f"{what} stores {n_saved} optimizer-state arrays but the "
            f"current optimizer layout has {len(tmpl_leaves)} — the "
            "archive was written by a version with a different state "
            "layout and cannot be restored safely"
        )
    leaves = []
    for i, tmpl in enumerate(tmpl_leaves):
        saved = _from_saved(
            archive[f"opt/{i}"], tmpl.dtype,
            saved_dtype=(str(archive[f"opt_dtype/{i}"])
                         if f"opt_dtype/{i}" in archive.files else None),
        )
        if tuple(saved.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"optimizer-state array opt/{i} has shape {tuple(saved.shape)} "
                f"but the current layout expects {tuple(tmpl.shape)} — the "
                "archive was written by an incompatible version"
            )
        leaves.append(saved.to(device))
    return leaves


def _read_opt_state(archive, template, what: str, device):
    """The archive's optimizer state in the layout of ``template`` (a
    fresh ``TrainState`` of the archive's config)."""
    leaves = _decode_opt_leaves(archive, flatten_opt_state(template.opt_state), what,
                                device)
    return unflatten_opt_state(template.opt_state, leaves)


def _encode_opt_leaves(payload: dict, opt_state, squeeze: bool) -> None:
    for i, leaf in enumerate(flatten_opt_state(opt_state)):
        a, name = _to_numpy(_squeeze3(leaf) if squeeze else leaf)
        payload[f"opt/{i}"] = a
        payload[f"opt_dtype/{i}"] = np.array(name)


def _encode_payload(payload: dict) -> dict:
    """Final pass before ``np.savez``: tensors become numpy arrays, and a
    bfloat16 one is stored as its uint16 bits plus a ``dtype/<key>`` tag.
    Optimizer leaves arrive encoded already (uint16 + ``opt_dtype/<i>``)."""
    out = {}
    for k, v in payload.items():
        if isinstance(v, torch.Tensor):
            v, name = _to_numpy(v)
            if name == BF16:
                out[f"dtype/{k}"] = np.array(BF16)
        out[k] = v
    return out


def _decode_entry(archive, key) -> torch.Tensor:
    """An archive entry as a CPU tensor, bf16 restored from ``dtype/<key>``."""
    tag = f"dtype/{key}"
    return _to_tensor(archive[key],
                      str(archive[tag]) if tag in archive.files else None)


def _flatten_params(params) -> dict:
    flat = {}
    for group in ("Wx", "Wh", "Wrz", "Bh"):
        for i, t in enumerate(params[group]):
            flat[f"param/{group}{i}"] = _squeeze3(t)
    # bias folded at column h, then padding columns (models/gru.py):
    # archives hold the reference layout, Wy matrix and By vector apart
    wyb = _squeeze3(params["Wy"])
    h = _squeeze3(params["Wh"][-1]).shape[-1]
    flat["param/Wy"] = wyb[:, :h]
    flat["param/By"] = wyb[:, h]
    if "E" in params:
        flat["param/E"] = _squeeze3(params["E"])
    return flat


def _unflatten_params(archive, device) -> dict:
    params = {"Wx": [], "Wh": [], "Wrz": [], "Bh": []}
    n_layers = len([k for k in archive.files if k.startswith("param/Wh")])
    for i in range(n_layers):
        for group in ("Wx", "Wh", "Wrz", "Bh"):
            params[group].append(_decode_entry(archive, f"param/{group}{i}"))
    wy = _decode_entry(archive, "param/Wy")
    h = wy.shape[1]
    wyb = torch.zeros((wy.shape[0], gru.pad_cols(h + 1)), dtype=wy.dtype)
    wyb[:, :h] = wy
    wyb[:, h] = _decode_entry(archive, "param/By")
    params["Wy"] = wyb
    if "param/E" in archive.files:
        params["E"] = _decode_entry(archive, "param/E")
    return gru.map_params(lambda t: t.to(device), params)


def _itemidmap_payload(model) -> dict:
    keys = np.asarray(model.itemidmap.index.values)
    if keys.dtype.kind not in "iufb":
        # string item IDs: fixed-width unicode, not pickled objects
        keys = np.asarray(keys, dtype=str)
    return {"itemidmap/keys": keys, "itemidmap/values": model.itemidmap.values}


def _read_model_meta(archive, model) -> None:
    model.n_items = int(archive["meta/n_items"])
    model.itemidmap = pd.Series(
        data=archive["itemidmap/values"], index=archive["itemidmap/keys"],
        name="ItemIdx",
    )


def _read_config(archive) -> GRU4RecConfig:
    return GRU4RecConfig.from_dict(json.loads(str(archive["meta/config"])))


def _is_primary_process() -> bool:
    """Checkpoint files are written by rank 0 only (on a shared filesystem
    every rank would otherwise race-write the same path); every rank loads.
    True when ``torch.distributed`` is not initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return True
    return dist.get_rank() == 0


def _write_barrier(name: str) -> None:
    """Barrier after a rank-0-only write, so that no other rank reads the
    file before it is complete. A no-op unless ``torch.distributed`` is
    initialized with more than one rank."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ------------------------------------------------------------------ #
def save_model(model, fname: str, include_optimizer: bool = False) -> None:
    """Serialize a trained model, and with ``include_optimizer`` its
    optimizer state and step (leaves stored as they are, unsqueezed, as the
    JAX package's ``save_model`` does)."""
    if not _is_primary_process():
        _write_barrier("gru4rec_save_model")
        return
    payload = _flatten_params(model.params)
    payload.update(_itemidmap_payload(model))
    payload["meta/config"] = np.array(json.dumps(model.config.to_dict()))
    payload["meta/n_items"] = np.array(model.n_items)
    if model.H is not None:
        for i, h in enumerate(model.H):
            payload[f"state/H{i}"] = h
    if include_optimizer and model._train_state is not None:
        _encode_opt_leaves(payload, model._train_state.opt_state, squeeze=False)
        payload["meta/opt_step"] = np.asarray(model._train_state.step, dtype=np.int32)
    np.savez(fname, **_encode_payload(payload))
    _write_barrier("gru4rec_save_model")


def save_train_checkpoint(model, state: TrainState, epoch: int, fname: str) -> None:
    """Full training checkpoint: parameters, optimizer state (leaves
    squeezed, as the JAX package's), hidden state, the generator's state,
    the step counter and the epoch — everything an exact resume needs."""
    if not _is_primary_process():
        _write_barrier("gru4rec_save_ckpt")
        return
    payload = _flatten_params(state.params)
    _encode_opt_leaves(payload, state.opt_state, squeeze=True)
    for i, h in enumerate(state.H):
        payload[f"state/H{i}"] = h
    payload["state/torch_gen"] = state.gen.get_state().numpy()
    payload["state/torch_gen_device"] = np.array(state.gen.device.type)
    payload["state/step"] = np.asarray(state.step, dtype=np.int32)
    payload["meta/epoch"] = np.array(epoch)
    payload["meta/config"] = np.array(json.dumps(model.config.to_dict()))
    payload["meta/n_items"] = np.array(model.n_items)
    payload.update(_itemidmap_payload(model))
    np.savez(fname, **_encode_payload(payload))
    _write_barrier("gru4rec_save_ckpt")


def load_train_checkpoint(fname: str, model, device=None, gen_device=None):
    """Restore a training checkpoint into ``model`` (its config, catalog,
    parameters and training state, on ``device``, by default
    ``model.device``, with the generator on ``gen_device``, by default the
    same; ``fit(mesh=)`` loads the canonical state to the CPU and the
    generator to the mesh's device); returns ``(state, epoch)``.

    The generator continues exactly when the archive holds a port
    generator state of its device's type. Otherwise (a JAX archive,
    or one written on another device type) it is seeded from ``cfg.seed``
    and one line says so: weights, optimizer state, step and epoch are
    restored all the same, but the negatives and dropout masks of the
    resumed epochs are not the ones an uninterrupted run would draw."""
    device = torch.device(model.device if device is None else device)
    gen_device = device if gen_device is None else torch.device(gen_device)
    with np.load(fname, allow_pickle=False) as archive:
        cfg = _read_config(archive)
        model.config = cfg
        _read_model_meta(archive, model)
        params = _unflatten_params(archive, device)
        template = init_train_state(cfg, model.n_items, device)
        gen = make_generator(cfg.seed, gen_device)
        opt_state = _read_opt_state(archive, template, "checkpoint", device)
        H = [_decode_entry(archive, f"state/H{i}").to(device)
             for i in range(len(cfg.layers))]
        saved_dev = (str(archive["state/torch_gen_device"])
                     if "state/torch_gen_device" in archive.files else None)
        if saved_dev == gen_device.type:
            gen.set_state(torch.from_numpy(archive["state/torch_gen"].copy()))
        else:
            print(f"Resume: {fname} holds no generator state for "
                  f"{gen_device.type} ({'JAX PRNG key' if saved_dev is None else saved_dev}"
                  f" archive); negatives and dropout continue from a generator "
                  f"seeded with cfg.seed={cfg.seed}")
        state = TrainState(params, opt_state, H, gen, int(archive["state/step"]))
        epoch = int(archive["meta/epoch"])
    model.params = params
    model._train_state = state
    model.error_during_train = False
    return state, epoch


def load_model(fname: str, make_model):
    """Reconstruct a model from an archive; ``make_model(cfg)`` builds the
    empty model (and so picks the device). An archive with optimizer
    entries (``savemodel(include_optimizer=True)``) restores the training
    state too, so ``fit(retrain=True)`` continues with the real
    accumulators."""
    with np.load(fname, allow_pickle=False) as archive:
        cfg = _read_config(archive)
        model = make_model(cfg)
        device = model.device
        model.params = _unflatten_params(archive, device)
        _read_model_meta(archive, model)
        n_layers = len(cfg.layers)
        if all(f"state/H{i}" in archive.files for i in range(n_layers)):
            model.H = [_decode_entry(archive, f"state/H{i}").to(device)
                       for i in range(n_layers)]
        if any(k.startswith("opt/") for k in archive.files):
            template = init_train_state(cfg, model.n_items, device)
            step = (int(archive["meta/opt_step"]) if "meta/opt_step" in archive.files
                    else template.step)
            model._train_state = TrainState(
                model.params, _read_opt_state(archive, template, "model archive", device),
                template.H, template.gen, step)
        model.error_during_train = False
    return model
