"""Fused row-sparse optimizer update: the hand-written CUDA kernel's wrapper.

Replaces the JAX package's Pallas TPU kernels in
``gru4rec_tpu/ops/kernels/sparse_update.py`` with ``csrc/sparse_update.cu``:
one pass over the touched rows of a float32 table that sums duplicate-index
gradients and applies adagrad / rmsprop / adadelta / adam with momentum and
L2, updating the table, its state and its velocity in place. The state
layouts are the JAX package's (``train/optimizers.py`` ``init_state``).
One kernel serves the four TPU kernels, by mode:

* K1 ``_fused_update_v3`` (non-SR): widths that are multiples of 128;
* K2 ``_fused_update_v3`` with ``sr_seed``: stochastically rounded bfloat16
  state (``opt_state_dtype="bfloat16_sr"``), adagrad;
* K3 ``fused_update_v4``, the same kernel fed compact deduped gradients,
  which JAX uses only for adam with SR state: here SR adam. The port's
  kernel always sums duplicates itself, so "compact" is what every mode
  does;
* K4 ``_fused_update``, the v2 grid (non-SR, any width): other widths.

``launches_by_mode`` counts the launches of each mode. A captured CUDA
graph replays a launch without calling the wrapper again, so
``utils/cuda_graph.py`` adds the captured call's tally on each replay.

A call is one device operation: the kernel takes the raw int32 or int64
indices as they are (no sort, cast, fill or scratch tensor) and dedups them
itself. One warp per raw position; the warp whose index is a real row
([0, n_rows): the int32-max sentinel and padding rows are dropped) that no
earlier position holds is the run head, and sums the gradient rows of every
position holding its row in ascending position (the order of a stable
sort, as the plain version sums them), then updates the row. The kernel is
memory-bound (see the source's header). The wrapper allocates nothing,
issues no host synchronisation and launches on the current stream; it picks
the kernel's vector path (:func:`vector_path`) from the tensors' pitches and
pointers.

Tensors on the CPU take the plain version, ``Optimizer.apply_sparse_plain``
(the torch-op path). A CUDA tensor always launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

EPSILON = 1e-6
_ADAPT_CODES = {"adagrad": 0, "rmsprop": 1, "adadelta": 2, "adam": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

MODES = ("K1", "K2", "K3", "K4")
VEC = 4  # columns per access on the kernel's vector path

# Launches of the kernel by mode since the last reset (one per call on the
# card).
launches_by_mode = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    for m in MODES:
        launches_by_mode[m] = 0


def mode_of(adapt: str, d: int, sr: bool) -> str:
    """The TPU kernel that a launch of this kind stands for (module doc)."""
    if sr:
        return "K3" if adapt == "adam" else "K2"
    return "K1" if d % 128 == 0 else "K4"


def log_decay(v: float) -> float:
    """log of a decay constant for adam's bias correction 1 - v^c =
    -expm1(c ln v); v = 0 maps to -inf, for which -expm1(c * -inf) = 1 =
    the correct 1 - 0^c."""
    return math.log(v) if v > 0 else -math.inf


def _function():
    from gru4rec_tpu_torch.ops.kernels.build import load

    fn = load("sparse_update").gru4rec_sparse_update
    if fn.argtypes is None:
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        fn.argtypes = [i, i, i, i, u, p, u, p, p, i, i, p, i, i, p, i, p, i,
                       f, f, f, f, f, f, f, f, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def vector_path(*tensors) -> bool:
    """Whether the kernel may take its vector path for these 2-D tensors
    (gradient, table, state, velocity): each row pitch and base pointer a
    multiple of ``VEC`` elements, i.e. 16 bytes for float32 and 8 for
    bfloat16, so that a lane reads and writes ``VEC`` columns at once."""
    return all(t.shape[-1] % VEC == 0 and t.data_ptr() % (VEC * t.element_size()) == 0
               for t in tensors)


def _check(opt, table, idx, g, st, sr=False):
    adapt = opt.adapt
    if adapt not in _ADAPT_CODES:
        raise ValueError(f"no fused kernel for adapt={adapt!r}")
    if sr and adapt not in ("adagrad", "adam"):
        raise ValueError(f"stochastic-rounding state is adagrad/adam only, not {adapt!r}")
    key = "acc2" if adapt in ("adam", "adadelta") else "acc"
    if key not in st:
        raise ValueError(f"the kernel takes the merged {key!r} state layout; "
                         f"got state keys {sorted(st)}")
    state, vel = st[key], st.get("velocity")
    tensors = [table, idx, g, state] + ([vel] if vel is not None else [])
    for t in tensors:
        if t.device != table.device:
            raise ValueError("all tensors must lie on the table's device")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be 2-D float32, got {table.dtype} {tuple(table.shape)}")
    n, d = table.shape
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[1] != d:
        raise ValueError(f"gradient must be (K, {d}) float32, got {g.dtype} {tuple(g.shape)}")
    if idx.dim() != 1 or idx.shape[0] != g.shape[0]:
        raise ValueError("idx must be 1-D with one index per gradient row")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be an integer tensor, got {idx.dtype}")
    ds = {"adam": 2 * d + 128, "adadelta": 2 * d}.get(adapt, d)
    if state.shape != (n, ds) or state.dtype not in _DTYPE_CODES:
        raise ValueError(f"{adapt} state must be ({n}, {ds}) float32/bfloat16, "
                         f"got {state.dtype} {tuple(state.shape)}")
    if sr and state.dtype != torch.bfloat16:
        raise ValueError(f"stochastic rounding stores bfloat16 state, got {state.dtype}")
    if (vel is None) != (opt.momentum <= 0):
        raise ValueError("velocity state must be present exactly when momentum > 0")
    if vel is not None and (vel.shape != (n, d) or vel.dtype not in _DTYPE_CODES):
        raise ValueError(f"velocity must be ({n}, {d}) float32/bfloat16, "
                         f"got {vel.dtype} {tuple(vel.shape)}")
    return state, vel


def fused_update(opt, table, idx, g, st, sr_seed=None):
    """Row-sparse update of ``table`` (n, d) at the K (possibly duplicated,
    sentinel-masked) indices ``idx`` with gradient rows ``g`` (K, d), under
    the hyperparameters of ``opt`` (a ``train.optimizers.Optimizer``).
    Updates ``table`` and the state dict ``st`` in place and returns them.
    Indices >= n (the int32-max sentinel of masked lanes) are dropped.
    ``sr_seed`` = (seed, global row offset) keys the dither of
    stochastically rounded state (``Optimizer.apply_sparse``). The offset
    goes to the kernel by value, and so does the seed when it is an int; a
    seed that is a 0-d int32 tensor on the table's device is read there by
    the kernel, so a captured step replays with each step's seed."""
    if table.device.type == "cpu":
        return opt.apply_sparse_plain(table, idx, g, st, sr_seed=sr_seed)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    sr_seed = opt.sr_seed_for(st, sr_seed)
    sr = sr_seed is not None
    state, vel = _check(opt, table, idx, g, st, sr)
    n, d = table.shape
    K = idx.shape[0]
    if K == 0:
        return table, st
    seed, row_offset = sr_seed if sr else (0, 0)
    seed_ptr = None
    if torch.is_tensor(seed):
        if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != table.device:
            raise ValueError("a device seed must be one int32 on the table's device, got "
                             f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
        seed_ptr, seed = seed.data_ptr(), 0
    rows = [g, table, state] + ([vel] if vel is not None else [])
    err = _function()(
        _ADAPT_CODES[opt.adapt], _DTYPE_CODES[state.dtype],
        -1 if vel is None else _DTYPE_CODES[vel.dtype],
        # SR mode: 1 rounds the slow slot, 2 also adam's first moment
        (2 if opt.sr_first_moment else 1) if sr else 0,
        seed & 0xFFFFFFFF, seed_ptr, row_offset & 0xFFFFFFFF,
        g.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), K,
        table.data_ptr(), n, d, state.data_ptr(), state.shape[1],
        None if vel is None else vel.data_ptr(), int(vector_path(*rows)),
        opt.lr, opt.momentum, opt.lmbd, opt.v1, 1.0 - opt.v1, opt.v2,
        1.0 - opt.v2, log_decay(opt.v1), log_decay(opt.v2), EPSILON,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sparse_update kernel launch failed: CUDA error {err}")
    launches_by_mode[mode_of(opt.adapt, d, sr)] += 1
    return table, st
