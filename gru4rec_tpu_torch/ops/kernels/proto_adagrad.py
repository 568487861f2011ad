"""Row-sparse adagrad prototypes P1 and P2: the hand-written CUDA kernels' wrappers.

Replaces the Pallas TPU kernels of the repo's two measurement scripts with
``csrc/proto_adagrad.cu``, both adagrad with no momentum and no L2 on
float32 tables (per distinct row, with ``g`` its summed duplicate gradient
rows: ``a += g * g; t -= lr * g / sqrt(a + eps)``):

* P1 ``merged_adagrad`` (``scripts/proto_merged_kernel.py:31``): table and
  accumulator in one (n, 2d) buffer whose row is ``[t | a]``; one warp per
  raw position stages its row's contiguous ``[t | a]`` span in shared
  memory in the widest access the alignment allows;
* P2 ``v3_adagrad`` (``scripts/proto_v3_kernel.py:63``): separate (n, d)
  table and accumulator; each block finds the heads of its own tile of raw
  positions and its warps loop over only those, through a ``cp.async``
  ring of shared-memory slots.

Both are bound by bytes (the source's header). A call is one device
operation: the kernel takes the raw int32 or int64 indices (no sort, cast,
fill or scratch tensor) and dedups them itself with the row-sparse
kernel's pass (``csrc/dedup.cuh``), summing each row's duplicate gradient
rows in ascending raw position, the order of a stable sort, so the results
equal ``proto_measure.exact_adagrad`` bit for bit. The wrappers allocate
nothing, issue no host synchronisation and launch on the current stream;
they pick each access's width from the
tensors' pitches and pointers (:func:`access_width`). Indices outside
[0, n_rows) (the int32-max sentinel of masked lanes) are dropped; every row
up to ``n_rows - 1`` is updated. No package entry point calls them; their
path is the measurement of ``ops/kernels/proto_measure.py``
(``scripts/proto_*_torch.py``).

Tensors on the CPU take the plain versions, :func:`merged_adagrad_plain`
and :func:`v3_adagrad_plain` (torch ops: dedup with ``index_add_``, then
``Optimizer.apply_sparse_plain``'s adagrad). A CUDA tensor always launches
the kernel or raises. ``launches_by_mode`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gru4rec_tpu_torch.ops.kernels.sparse_update import EPSILON

MODES = ("P1", "P2")

# Launches of each kernel since the last reset (one per call on the card).
launches_by_mode = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    for m in MODES:
        launches_by_mode[m] = 0


def _lib():
    from gru4rec_tpu_torch.ops.kernels.build import load

    lib = load("proto_adagrad")
    if lib.gru4rec_merged_adagrad.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gru4rec_merged_adagrad.argtypes = [p, p, i, i, p, i, i, i, i, f, f, p]
        lib.gru4rec_v3_adagrad.argtypes = [p, p, i, i, p, p, i, i, i, i, f, f, p]
        lib.gru4rec_v3_blocks_per_sm.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        lib.gru4rec_v3_tile.argtypes = [i, i]
        lib.gru4rec_v3_warps.argtypes = []
        for fn in (lib.gru4rec_merged_adagrad, lib.gru4rec_v3_adagrad,
                   lib.gru4rec_v3_blocks_per_sm, lib.gru4rec_v3_tile,
                   lib.gru4rec_v3_warps):
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def persistent_grid(device_index: int, d: int) -> int:
    """P2's grid capacity at width ``d``, derived once per card and width:
    the blocks resident on one SM at once (at most the kernel's
    ``kMaxBlocksPerSM``), times ``multi_processor_count``. One wave of
    that many blocks covers a call (:func:`v3_tile`)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().gru4rec_v3_blocks_per_sm(d, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"v3_adagrad cannot run at width {d}: CUDA error {err}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value * torch.cuda.get_device_properties(device_index).multi_processor_count


def v3_tile(K: int, grid: int) -> int:
    """P2's raw positions per block for K positions on a grid capacity of
    ``grid`` blocks (the kernel's rule); the launch has ceil(K / tile)
    blocks."""
    return _lib().gru4rec_v3_tile(K, grid)


def v3_warps() -> int:
    """P2's warps per block."""
    return _lib().gru4rec_v3_warps()


def access_width(*tensors) -> int:
    """The widest access, 16, 8 or 4 bytes, that every row pitch and base
    pointer of these 2-D float32 tensors allows: the kernels then copy and
    store each row in accesses of that width with every row start aligned,
    so no row needs a peeled head or tail."""
    for w in (16, 8):
        if all(t.shape[-1] * t.element_size() % w == 0 and t.data_ptr() % w == 0
               for t in tensors):
            return w
    return 4


def _check(tables, idx, g, d):
    for t in (*tables, idx, g):
        if t.device != tables[0].device:
            raise ValueError("all tensors must lie on the table's device")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    for t in tables:
        if t.dim() != 2 or t.dtype != torch.float32:
            raise ValueError(f"tables must be 2-D float32, got {t.dtype} {tuple(t.shape)}")
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[1] != d:
        raise ValueError(f"gradient must be (K, {d}) float32, got {g.dtype} {tuple(g.shape)}")
    if idx.dim() != 1 or idx.shape[0] != g.shape[0]:
        raise ValueError("idx must be 1-D with one index per gradient row")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be an integer tensor, got {idx.dtype}")


def _on_card(t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _dedup(idx, g, n_rows):
    """The distinct real rows of ``idx`` and their summed gradient rows;
    ``index_add_`` adds each row's duplicates in index order, which is the
    kernels' stable-sorted order."""
    keep = (idx >= 0) & (idx < n_rows)
    rows, inv = torch.unique(idx[keep].long(), return_inverse=True)
    gsum = torch.zeros((rows.numel(), g.shape[1]), dtype=g.dtype, device=g.device)
    return rows, gsum.index_add_(0, inv, g[keep])


def _adagrad(t, a, g, lr):
    """``Optimizer.apply_sparse_plain``'s adagrad with no momentum and no L2."""
    a = a + g**2
    return t - lr * (g / torch.sqrt(a + EPSILON)), a


def merged_adagrad_plain(merged, idx, g, lr):
    """P1's plain version: updates ``merged`` (n, 2d) = [t | a] in place."""
    d = merged.shape[1] // 2
    rows, gsum = _dedup(idx, g, merged.shape[0])
    m = merged[rows]
    t, a = _adagrad(m[:, :d], m[:, d:], gsum, lr)
    merged[rows] = torch.cat([t, a], dim=1)
    return merged


def v3_adagrad_plain(table, acc, idx, g, lr):
    """P2's plain version: updates ``table`` and ``acc`` (n, d) in place."""
    rows, gsum = _dedup(idx, g, table.shape[0])
    t, a = _adagrad(table[rows], acc[rows], gsum, lr)
    table[rows] = t
    acc[rows] = a
    return table, acc


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def merged_adagrad(merged, idx, g, lr):
    """P1: adagrad on the merged (n, 2d) float32 buffer ``[t | a]`` at the K
    (possibly duplicated, sentinel-masked) int32 or int64 indices ``idx``
    with gradient rows ``g`` (K, d), in place. Returns ``merged``."""
    if not _on_card(merged):
        return merged_adagrad_plain(merged, idx, g, lr)
    n, d2 = merged.shape
    if d2 % 2:
        raise ValueError(f"the merged buffer's width must be even, got {d2}")
    _check((merged,), idx, g, d2 // 2)
    K = idx.shape[0]
    if K == 0:
        return merged
    err = _lib().gru4rec_merged_adagrad(
        g.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), K,
        merged.data_ptr(), n, d2 // 2, access_width(merged), access_width(g), lr,
        EPSILON, _stream(merged))
    if err != 0:
        raise RuntimeError(f"merged_adagrad kernel launch failed: CUDA error {err}")
    launches_by_mode["P1"] += 1
    return merged


def v3_adagrad(table, acc, idx, g, lr):
    """P2: adagrad on ``table`` and ``acc`` (n, d) float32 at the K int32 or
    int64 indices ``idx`` with gradient rows ``g`` (K, d), in place.
    Returns ``(table, acc)``."""
    if not _on_card(table):
        return v3_adagrad_plain(table, acc, idx, g, lr)
    n, d = table.shape
    if acc.shape != table.shape:
        raise ValueError(f"acc must be {tuple(table.shape)}, got {tuple(acc.shape)}")
    _check((table, acc), idx, g, d)
    K = idx.shape[0]
    if K == 0:
        return table, acc
    tile = v3_tile(K, persistent_grid(table.device.index, d))
    err = _lib().gru4rec_v3_adagrad(
        g.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), K,
        table.data_ptr(), acc.data_ptr(), n, d, access_width(table, acc, g), tile, lr,
        EPSILON, _stream(table))
    if err != 0:
        raise RuntimeError(f"v3_adagrad kernel launch failed: CUDA error {err}")
    launches_by_mode["P2"] += 1
    return table, acc
