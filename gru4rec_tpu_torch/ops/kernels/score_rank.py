"""Full-catalog ranking after the scores GEMM: the hand-written CUDA
kernel's wrapper (``csrc/score_rank.cu``) and its plain version.

The evaluation step (``eval/evaluation.py::make_eval_step``) scores every
lane against the whole catalog and ranks its target. After the GEMM's raw
logits ``x`` (B, N) come the bias add (``Wy[:, h]``), the masked softmax
over the real columns ``c < n_items``, the ``-inf`` mask of the padding
columns, the target's gather and the comparison counts. Eagerly those are
about twenty passes over the (B, N) float32 matrix; :func:`score_rank_cuda`
does them in one kernel call that reads it twice and returns the counts
that ``ops/ranking.py::ranks_from_counts`` takes. It replaces no TPU
kernel: the JAX package leaves these passes to XLA's fusion.

:func:`score_rank_plain` is today's op sequence, unchanged:
``masked_softmax(x + b, valid)``, the mask, the gather and
``ranking.rank_counts``. The kernel computes each activated score as it
does (``expf`` and IEEE division, one rounding per operation) but for the
order of the softmax's sum, so a count can differ from the plain one only
by columns whose activated value lies within an ulp or so of the target's.

The evaluation step calls :func:`score_rank_cuda` only on the card (the
CPU keeps the eager ops); it launches the kernel or raises. It issues no
host synchronisation and launches on the current stream; its one scratch
tensor (the kernel's workspace) and the counts come from PyTorch's
allocator, so a captured step keeps them in its graph's pool.
``launches_by_mode`` counts calls on the card by tie mode, one per
evaluation step (each call is four kernels).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gru4rec_tpu_torch.ops.activations import masked_softmax
from gru4rec_tpu_torch.ops.ranking import rank_counts

MODES = ("standard", "conservative", "median")  # the tie modes the kernel ranks
_BIAS_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SECOND = {"standard": None, "conservative": 1, "median": 2}  # row of counts

# Kernel calls by tie mode since the last reset.
launches_by_mode = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    for m in MODES:
        launches_by_mode[m] = 0


def score_rank_plain(logits, bias, n_items: int, tgt, mode: str):
    """The plain version: ``(gt, second)`` of each lane's target column
    ``tgt`` among the activated scores ``masked_softmax(logits + bias)``
    over the columns below ``n_items`` (``second``: the greater-or-equal
    count for ``conservative``, the equal count for ``median``, else
    None)."""
    item_valid = torch.arange(logits.shape[1], device=logits.device) < n_items
    yhat = masked_softmax(logits + bias, item_valid)
    yhat = torch.where(item_valid, yhat, -torch.inf)
    target = yhat[torch.arange(logits.shape[0], device=logits.device), tgt]
    return rank_counts(yhat, target, mode)


def _functions():
    from gru4rec_tpu_torch.ops.kernels.build import load

    lib = load("score_rank")
    run, size = lib.gru4rec_score_rank, lib.gru4rec_score_rank_workspace_bytes
    if run.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        run.argtypes = [p, p, ctypes.c_longlong, i, p, i, i, i, p, p, i, p]
        run.restype = i
        size.argtypes = [i, i]
        size.restype = ctypes.c_size_t
    return run, size


@functools.lru_cache(maxsize=None)
def workspace_bytes(B: int, N: int) -> int:
    return int(_functions()[1](B, N))


def _check(logits, bias, n_items: int, tgt, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"no kernel for tie mode {mode!r}")
    if logits.dim() != 2 or logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous 2-D float32 tensor, got "
                         f"{logits.dtype} {tuple(logits.shape)} strides {logits.stride()}")
    B, N = logits.shape
    if not 0 < n_items <= N:
        raise ValueError(f"n_items must lie in [1, {N}], got {n_items}")
    if bias.dim() != 1 or bias.shape[0] != N or bias.dtype not in _BIAS_DTYPES:
        raise ValueError(f"bias must be ({N},) float32/bfloat16, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if tgt.dim() != 1 or tgt.shape[0] != B or tgt.dtype != torch.int32 or not tgt.is_contiguous():
        raise ValueError(f"tgt must be a contiguous ({B},) int32 tensor, got {tgt.dtype} "
                         f"{tuple(tgt.shape)}")
    for t in (bias, tgt):
        if t.device != logits.device:
            raise ValueError("all tensors must lie on the logits' device")


def _launch(logits, bias, n_items: int, tgt, counts, work) -> None:
    B, N = logits.shape
    vec = int(N % 4 == 0 and logits.data_ptr() % 16 == 0)
    err = _functions()[0](
        logits.data_ptr(), bias.data_ptr(), bias.stride(0), _BIAS_DTYPES[bias.dtype],
        tgt.data_ptr(), B, N, n_items, work.data_ptr(), counts.data_ptr(), vec,
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_rank kernel launch failed: CUDA error {err}")


def score_rank_cuda(logits, bias, n_items: int, tgt, mode: str):
    """``(gt, second)`` for ``ranks_from_counts``, as
    :func:`score_rank_plain` gives them, from the kernel: each lane's
    target column ``tgt`` (B,) int32 ranked among the softmax of ``logits +
    bias`` over the columns below ``n_items``. ``logits`` (B, N) float32
    contiguous, ``bias`` (N,) float32 or bfloat16 at any stride
    (``Wy[:, h]``), all on one CUDA device; each target must be a real
    column (below ``n_items``). Checks the tensors, then launches."""
    _check(logits, bias, n_items, tgt, mode)
    B, N = logits.shape
    counts = torch.empty((3, B), dtype=torch.int32, device=logits.device)  # gt, ge, eq
    work = torch.empty(workspace_bytes(B, N), dtype=torch.uint8, device=logits.device)
    _launch(logits, bias, n_items, tgt, counts, work)
    launches_by_mode[mode] += 1
    second = _SECOND[mode]
    return counts[0], None if second is None else counts[second]

