"""Full-catalog ranking after the scores GEMM: the hand-written CUDA
kernel's wrapper (``csrc/score_rank.cu``) and its plain version.

The evaluation step (``eval/evaluation.py::make_eval_step``) scores every
lane against the whole catalog and ranks its target. After the GEMM's raw
logits ``x`` (B, N) come the bias add (``Wy[:, h]``), the final activation
over the real columns ``c < n_items``, the ``-inf`` mask of the padding
columns, the target's gather and the comparison counts. Eagerly those are
about twenty passes over the (B, N) float32 matrix; :func:`score_rank_cuda`
does them in one kernel call and returns the counts that
``ops/ranking.py::ranks_from_counts`` takes. It replaces no TPU kernel: the
JAX package leaves these passes to XLA's fusion.

Two modes, chosen by the final activation's name:

* ``softmax`` (and ``softmax_logit``, which ranks as ``softmax``): four
  kernels that read the matrix twice. The kernel computes each activated
  score as :func:`score_rank_plain` does (``expf`` and IEEE division, one
  rounding per operation) but for the order of the softmax's sum, so a
  count can differ from the plain one only by columns whose activated
  value lies within an ulp or so of the target's.
* an elementwise activation the kernel takes (:func:`elementwise_code`:
  ``linear``, ``relu``, ``leaky-<x>``, ``elu-<a>``, ``selu-<l>-<a>``,
  ``tanh``, ``sigmoid``): two kernels that read it once. Each activated
  score has the bits of the plain version's, and no sum is involved, so
  the counts are equal.

:func:`score_rank_plain` is the eager route's op sequence, unchanged:
``masked_softmax(x + b, valid)`` or the elementwise activation of ``x + b``
(``gru.activate``'s), the ``-inf`` mask, the gather and
``ranking.rank_counts``.

The evaluation step calls :func:`score_rank_cuda` only on the card (the
CPU keeps the eager ops); it launches the kernel or raises. It issues no
host synchronisation and launches on the current stream; its one scratch
tensor (the kernel's workspace) and the counts come from PyTorch's
allocator, so a captured step keeps them in its graph's pool.
``launches_by_mode`` counts calls on the card by tie mode, one per
evaluation step in either mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gru4rec_tpu_torch.ops.activations import get_activation, masked_softmax
from gru4rec_tpu_torch.ops.ranking import rank_counts

MODES = ("standard", "conservative", "median")  # the tie modes the kernel ranks
SOFTMAX = ("softmax", "softmax_logit")  # ranked as softmax (the predict path's swap)
_BIAS_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SECOND = {"standard": None, "conservative": 1, "median": 2}  # row of counts
# csrc/score_rank.cu enum Act, by name and number of parameters
_ELEMENTWISE = {"linear": (0, 0), "relu": (1, 0), "leaky": (2, 1), "elu": (3, 1),
                "selu": (4, 2), "tanh": (5, 0), "sigmoid": (6, 0)}

# Kernel calls by tie mode since the last reset.
launches_by_mode = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    for m in MODES:
        launches_by_mode[m] = 0


def elementwise_code(act: str):
    """``(code, p0, p1)`` of the elementwise activation ``act`` for the
    kernel (``ops/activations.py``'s names: ``elu-1`` is ``(3, 1.0,
    0.0)``), or None where the kernel does not take it."""
    name, *params = act.split("-")
    code, n = _ELEMENTWISE.get(name, (None, None))
    if code is None or len(params) != n:
        return None
    try:
        p = [float(v) for v in params]
    except ValueError:
        return None
    return (code, *p, *[0.0] * (2 - n))


def takes(act: str) -> bool:
    """Whether the kernel ranks under the final activation ``act``."""
    return act in SOFTMAX or elementwise_code(act) is not None


def score_rank_plain(logits, bias, n_items: int, tgt, mode: str, act: str = "softmax"):
    """The plain version: ``(gt, second)`` of each lane's target column
    ``tgt`` among the activated scores (``masked_softmax(logits + bias)``,
    or the elementwise ``act`` of ``logits + bias``) over the columns below
    ``n_items`` (``second``: the greater-or-equal count for
    ``conservative``, the equal count for ``median``, else None)."""
    item_valid = torch.arange(logits.shape[1], device=logits.device) < n_items
    if act in SOFTMAX:
        yhat = masked_softmax(logits + bias, item_valid)
    else:
        yhat = get_activation(act)(logits + bias)
    yhat = torch.where(item_valid, yhat, -torch.inf)
    target = yhat[torch.arange(logits.shape[0], device=logits.device), tgt]
    return rank_counts(yhat, target, mode)


def _functions():
    from gru4rec_tpu_torch.ops.kernels.build import load

    lib = load("score_rank")
    run, size = lib.gru4rec_score_rank, lib.gru4rec_score_rank_workspace_bytes
    run_ew, size_ew = lib.gru4rec_score_rank_ew, lib.gru4rec_score_rank_ew_workspace_bytes
    if run.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        run.argtypes = [p, p, ctypes.c_longlong, i, p, i, i, i, p, p, i, p]
        run_ew.argtypes = [p, p, ctypes.c_longlong, i, p, i, i, i, i, f, f, p, p, i, p]
        for fn in (run, run_ew):
            fn.restype = i
        for fn in (size, size_ew):
            fn.argtypes = [i, i]
            fn.restype = ctypes.c_size_t
    return run, size, run_ew, size_ew


@functools.lru_cache(maxsize=None)
def workspace_bytes(B: int, N: int, elementwise: bool = False) -> int:
    return int(_functions()[3 if elementwise else 1](B, N))


def _check(logits, bias, n_items: int, tgt, mode: str, act: str):
    """Raises on what the kernel does not take; returns the elementwise
    activation's ``(code, p0, p1)``, or None for a softmax."""
    if mode not in MODES:
        raise ValueError(f"no kernel for tie mode {mode!r}")
    code = None if act in SOFTMAX else elementwise_code(act)
    if act not in SOFTMAX and code is None:
        raise ValueError(f"no kernel for final activation {act!r}")
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
    return code


def _launch(logits, bias, n_items: int, tgt, counts, work, code) -> None:
    B, N = logits.shape
    vec = int(N % 4 == 0 and logits.data_ptr() % 16 == 0)
    head = (logits.data_ptr(), bias.data_ptr(), bias.stride(0), _BIAS_DTYPES[bias.dtype],
            tgt.data_ptr(), B, N, n_items)
    tail = (work.data_ptr(), counts.data_ptr(), vec,
            torch.cuda.current_stream(logits.device).cuda_stream)
    run, _, run_ew, _ = _functions()
    err = run(*head, *tail) if code is None else run_ew(*head, *code, *tail)
    if err != 0:
        raise RuntimeError(f"score_rank kernel launch failed: CUDA error {err}")


def score_rank_cuda(logits, bias, n_items: int, tgt, mode: str, act: str = "softmax"):
    """``(gt, second)`` for ``ranks_from_counts``, as
    :func:`score_rank_plain` gives them, from the kernel: each lane's
    target column ``tgt`` (B,) int32 ranked among the final activation
    ``act`` of ``logits + bias`` over the columns below ``n_items``.
    ``logits`` (B, N) float32 contiguous, ``bias`` (N,) float32 or bfloat16
    at any stride (``Wy[:, h]``), all on one CUDA device; each target must
    be a real column (below ``n_items``). Checks the tensors and the
    activation (:func:`takes`), then launches."""
    code = _check(logits, bias, n_items, tgt, mode, act)
    B, N = logits.shape
    counts = torch.empty((3, B), dtype=torch.int32, device=logits.device)  # gt, ge, eq
    work = torch.empty(workspace_bytes(B, N, code is not None), dtype=torch.uint8,
                       device=logits.device)
    _launch(logits, bias, n_items, tgt, counts, work, code)
    launches_by_mode[mode] += 1
    second = _SECOND[mode]
    return counts[0], None if second is None else counts[second]
