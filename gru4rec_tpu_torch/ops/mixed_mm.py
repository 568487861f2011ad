"""Mixed-precision matrix product: bfloat16 operands, float32 accumulation
and a float32 result.

The port's counterpart of the JAX package's ``_make_mm`` with
``compute_dtype="bfloat16"`` (``gru4rec_tpu/models/gru.py:143-160``):
``dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)``, the
TPU's native MXU pass, at every product of the model (the GRU cell, the
input projection and the scores, in training, evaluation and serving).

On the card it runs on the H100's bf16 tensor cores (``_MixedMM``):

* **forward**: both operands rounded to bfloat16 (a bfloat16 operand, such
  as a table cast by ``cast_for_serving``, enters as it is) and multiplied
  by one cuBLAS GEMM with float32 accumulation and a float32 result
  (``torch.mm(..., out_dtype=torch.float32)``, ``aten::mm.dtype``). A
  product of two bfloat16 values is exact in float32, so the result differs
  from the plain version's only in the order of the float32 sums.
* **backward**: JAX's transpose of each operand is ``dot(g, other_bf16,
  preferred_element_type=f32)`` with the float32 cotangent ``g`` multiplied
  in full, then rounded to bfloat16 (``astype``'s transpose) and widened
  again. The tensor cores take bfloat16 only, so ``g`` is split into three
  bfloat16 terms whose sum is exactly ``g`` (:func:`split_bf16x3`, the
  bf16_3x scheme behind XLA's ``Precision.HIGH``), and the three terms are
  multiplied against the other operand in one GEMM whose depth is tripled
  (``[g3|g2|g1] @ [b;b;b]``, the small terms first, so that they add up
  before the large ones reach the float32 accumulator). Every product in
  it is exact in float32; the sum is rounded to bfloat16 as JAX's is.

What bounds it on the card: the full-catalog scores of evaluation and
serving (512 x 512 x 200,064 at rees46) move more bytes than the tensor
cores need time for (the float32 table read, its bfloat16 copy, the float32
scores written); the training products are small and bound by launches.

On the CPU (a tensor that lies there) :func:`mixed_mm` takes the plain
version, :func:`mixed_mm_plain`: the operands rounded to bfloat16, widened
back and multiplied in float32, the arithmetic JAX's XLA:CPU dot does. A
CUDA tensor always takes the tensor-core route and raises where that
cannot run; it never takes the plain version.

``launches_by_mode`` counts the GEMMs the route issues: ``forward`` one
per product, ``backward`` one per operand gradient. A captured CUDA graph
replays them without calling the wrapper; ``utils/cuda_graph.py`` adds the
captured call's count on each replay.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16

MODES = ("forward", "backward")

# Tensor-core GEMMs issued by mode since the last reset.
launches_by_mode = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    for m in MODES:
        launches_by_mode[m] = 0


def split_bf16x3(g: torch.Tensor):
    """A float32 tensor as three bfloat16 terms ``(g1, g2, g3)``, largest
    first: ``g1 = bf16(g)``, ``g2 = bf16(g - g1)``, ``g3 = bf16(g - g1 -
    g2)``. Each subtraction is exact in float32 and leaves at most 16, then
    8 significant bits, so ``g1 + g2 + g3 == g`` exactly wherever ``g3``
    is a normal number (``|g|`` above about 1e-33) and ``g1`` does not
    overflow."""
    g1 = g.to(BF16)
    r = g - g1
    g2 = r.to(BF16)
    g3 = (r - g2).to(BF16)
    return g1, g2, g3


def mixed_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the operands rounded to bfloat16, widened back and
    multiplied in float32 (autograd rounds each operand's gradient to
    bfloat16 through the casts, as JAX's transpose does)."""
    return torch.matmul(a.to(BF16).float(), b.to(BF16).float())


def _tc_mm(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """One bf16 x bf16 -> float32 tensor-core GEMM."""
    return torch.mm(a16, b16, out_dtype=torch.float32)


class _MixedMM(torch.autograd.Function):
    """``a @ b`` with bfloat16 operands on the tensor cores (module doc)."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(BF16), b.to(BF16)
        ctx.save_for_backward(a16, b16)
        ctx.dtypes = (a.dtype, b.dtype)
        out = _tc_mm(a16, b16)
        launches_by_mode["forward"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad[:2]
        terms = split_bf16x3(g.float())[::-1]  # g3, g2, g1
        ga = gb = None
        if need_a:  # (M, N) @ (N, K), the depth N tripled
            ga = _tc_mm(torch.cat(terms, 1), torch.cat([b16] * 3, 1).T)
            launches_by_mode["backward"] += 1
            ga = ga.to(BF16).to(ctx.dtypes[0])
        if need_b:  # (K, M) @ (M, N), the depth M tripled
            gb = _tc_mm(torch.cat([a16] * 3, 0).T, torch.cat(terms, 0))
            launches_by_mode["backward"] += 1
            gb = gb.to(BF16).to(ctx.dtypes[1])
        return ga, gb


def mixed_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with bfloat16 operands and float32 accumulation and
    result: the tensor-core route for CUDA tensors, the plain version for
    CPU tensors."""
    if a.is_cuda or b.is_cuda:
        return _MixedMM.apply(a, b)
    return mixed_mm_plain(a, b)
