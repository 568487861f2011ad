"""Stochastic rounding to bfloat16 with a stateless counter-based hash.

PyTorch counterpart of ``gru4rec_tpu/ops/sr.py``. Optimizer state stored in
bfloat16 with round-to-nearest freezes once its per-step increments drop
below half a bf16 ulp (adam's v2 = 0.999 second moment, adagrad's late g^2
increments). Stochastic rounding keeps the stored value an unbiased
estimate of the float32 one, so ``opt_state_dtype="bfloat16_sr"`` can store
that state in bfloat16.

The dither bits come from a murmur3 finalizer over ``(seed, table row,
column)``. The same hash runs in the CUDA kernel (``csrc/sparse_update.cu``)
and in the JAX package, so the kernel, the plain version here and the JAX
package store bit-identical state for the same seed. JAX computes it in
wrapping int32; torch promises no wrapping int32 multiply and shifts int32
arithmetically, so this module computes in int64 holding uint32 values
(masked to 32 bits, logical shifts, multiplies split so no product
overflows), which is the same arithmetic modulo 2^32.

Rounding: for float32 ``x`` with bit pattern ``u``, ``(u + r) & 0xFFFF0000``
with ``r`` uniform on [0, 2^16) is unbiased rounding to the two neighbouring
bf16 values (two's complement makes it right for negative ``x`` too);
values already representable in bf16 come back exactly for every ``r``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# murmur3 finalizer multipliers and golden-ratio row/col strides (uint32)
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_P_ROW = 0x9E3779B9
_P_COL = 0x27D4EB2F


def _mulmod32(a, m: int):
    """``a * m mod 2^32`` for ``a`` holding uint32 values (int64 tensor or
    Python int) and a uint32 constant ``m``; each partial product stays
    below 2^48."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(h):
    """murmur3 finalizer on uint32 values held in int64 (tensor or int);
    equals the JAX package's wrapping-int32 ``mix32`` modulo 2^32."""
    h = h & MASK32
    h = h ^ (h >> 16)
    h = _mulmod32(h, _M1)
    h = h ^ (h >> 13)
    h = _mulmod32(h, _M2)
    return h ^ (h >> 16)


def sr_bits16(seed, row_ids, n_cols: int, col_offset: int = 0):
    """(m, n_cols) int32 dither bits in [0, 2^16) for the cells (row, col).

    ``seed`` is an int (or 0-d tensor) per training step, ``row_ids`` the
    absolute table rows, any shape, flattened to (m, 1). ``col_offset``
    shifts the hashed column ids: a slot stored past column 0 of a merged
    state buffer (adam's first moment at columns d..2d-1) hashes its buffer
    columns."""
    rows = row_ids.reshape(-1, 1).to(torch.int64) & MASK32
    cols = torch.arange(col_offset, col_offset + n_cols, dtype=torch.int64,
                        device=rows.device).reshape(1, -1)
    seed = (seed.to(torch.int64) if torch.is_tensor(seed) else int(seed)) & MASK32
    h = (seed + _mulmod32(rows, _P_ROW) + _mulmod32(cols, _P_COL)) & MASK32
    return (mix32(h) & 0xFFFF).to(torch.int32)


def sr_round_bf16(x, bits16):
    """Stochastically round float32 ``x`` to bfloat16 with 16-bit dither
    values ``bits16`` (broadcast against ``x``)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & MASK32
    hi = ((u + bits16.to(torch.int64)) & MASK32) >> 16
    # the high half as a signed 16-bit pattern is the bf16 value, exactly
    return ((hi ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)


# Adam's per-row step count in a bf16 buffer: bf16 holds integers exactly
# only to 256, so the count is stored as three base-256 limbs (each 0..255),
# exact to 2^24, the same bound as a float32 count.
def limbs_encode(cnt):
    """float32 count -> (lo, mid, hi) base-256 limbs of the same shape."""
    hi = torch.floor(cnt / 65536.0)
    rem = cnt - hi * 65536.0
    mid = torch.floor(rem / 256.0)
    lo = rem - mid * 256.0
    return lo, mid, hi


def limbs_decode(lo, mid, hi):
    """(lo, mid, hi) limbs -> the exact float32 count."""
    return (hi * 256.0 + mid) * 256.0 + lo


def step_seed(seed: int, step: int, salt: int) -> int:
    """The int32 dither seed of one table's update at one training step.

    A pure function of Python ints (no device work, no synchronisation), so
    a resumed run reproduces it exactly. Distinct salts give distinct seeds
    at one step, and distinct steps distinct seeds for one salt (``mix32``
    and the odd stride are bijections mod 2^32). The JAX package instead
    folds its PRNG key (``seed_from_key``), so the two packages' seed
    streams differ, as their negative and dropout streams already do; the
    tests hand the JAX seeds to the port where they compare trajectories.
    """
    h = mix32((seed & MASK32) ^ mix32(salt & MASK32))
    h = mix32((h + _mulmod32(step & MASK32, _P_COL)) & MASK32)
    return h - (1 << 32) if h >= (1 << 31) else h


def step_seeds(seed: int, steps, salt: int) -> np.ndarray:
    """:func:`step_seed` at each of ``steps`` (ints), as an int32 array:
    element for element the same seeds, computed for a chunk at once on the
    host (the hash runs on int64 arrays holding uint32 values)."""
    steps = np.asarray(steps, dtype=np.int64) & MASK32
    h = mix32((seed & MASK32) ^ mix32(salt & MASK32))
    h = mix32((h + _mulmod32(steps, _P_COL)) & MASK32)
    return h.astype(np.uint32).view(np.int32)
