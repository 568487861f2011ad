"""The bytes a row-sparse update must move, kept with the benchmark: a copy
of ``chip_smoke.py::_row_bytes`` (the byte bound of the ``kernel_timing``
phase), on the state's row layout rather than its tensors, and the bound
of one call of the update built on it.

The kernel (``csrc/sparse_update.cu``) must read the K indices and the
gradient rows of the valid positions once, and read and write once, per
distinct row it updates, the row's table, state and velocity rows; no
implementation of the update moves less.
"""

from __future__ import annotations

from benchmark.yardstick.counts import HBM_BYTES_PER_S


def row_bytes(adapt: str, state: dict, d: int, sr: bool = False) -> int:
    """Bytes that the update of one distinct row must read and write: its
    table row, velocity row and state row, each read and written once, but
    of adam's 128-lane count block only the lanes that carry the count: one
    lane read and all 128 written (each holds the count), or under SR the
    three limb lanes read and written (the other lanes stay 0). ``state``:
    ``{slot name: (columns, bytes an element)}`` of the table's optimizer
    state (``acc``, ``acc2``, ``velocity``, ...)."""
    row = 2 * d * 4
    for k, (cols, es) in state.items():
        if k == "acc2" and adapt == "adam":
            read, written = (3, 3) if sr else (1, cols - 2 * d)
            row += (4 * d + read + written) * es
        else:
            row += 2 * cols * es
    return row


def update_bytes(positions: int, valid: int, distinct: int, d: int, adapt: str,
                 state: dict, sr: bool = False) -> int:
    """Bytes of one call: ``positions`` int32 indices, ``valid`` float32
    gradient rows of width ``d``, and :func:`row_bytes` for each of the
    ``distinct`` rows updated."""
    return positions * 4 + valid * d * 4 + distinct * row_bytes(adapt, state, d, sr)


def update_bound_s(nbytes: float) -> float:
    """The least time of a call that moves ``nbytes``, over the HBM bandwidth."""
    return nbytes / HBM_BYTES_PER_S
