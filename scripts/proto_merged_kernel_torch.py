"""P1 on the card: the merged [table | acc] adagrad kernel against the
port's row-sparse kernel on separate table and acc.

The PyTorch/CUDA counterpart of ``scripts/proto_merged_kernel.py``, at its
shapes (diginetica, rees46, yoochoose, retailrocket) and index draw (K
uniform indices below ``n_rows - 8``), 64 steps back to back per variant
(``gru4rec_tpu_torch/ops/kernels/proto_measure.py``). Prints the card's
``nvidia-smi`` name and power limit, then one JSON line per shape and
variant: ``shape``, ``K``, ``variant``, ``us_per_step`` (CUDA events; for
"merged" sort plus kernel, for "separate" the sort-free kernel alone),
``kernel_us_per_launch`` (``torch.profiler``, the sort left out),
``ops_per_call`` and the byte bound. "separate" dedups in the kernel and
"merged" keeps the sort feed, so the two differ in more than the layout.
Needs one CUDA device; run from the root of a checkout:

    python3 scripts/proto_merged_kernel_torch.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gru4rec_tpu_torch.ops.kernels import proto_measure  # noqa: E402


def main():
    card = proto_measure.nvidia_smi_line()
    print(card, flush=True)
    for shape in proto_measure.MERGED_SHAPES:
        for rec in proto_measure.measure_merged(*shape, card):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
