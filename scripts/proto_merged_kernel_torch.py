"""P1 on the card: the merged [table | acc] adagrad kernel against the
port's row-sparse kernel on separate table and acc.

The PyTorch/CUDA counterpart of ``scripts/proto_merged_kernel.py``, at its
shapes (diginetica, rees46, yoochoose, retailrocket) and index draw (K
uniform indices below ``n_rows - 8``), 64 steps back to back per variant
(``gru4rec_tpu_torch/ops/kernels/proto_measure.py``). Prints the card's
``nvidia-smi`` name and power limit, then one JSON line per shape and
variant: ``shape``, ``K``, ``variant``, ``us_per_step`` (CUDA events, the
wrapper's call), ``kernel_us_per_launch`` (``torch.profiler``: the device
time of the whole call, one operation), ``ops_per_call`` (1) and the byte
bound. Both variants are sort-free and dedup the raw indices in the kernel
the same way, so the two differ only in the layout: two rows of 4d bytes,
or one contiguous span of 8d bytes per distinct row.
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
