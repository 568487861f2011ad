"""P2 on the card: the dynamic-length pipelined adagrad kernel ("v3")
against the port's row-sparse kernel ("v2").

The PyTorch/CUDA counterpart of ``scripts/proto_v3_kernel.py``, at its
shapes and pools (rees46, diginetica, yoochoose, uniform-distinct: K
indices drawn from a pool of distinct rows below ``n_rows - 8``), 64 steps
back to back per variant (``gru4rec_tpu_torch/ops/kernels/proto_measure.py``).
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per shape and variant: ``shape``, ``K``, ``pool``, ``variant``,
``us_per_step`` (CUDA events, the wrapper's call), ``kernel_us_per_launch``
(``torch.profiler``: the device time of the whole call, one operation),
``ops_per_call`` (1), P2's launch (``v3_grid``, ``v3_tile``, ``v3_blocks``,
rows per block and per warp) and the byte bound. Both variants are
sort-free and dedup the raw indices in the kernel the same way, so the two
differ only in a grid over all K positions against a loop over the real
rows. Needs one CUDA device; run from the root of a checkout:

    python3 scripts/proto_v3_kernel_torch.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gru4rec_tpu_torch.ops.kernels import proto_measure  # noqa: E402


def main():
    card = proto_measure.nvidia_smi_line()
    print(card, flush=True)
    for shape in proto_measure.V3_SHAPES:
        for rec in proto_measure.measure_v3(*shape, card):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
