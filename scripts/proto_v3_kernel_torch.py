"""P2 on the card: the dynamic-length pipelined adagrad kernel ("v3")
against the port's row-sparse kernel ("v2").

The PyTorch/CUDA counterpart of ``scripts/proto_v3_kernel.py``, at its
shapes and pools (rees46, diginetica, yoochoose, uniform-distinct: K
indices drawn from a pool of distinct rows below ``n_rows - 8``), 64 steps
back to back per variant (``gru4rec_tpu_torch/ops/kernels/proto_measure.py``).
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per shape and variant: ``shape``, ``K``, ``pool``, ``variant``,
``us_per_step`` (CUDA events; for "v3" sort, prep and kernel, for "v2" the
sort-free kernel alone), ``kernel_us_per_launch`` (``torch.profiler``:
every device operation of the kernel wrapper but P2's sort, for "v3" its
memset, record kernel and loop kernel), ``ops_per_call``, the persistent
grid of "v3" and the byte bound. "v2" dedups in the kernel and "v3" keeps
the sort feed, so the two differ in more than P2's loop. Needs one CUDA
device; run from the root of a checkout:

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
