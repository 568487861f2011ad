"""mixed_mm_roofline: the bound of the evaluation step's products over the
device time of the kernels that compute them, in percent.

The bound is ``counts.product_bound_s`` of each product of one step
(``counts.eval_step_products``: the input projection, the two recurrent
products and the scores of the padded catalog) at the stated precision:
bfloat16 operands (``compute_dtype``) read once and the float32 result
written once, times the steps of the walk. The bytes set it: at rees46's
512 x 512 x 200,064 scores they take 0.1836 ms, the operations 0.1061 ms.
No implementation of that precision that writes the scores can beat it.

The time is every matrix-product kernel (cuBLAS / CUTLASS names) and every
float32-to-bfloat16 cast the traced call ran, whatever implements the
product: a cached cast leaves only the GEMM. The share is not capped: a
reading over 100% means the work is counted too high or the time misses
part of it. An evaluation trace in which no such kernel ran is an error
(the product moved into a kernel of another name), not a missing reading.
"""

from benchmark.yardstick import counts

GEMM = ("gemm", "nvjet", "xmma", "cutlass")
CAST = ("bfloat16_copy_kernel",)
OPERAND_BYTES = {"bfloat16": 2, "float32": 4}


def read(layer):
    if layer is None or layer.get("kind") != "eval":
        return None
    c = layer["config"]
    h = int(c["params"]["layers"][0])
    n_pad = counts.pad_items(int(c["n_items"]))
    width = OPERAND_BYTES[c["program"]["compute_dtype"]]
    step = sum(counts.product_bound_s(M, K, N, width) for M, K, N in
               counts.eval_step_products(int(layer["traffic"]["batch_size"]), h, h, n_pad))
    seconds, n = layer["region"].kernel_time_s(
        lambda name: any(s in name.lower() for s in GEMM + CAST))
    if not n:
        raise RuntimeError("mixed_mm_roofline: the traced evaluation ran no kernel named "
                           f"after {GEMM + CAST}")
    return 100.0 * step * layer["steps"] / seconds
