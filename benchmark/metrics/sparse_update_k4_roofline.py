"""sparse_update_k4_roofline: the byte bound of the K4 update of the traced
training steps over the device time of its launches, in percent.

The bound of a step's update of ``Wx0`` is ``row_bytes.update_bytes`` over
3.35 TB/s: the batch's raw indices and the valid lanes' gradient rows read
once, and for each distinct valid input row its table, accumulator and
velocity rows read and written once (``chip_smoke.py::_row_bytes``, copied
as ``benchmark/yardstick/row_bytes.py``), from the schedule of the traced
steps (the job's ``k4`` record). The share is the mean bound of a traced
step over the mean time of a K4 launch (one a step), so a record the
tracer drops moves neither. It is not capped: a reading over 100% means the
bytes are counted too high or the time misses part of the work. Nothing
where no kernel tagged ``k4_any_width`` ran or the job recorded no
schedule."""

import statistics

from benchmark.yardstick import row_bytes

K4 = "k4_any_width"


def read(layer):
    if layer is None or layer.get("kind") != "train" or not layer.get("k4"):
        return None
    seconds, n = layer["region"].kernel_time_s(lambda name: "sparse_update" in name
                                               and K4 in name)
    k4 = layer["k4"]
    if not n or not k4["valid"]:
        return None
    bound = statistics.fmean(
        row_bytes.update_bound_s(row_bytes.update_bytes(
            k4["positions"], valid, distinct, k4["d"], k4["adapt"], k4["state"]))
        for valid, distinct in zip(k4["valid"], k4["distinct_rows"]))
    return 100.0 * bound / (seconds / n)
