"""The benchmark of ``gru4rec_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.
Everything a cell needs is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/`` (a data file that the job of
its ``kind`` in ``jobs/`` reads), its limits in ``limits/`` and each
per-layer metric's reader in ``metrics/``. ``yardstick/`` holds what later
changes to the program may not move: the generators, the trace arithmetic,
the operation and byte counts, the peaks and the comparison;
``reference/`` is the plain PyTorch reference the comparison runs.
"""
