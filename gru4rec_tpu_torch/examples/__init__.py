"""The published-results harnesses of the port, run as modules:

* ``python -m gru4rec_tpu_torch.examples.quickstart_synthetic``: train,
  evaluate, save, reload and serve on synthetic sessions;
* ``python -m gru4rec_tpu_torch.examples.reproduce_published``: the
  asserting parity gate for the six published datasets
  (``paramfiles/*_best.py``, copies of the JAX package's paramfiles);
* ``python -m gru4rec_tpu_torch.examples.rsc15.preprocess`` and
  ``python -m gru4rec_tpu_torch.examples.rsc15.run_rsc15``: the RSC15
  protocol and its three CIKM'18 configurations.

Each is the counterpart of the JAX package's ``examples/`` script of the
same name, with its flags, tables, report and exit status; each runs on
the card unless ``-d cpu`` asks for the CPU.
"""
