"""One job per kind of traffic (a traffic file's ``kind``): ``fit``,
``evaluate`` and ``serve``. Each module has ``run(cell, run) -> dict``
(:mod:`benchmark.jobs.common`)."""
