"""Structured logging: human-readable stdout plus optional JSONL sink.

A copy of ``gru4rec_tpu/utils/logging.py``: the same ``EventLogger``, the
same ``GRU4REC_TPU_LOG_JSONL`` variable and the same events (``epoch``,
``valid``, ``nan_abort``, with the JAX package's fields), so one log reader
serves both packages. The port's ``epoch`` event adds the epoch's pace
counters (``host_s``, ``device_s``, ``behind``: ``utils/profiling.py::Pace``). The reference prints only (README.md:467) and its one
machine-readable contract is the ``PRIMARY METRIC:`` stdout line (run.py:133);
the prints stay, and a JSONL event stream is added when a path is passed or
GRU4REC_TPU_LOG_JSONL is set.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class EventLogger:
    """Append-only JSONL event logger; no-op when no sink is configured."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("GRU4REC_TPU_LOG_JSONL")
        self._fh = open(self.path, "a") if self.path else None

    def log(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"ts": time.time(), "event": event, **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


_default: Optional[EventLogger] = None


def get_logger() -> EventLogger:
    global _default
    if _default is None:
        _default = EventLogger()
    return _default
