"""Observability: structured run records.

Port of ``swtpu/utils/obs.py``'s :class:`RunLog` (JSON-lines run records:
kernel, batch, wall ms, GCUPS, parity status) and :func:`gcups`. Its
``profile_trace`` (a ``jax.profiler`` hook) has no counterpart yet: a
``torch.profiler`` trace comes with the harnesses (ROADMAP.md queue A
item 14).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Optional


class RunLog:
    """JSON-lines structured logger (stderr unless given a path)."""

    def __init__(self, path: Optional[str] = None):
        self._fh = open(path, "a") if path else sys.stderr

    def emit(self, **record):
        record.setdefault("ts", round(time.time(), 3))
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    @contextlib.contextmanager
    def timed(self, event: str, **fields):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit(
                event=event,
                wall_ms=round((time.perf_counter() - t0) * 1e3, 2),
                **fields,
            )


def gcups(cells: int, seconds: float) -> float:
    return cells / seconds / 1e9
