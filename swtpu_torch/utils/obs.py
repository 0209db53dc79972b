"""Observability: structured run records and profiler traces.

Port of ``swtpu/utils/obs.py``:

- :class:`RunLog`: JSON-lines run records (kernel, batch, wall ms, GCUPS,
  parity status);
- :func:`profile_trace`: a ``torch.profiler`` trace context (JAX's is a
  ``jax.profiler`` hook) that writes one Chrome trace into ``logdir``
  (open it in Perfetto or ``chrome://tracing``, or with TensorBoard's
  profiler plugin, which reads ``*.pt.trace.json``);
- :func:`trace_busy`: the device's busy time in such a trace and the
  window it covers, whose ratio is the device's busy share (one minus
  its idle share).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

from swtpu_torch.utils.device import resolve_device


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


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """``torch.profiler`` trace context: the CPU activity, plus CUDA when
    ``device`` (default: the card) is a CUDA device. On exit it writes one
    Chrome trace, ``<host>.<pid>.<ns>.pt.trace.json``, into ``logdir``.
    Yields the profiler; its ``trace_path`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, f"{os.uname().nodename}.{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def trace_busy(path: str):
    """(busy us, window us) of a Chrome trace: the union of its device
    kernels' events and the span from the trace's first event to its
    last."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        return 0.0, 0.0
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    busy, end = 0.0, float("-inf")
    for e in sorted((e for e in events if e.get("cat") == "kernel"),
                    key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy, window


def gcups(cells: int, seconds: float) -> float:
    return cells / seconds / 1e9
