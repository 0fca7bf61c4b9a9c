"""Stage timers and the device trace (port of ``srs_tpu/utils/profiling.py``).

:class:`StageTimer` accumulates named host-clock stages into a report, as
the reference's does. :func:`trace_region` names a region in a trace
(``torch.profiler.record_function``; free when no trace runs), and
:func:`device_trace` records one: ``torch.profiler.profile`` over the CPU
and, when torch sees a card, the CUDA device, written into a directory as
a Chrome trace (``tensorboard_trace_handler``: open it in Perfetto,
``chrome://tracing`` or TensorBoard's profiler plugin).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List

__all__ = ["StageTimer", "trace_region", "device_trace"]


@dataclass
class StageTimer:
    """Accumulating named stage timer (thread-safe enough for the host
    pipeline's sequential stages)."""

    times: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    _order: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.times:
                self._order.append(name)
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Any]:
        total = sum(self.times.values())
        return {
            "total_s": round(total, 4),
            "stages": [
                {
                    "name": n,
                    "seconds": round(self.times[n], 4),
                    "calls": self.counts[n],
                    "share": round(self.times[n] / total, 3) if total else 0.0,
                }
                for n in self._order
            ],
        }

    def __str__(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def trace_region(name: str) -> Iterator[None]:
    """Name a region in the trace (no-op without a trace)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[Any]:
    """Record a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (created if missing): CPU ops always, and the CUDA
    device's kernels and copies when torch sees a card. The trace file,
    ``<host>_<pid>.<ms>.pt.trace.json``, is written when the region ends.
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
