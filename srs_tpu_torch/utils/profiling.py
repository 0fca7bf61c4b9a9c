"""Stage timers, the per-job span record and the device trace (port of
``srs_tpu/utils/profiling.py``).

:class:`StageTimer` accumulates named host-clock stages into a report, as
the reference's does. :func:`trace_region` names a region in a trace
(``torch.profiler.record_function``; free when no trace runs), and
:func:`device_trace` records one: ``torch.profiler.profile`` over the CPU
and, when torch sees a card, the CUDA device, written into a directory as
a Chrome trace (``tensorboard_trace_handler``: open it in Perfetto,
``chrome://tracing`` or TensorBoard's profiler plugin).

A job's record (:class:`JobRecord`, a :class:`StageTimer` with an id and
counters) is current while :func:`job` is open; ``SuperResolutionPipeline
.process`` opens one per job, and each thread (each batch worker) has its
own (a ``contextvars.ContextVar``). Code of every layer adds to the
current record where the work happens:

- :func:`span` times a region by path (``"save/fetch"``) in
  ``time.perf_counter`` seconds, under a ``stage:<path>`` profiler range
  (the job id in the range's ``args``), and yields a :class:`Timed` that
  holds the region's seconds once it ends; given a CUDA device it also
  records a ``torch.cuda.Event`` pair, which
  :meth:`JobRecord.resolve_device` turns into ``device/<path>`` seconds
  once the device has been synchronised;
- :func:`count` adds to a named counter.

With no current record neither adds to one; a span still opens its
profiler range and sets its :class:`Timed`."""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["StageTimer", "JobRecord", "Timed", "job", "current", "span", "count",
           "trace_region", "device_trace"]


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
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Add one call of ``seconds`` to stage ``name``."""
        if name not in self.times:
            self._order.append(name)
        self.times[name] = self.times.get(name, 0.0) + seconds
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


_job_ids = itertools.count(1)
_current: "contextvars.ContextVar[Optional[JobRecord]]" = contextvars.ContextVar(
    "srs_tpu_torch_job_record", default=None)


@dataclass
class JobRecord(StageTimer):
    """One job's spans (seconds and calls by path) and counters, with an id
    from one process-wide counter."""

    job_id: int = field(default_factory=lambda: next(_job_ids))
    counters: Dict[str, float] = field(default_factory=dict)
    # (path, start event, end event) of device spans not yet resolved
    _events: List[Tuple[str, Any, Any]] = field(default_factory=list)

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def resolve_device(self) -> None:
        """Add each finished CUDA event pair's seconds as ``device/<path>``.
        Call after a synchronisation: a pair whose end has not run yet
        stays for a later call."""
        pending = []
        for path, start, end in self._events:
            if end.query():
                self.add(f"device/{path}", start.elapsed_time(end) / 1e3)
            else:
                pending.append((path, start, end))
        self._events = pending

    def spans(self) -> Dict[str, float]:
        """Seconds by span path, and the counters as ``count/<name>``."""
        return {**self.times, **{f"count/{k}": v for k, v in self.counters.items()}}


@contextlib.contextmanager
def job() -> Iterator[JobRecord]:
    """A new record, current in this context (thread) while open."""
    record = JobRecord()
    token = _current.set(record)
    try:
        yield record
    finally:
        _current.reset(token)


def current() -> Optional[JobRecord]:
    """The current job's record, or None."""
    return _current.get()


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` of the current record, if any."""
    record = _current.get()
    if record is not None:
        record.count(name, n)


@dataclass
class Timed:
    """The seconds of a :func:`span`, set when it ends."""

    seconds: float = 0.0


@contextlib.contextmanager
def span(path: str, device: Any = None) -> Iterator[Timed]:
    """Time the enclosed region as span ``path`` of the current record,
    under a ``stage:<path>`` profiler range whose ``args`` carry the job id.
    With a CUDA ``device``, also a ``torch.cuda.Event`` pair on its current
    stream (resolved by :meth:`JobRecord.resolve_device`)."""
    import torch

    record = _current.get()
    timed = Timed()
    args = None if record is None else f"job_id={record.job_id}"
    with torch.profiler.record_function(f"stage:{path}", args):
        events = None
        if record is not None and device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        t0 = time.perf_counter()
        try:
            yield timed
        finally:
            timed.seconds = time.perf_counter() - t0
            if record is not None:
                record.add(path, timed.seconds)
            if events is not None:
                events[1].record(stream)
                record._events.append((path, *events))


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
