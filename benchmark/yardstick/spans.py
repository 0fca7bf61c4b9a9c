"""Readings of the program's own spans: ``PipelineResult.stage_times``,
each stage timed up to the end of its device work."""

from typing import Optional


def stage_mean(run: dict, stage: str) -> Optional[float]:
    """Mean seconds of ``stage`` over the window's finished images, or
    None where no image recorded it."""
    times = [r.stage_times[stage] for r in run["results"]
             if r.success and stage in r.stage_times]
    return sum(times) / len(times) if times else None
