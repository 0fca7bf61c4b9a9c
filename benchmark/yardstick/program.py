"""Readings of the program's per-job span record: ``PipelineResult.spans``,
seconds by span path (``save/fetch``, ``device/super_resolution/edsr_xl+@x3``)
with the counters as ``count/<name>``. A program whose results carry no
record reads None."""

import re
from typing import Callable, Dict, Optional

# A fusion member's span on one ladder step; group 1 is the member.
MEMBER = re.compile(r"^super_resolution/(.+)@x\d+$")


def job_mean(run: dict, value: Callable[[Dict[str, float]], Optional[float]]
             ) -> Optional[float]:
    """Mean of ``value(spans)`` over the window's successful results where
    it is not None, or None where it is None in every one."""
    vals = []
    for r in run["results"]:
        spans = getattr(r, "spans", None)
        if r.success and spans:
            v = value(spans)
            if v is not None:
                vals.append(v)
    return sum(vals) / len(vals) if vals else None


def span_sum(spans: Dict[str, float], *paths: str) -> Optional[float]:
    """Seconds of ``paths`` summed, or None where one is missing."""
    if not all(p in spans for p in paths):
        return None
    return sum(spans[p] for p in paths)


def ensemble_seconds(spans: Dict[str, float]) -> Optional[float]:
    """Seconds of the dihedral-ensemble members ("+" names) over every
    step: each member's device span, else its host span; None where the
    job ran none."""
    members = [k for k in spans if (m := MEMBER.match(k)) and m.group(1).endswith("+")]
    if not members:
        return None
    return sum(spans.get(f"device/{k}", spans[k]) for k in members)
