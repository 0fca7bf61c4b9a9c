"""Reduction of a device trace: the union of kernel intervals, the idle
share, and the breakdown of device ops and idle gaps."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple


def union(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clip(spans: Iterable[Tuple[float, float]], lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def busy(spans: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``spans`` inside [lo, hi]."""
    return sum(b - a for a, b in union(clip(spans, lo, hi)))


def idle_share(spans, lo: float, hi: float) -> float:
    """Share of [lo, hi] in which no interval of ``spans`` runs."""
    return 1.0 - busy(spans, lo, hi) / (hi - lo)


def gaps(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi]."""
    out, t = [], lo
    for a, b in union(clip(spans, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def label_at(t: float, ranges: Sequence[Tuple[float, float, str]]) -> str:
    """The innermost named host range that holds time ``t``, or "none"."""
    best = None
    for a, b, name in ranges:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "none"


def breakdown(kernels: Sequence[Tuple[float, float, str]],
              ranges: Sequence[Tuple[float, float, str]], lo: float, hi: float,
              scale: float, top: int = 10) -> Dict[str, list]:
    """The ``top`` device ops by summed time, and the ``top`` idle gaps
    summed by the host range they fall in (at each gap's midpoint); times
    in the trace's unit times ``scale`` (to seconds)."""
    by_op: Dict[str, float] = {}
    for a, b, name in kernels:
        if b > lo and a < hi:
            by_op[name] = by_op.get(name, 0.0) + (min(b, hi) - max(a, lo)) * scale
    by_gap: Dict[str, float] = {}
    for a, b in gaps([(a, b) for a, b, _ in kernels], lo, hi):
        key = label_at((a + b) / 2, ranges)
        by_gap[key] = by_gap.get(key, 0.0) + (b - a) * scale
    order = lambda d: sorted(([k[:160], v] for k, v in d.items()), key=lambda kv: -kv[1])
    return {"device_ops": order(by_op)[:top], "idle_gaps": order(by_gap)[:top]}
