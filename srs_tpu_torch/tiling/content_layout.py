"""Content-aware seam placement (port of ``srs_tpu/tiling/content_layout.py``;
numpy, as the reference).

Adjacent tiles overlap, so the visible seam is wherever the blend weights
cross 0.5. The tile grid stays fixed (pyramid-aligned) and each seam's
crossover moves inside its overlap band to the line that crosses the
least forbidden zone (``tiling/content.py``). The weights are an exact
partition of unity (complementary ramps around each crossover), so every
fusion method takes them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .geometry import TileLayout

__all__ = ["seam_cost", "choose_crossovers", "content_aware_weights", "content_aware_weight_profiles"]


def seam_cost(zone: np.ndarray, axis: int, line: int, band: int = 8) -> float:
    """Mean forbidden density in a band around a grid line (axis 0 =
    horizontal seam at a row, axis 1 = vertical seam at a column)."""
    n = zone.shape[axis]
    lo = max(0, line - band)
    hi = min(n, line + band)
    if hi <= lo:
        return 0.0
    sl = zone[lo:hi, :] if axis == 0 else zone[:, lo:hi]
    return float(sl.mean())


def choose_crossovers(
    layout: TileLayout,
    zone: np.ndarray,
    axis: int,
    band: int = 8,
    feather: Optional[int] = None,
) -> List[int]:
    """Crossover line for each interior seam along ``axis`` (0: between
    tile rows, 1: between tile columns), searched over the admissible part
    of the overlap band."""
    n_lines = (layout.ny if axis == 0 else layout.nx) - 1
    overlap, step = layout.overlap, layout.step
    fw = feather if feather is not None else max(4, overlap // 2)
    margin = fw // 2 + 1
    out = []
    for k in range(1, n_lines + 1):
        lo = k * step + margin
        hi = k * step + overlap - margin
        nominal = k * step + overlap // 2
        if hi <= lo:
            out.append(nominal)
            continue
        cands = sorted(set(range(lo, hi + 1, 4)) | {min(max(nominal, lo), hi)})
        best = min(cands, key=lambda c: (seam_cost(zone, axis, c, band), abs(c - nominal)))
        out.append(int(best))
    return out


def _axis_profiles(
    n_tiles: int, extent: int, step: int, block: int, crossovers: List[int], fw: int
) -> np.ndarray:
    """[n_tiles, extent] partition-of-unity 1-D weight profiles: tile k is
    1 inside (c_k, c_{k+1}), ramping over +-fw/2 around each crossover."""
    y = np.arange(extent, dtype=np.float32)

    def up(c):  # 0 -> 1 around c
        return np.clip((y - (c - fw / 2)) / fw, 0.0, 1.0)

    prof = np.empty((n_tiles, extent), np.float32)
    for k in range(n_tiles):
        w = np.ones(extent, np.float32)
        if k > 0:
            w = w * up(crossovers[k - 1])
        if k < n_tiles - 1:
            w = w * (1.0 - up(crossovers[k]))
        prof[k] = w
    return prof


def content_aware_weights(
    layout: TileLayout,
    forbidden_zone: np.ndarray,
    band: int = 8,
    feather: Optional[int] = None,
) -> np.ndarray:
    """[N, block, block] float32 weights whose seams avoid forbidden zones.

    Exact partition of unity over the padded canvas; works with uniform
    grid positions (the crossover always stays strictly inside each
    overlap band, so only the two adjacent tiles are non-zero there).
    """
    zone = np.asarray(forbidden_zone, bool)
    fw = feather if feather is not None else max(4, layout.overlap // 2)
    rows = choose_crossovers(layout, zone, 0, band, fw)
    cols = choose_crossovers(layout, zone, 1, band, fw)
    prof_r = _axis_profiles(layout.ny, layout.padded_h, layout.step, layout.block, rows, fw)
    prof_c = _axis_profiles(layout.nx, layout.padded_w, layout.step, layout.block, cols, fw)
    n, b = layout.num_tiles, layout.block
    out = np.empty((n, b, b), np.float32)
    pos = np.asarray(layout.positions)
    for t in range(n):
        r, c = t // layout.nx, t % layout.nx
        y0, x0 = int(pos[t, 0]), int(pos[t, 1])
        out[t] = prof_r[r, y0 : y0 + b][:, None] * prof_c[c, x0 : x0 + b][None, :]
    return out


def content_aware_weight_profiles(
    layout: TileLayout,
    forbidden_zone: np.ndarray,
    band: int = 8,
    feather: Optional[int] = None,
):
    """Separable form of :func:`content_aware_weights`: (wy [N, block],
    wx [N, block]) with ``weights[t] == outer(wy[t], wx[t])`` exactly —
    feed to the HBM-lean blend path (`weight_profiles=`)."""
    zone = np.asarray(forbidden_zone, bool)
    fw = feather if feather is not None else max(4, layout.overlap // 2)
    rows = choose_crossovers(layout, zone, 0, band, fw)
    cols = choose_crossovers(layout, zone, 1, band, fw)
    prof_r = _axis_profiles(layout.ny, layout.padded_h, layout.step, layout.block, rows, fw)
    prof_c = _axis_profiles(layout.nx, layout.padded_w, layout.step, layout.block, cols, fw)
    n, b = layout.num_tiles, layout.block
    wy = np.empty((n, b), np.float32)
    wx = np.empty((n, b), np.float32)
    pos = np.asarray(layout.positions)
    for t in range(n):
        r, c = t // layout.nx, t % layout.nx
        y0, x0 = int(pos[t, 0]), int(pos[t, 1])
        wy[t] = prof_r[r, y0 : y0 + b]
        wx[t] = prof_c[c, x0 : x0 + b]
    return wy, wx
