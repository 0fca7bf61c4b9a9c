"""Blend weights (port of ``srs_tpu/ops/weights.py``).

Dense per-tile weight stacks (``layout_weights``: overlap ramps or
distance-to-edge maps with linear, cosine or sigmoid profiles; reference
31-143) and the separable ramp profiles of the Laplacian blend (145-199).
Host numpy, like the reference. ``decimation_matrix`` is the port's own
copy of ``srs_tpu/ops/pallas/pyramid_pallas.py:44-61``, so a 1-D pyrDown
of a profile matches the device pyrDown of the outer product exactly.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from ..tiling.geometry import TileLayout

__all__ = [
    "distance_weight_map",
    "overlap_ramp_weight",
    "layout_weights",
    "layout_weight_profiles",
    "profile_pyramid",
    "decimation_matrix",
]

_G = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect101(j: int, n: int) -> int:
    if n == 1:
        return 0
    period = 2 * (n - 1)
    j = abs(j) % period
    return period - j if j >= n else j


@lru_cache(maxsize=32)
def decimation_matrix(n: int) -> np.ndarray:
    """[ceil(n/2), n] matrix: 5-tap blur + even-phase decimate + REFLECT_101."""
    m = (n + 1) // 2
    d = np.zeros((m, n), np.float32)
    for i in range(m):
        for k, g in enumerate(_G):
            d[i, _reflect101(2 * i + k - 2, n)] += np.float32(g)
    return d


def _profile(t: np.ndarray, weight_type: str) -> np.ndarray:
    """Feather profile of ``t`` in [0, 1]: linear, cosine 0.5 (1 - cos(pi t))
    or sigmoid 1 / (1 + e^(-10 (t - 0.5)))."""
    if weight_type == "linear":
        return t
    if weight_type == "cosine":
        return 0.5 * (1.0 - np.cos(np.pi * t))
    if weight_type == "sigmoid":
        return 1.0 / (1.0 + np.exp(-10.0 * (t - 0.5)))
    raise ValueError(f"unknown weight_type {weight_type!r}")


def distance_weight_map(
    height: int,
    width: int,
    weight_type: str = "cosine",
    feather_width: Optional[int] = None,
) -> np.ndarray:
    """(H, W) float32 weight rising from the edges to the centre: distance
    to the nearest edge over ``feather_width`` (default min(h, w) // 8),
    clipped to [0, 1], through the ``weight_type`` profile."""
    if feather_width is None:
        feather_width = min(height, width) // 8
    feather_width = max(1, feather_width)
    y = np.arange(height, dtype=np.float32).reshape(-1, 1)
    x = np.arange(width, dtype=np.float32).reshape(1, -1)
    dist = np.minimum(np.minimum(y, height - 1 - y), np.minimum(x, width - 1 - x))
    t = np.clip(dist / feather_width, 0.0, 1.0)
    return _profile(t, weight_type).astype(np.float32)


def overlap_ramp_weight(
    height: int,
    width: int,
    overlap_top: int,
    overlap_bottom: int,
    overlap_left: int,
    overlap_right: int,
) -> np.ndarray:
    """(H, W) float32 linear feather ramps over each non-zero overlap band."""
    w = np.ones((height, width), dtype=np.float32)
    if overlap_top > 0:
        w[:overlap_top, :] *= np.linspace(0, 1, overlap_top, dtype=np.float32)[:, None]
    if overlap_bottom > 0:
        w[-overlap_bottom:, :] *= np.linspace(1, 0, overlap_bottom, dtype=np.float32)[:, None]
    if overlap_left > 0:
        w[:, :overlap_left] *= np.linspace(0, 1, overlap_left, dtype=np.float32)[None, :]
    if overlap_right > 0:
        w[:, -overlap_right:] *= np.linspace(1, 0, overlap_right, dtype=np.float32)[None, :]
    return w


def layout_weights(
    layout: TileLayout,
    kind: str = "ramp",
    weight_type: str = "cosine",
    feather_width: Optional[int] = None,
) -> np.ndarray:
    """(N, block, block) float32 per-tile weights. ``kind="ramp"``: the
    overlap ramps (a partition of unity inside the canvas);
    ``kind="distance"``: the distance-to-edge profile, feathered only on
    the sides that overlap a neighbour (outer borders keep full weight)."""
    n, b = layout.num_tiles, layout.block
    out = np.empty((n, b, b), dtype=np.float32)
    cache: dict = {}
    if kind == "distance":
        fw = feather_width if feather_width is not None else max(1, b // 8)
        y = np.arange(b, dtype=np.float32)[:, None]
        x = np.arange(b, dtype=np.float32)[None, :]
        inf = np.float32(1e9)
        for t in range(n):
            key = tuple(bool(v) for v in layout.overlaps[t])
            if key not in cache:
                top, bottom, left, right = key
                dist = np.minimum(
                    np.minimum(y if top else inf, (b - 1 - y) if bottom else inf),
                    np.minimum(x if left else inf, (b - 1 - x) if right else inf),
                )
                tt = np.clip(dist / fw, 0.0, 1.0)
                cache[key] = np.broadcast_to(_profile(tt, weight_type), (b, b)).astype(np.float32)
            out[t] = cache[key]
        return out
    if kind != "ramp":
        raise ValueError(f"unknown weight kind {kind!r}")
    for t in range(n):
        key = tuple(int(v) for v in layout.overlaps[t])
        if key not in cache:
            cache[key] = overlap_ramp_weight(b, b, *key)
        out[t] = cache[key]
    return out


def _ramp_profile(n: int, lo_overlap: int, hi_overlap: int) -> np.ndarray:
    """1-D linear feather profile over a block edge pair."""
    w = np.ones(n, dtype=np.float32)
    if lo_overlap > 0:
        w[:lo_overlap] *= np.linspace(0, 1, lo_overlap, dtype=np.float32)
    if hi_overlap > 0:
        w[-hi_overlap:] *= np.linspace(1, 0, hi_overlap, dtype=np.float32)
    return w


def layout_weight_profiles(layout: TileLayout) -> tuple:
    """(wy [N, block], wx [N, block]) float32: the ramp weight of tile t is
    ``outer(wy[t], wx[t])``."""
    n, b = layout.num_tiles, layout.block
    wy = np.empty((n, b), np.float32)
    wx = np.empty((n, b), np.float32)
    for t in range(n):
        top, bottom, left, right = (int(v) for v in layout.overlaps[t])
        wy[t] = _ramp_profile(b, top, bottom)
        wx[t] = _ramp_profile(b, left, right)
    return wy, wx


def _pyr_down_1d(v: np.ndarray) -> np.ndarray:
    """1-D pyrDown along the last axis of [N, L]."""
    d = decimation_matrix(v.shape[-1])
    return (v @ d.T).astype(np.float32)


def profile_pyramid(profiles: np.ndarray, levels: int) -> list:
    """[P0..P_{L-1}] 1-D Gaussian pyramid of [N, L] profiles."""
    out = [np.asarray(profiles, np.float32)]
    for _ in range(levels - 1):
        if out[-1].shape[-1] < 2 or (out[-1].shape[-1] + 1) // 2 < 2:
            break
        out.append(_pyr_down_1d(out[-1]))
    return out
