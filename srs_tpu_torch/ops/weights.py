"""Separable ramp blend profiles (port of ``srs_tpu/ops/weights.py:145-199``).

Host numpy, like the reference. ``decimation_matrix`` is the port's own
copy of ``srs_tpu/ops/pallas/pyramid_pallas.py:44-61``, so a 1-D pyrDown
of a profile matches the device pyrDown of the outer product exactly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..tiling.geometry import TileLayout

__all__ = ["layout_weight_profiles", "profile_pyramid", "decimation_matrix"]

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
