"""Processing time estimator (port of ``srs_tpu/webui/estimator.py``):
scale = sqrt(target / current pixels), the tile grid of the tile size and
overlap, and the seconds from a measured output rate of the card.

The defaults are the card's own, measured with ``chip_smoke.py`` on an
NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md §5):

- ``DEFAULT_MP_PER_SEC``: ``python -m srs_tpu_torch bench`` (the bench
  path: routing, selection and QA on, 720p to 100MP) measured 30.97-36.66
  output MP/s; 25 keeps a margin below the slowest run;
- ``SELF_ENSEMBLE_FACTOR``: the dihedral self-ensemble's ``process()``
  ran at 10.96-12.12 MP/s against the quality path's 31.34 MP/s on the
  same flags, x2.59-2.86 the time; 2.9 covers the slower end.
"""

from __future__ import annotations

import math
from typing import Dict

__all__ = ["DEFAULT_MP_PER_SEC", "SELF_ENSEMBLE_FACTOR", "calculate_estimates"]

DEFAULT_MP_PER_SEC = 25.0
SELF_ENSEMBLE_FACTOR = 2.9


def calculate_estimates(
    width: int,
    height: int,
    target_pixels: int,
    tile_size: int = 1024,
    overlap_ratio: float = 0.2,
    mp_per_sec: float = DEFAULT_MP_PER_SEC,
    num_chips: int = 1,
    self_ensemble: bool = False,
) -> Dict[str, float]:
    """The scale, the tile grid and the estimated seconds of one job
    (``num_chips`` cards at ``mp_per_sec`` output MP/s each)."""
    current = width * height
    scale = math.sqrt(target_pixels / max(current, 1))
    step = tile_size * (1 - overlap_ratio)
    tiles_x = math.ceil(width / step)
    tiles_y = math.ceil(height / step)
    target_mp = target_pixels / 1e6
    est_seconds = target_mp / max(mp_per_sec * num_chips, 1e-6)
    if self_ensemble:
        est_seconds *= SELF_ENSEMBLE_FACTOR
    return {
        "scale_factor": scale,
        "tiles_x": tiles_x,
        "tiles_y": tiles_y,
        "num_tiles": tiles_x * tiles_y,
        "target_mp": target_mp,
        "estimated_seconds": est_seconds,
        "estimated_chip_seconds": target_mp / max(mp_per_sec, 1e-6),
    }
