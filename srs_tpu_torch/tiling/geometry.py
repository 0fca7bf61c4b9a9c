"""Pure tile-grid geometry (port of ``srs_tpu/tiling/geometry.py``).

A numpy copy: the port imports nothing of ``srs_tpu``. Layouts pad the
canvas up to the exact grid extent ``(n-1)*step + block`` on each axis so
every tile is a full block; ``positions`` and ``overlaps`` match the
reference exactly (tests/test_torch_geometry_tiles.py).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

__all__ = [
    "TileLayout",
    "compute_layout",
    "reference_positions",
    "overlap_for_tile",
    "neighbor_ids",
]


def _overlap_pixels(block_size: int, overlap_ratio: float) -> int:
    return int(block_size * overlap_ratio)


@dataclass(frozen=True)
class TileLayout:
    """Static description of an overlap-tile grid; arrays are indexed by
    tile id ``t = row * nx + col``."""

    image_w: int
    image_h: int
    block: int
    overlap: int
    step: int
    nx: int
    ny: int
    padded_w: int  # (nx-1)*step + block
    padded_h: int  # (ny-1)*step + block
    # (N, 2) int32: top-left (y, x) of each full-block tile in padded coords.
    positions: np.ndarray
    # (N, 4) int32: per-tile (top, bottom, left, right) overlap, 0 on borders.
    overlaps: np.ndarray
    # (N, 8) int32 neighbor ids (N,NE,E,SE,S,SW,W,NW), -1 = none.
    neighbors: np.ndarray

    @property
    def num_tiles(self) -> int:
        return self.nx * self.ny

    def tile_rc(self, t: int) -> Tuple[int, int]:
        """(row, col) of tile ``t``."""
        return t // self.nx, t % self.nx

    def scaled(self, scale: int) -> "TileLayout":
        """Layout of the output canvas after integer per-tile upscaling."""
        if scale == 1:
            return self
        return TileLayout(
            image_w=self.image_w * scale,
            image_h=self.image_h * scale,
            block=self.block * scale,
            overlap=self.overlap * scale,
            step=self.step * scale,
            nx=self.nx,
            ny=self.ny,
            padded_w=self.padded_w * scale,
            padded_h=self.padded_h * scale,
            positions=self.positions * scale,
            overlaps=self.overlaps * scale,
            neighbors=self.neighbors,
        )

    def to_dict(self) -> dict:
        """The fields, with the arrays as nested lists."""
        d = dataclasses.asdict(self)
        for k in ("positions", "overlaps", "neighbors"):
            d[k] = d[k].tolist() if hasattr(d[k], "tolist") else d[k]
        return d


def _grid_counts(w: int, h: int, block: int, overlap: int) -> Tuple[int, int]:
    step = block - overlap
    nx = max(1, math.ceil((w - overlap) / step))
    ny = max(1, math.ceil((h - overlap) / step))
    return nx, ny


def compute_layout(
    image_w: int,
    image_h: int,
    block_size: int,
    overlap_ratio: float = 0.2,
    step_multiple: int = 1,
) -> TileLayout:
    """Full-block tile layout for an image.

    ``step_multiple`` rounds the step down to a multiple (raising the
    overlap), so that each tile's dyadic pyramid grid aligns with the
    canvas pyramid grid; 32 serves a 6-level blend.
    """
    overlap = _overlap_pixels(block_size, overlap_ratio)
    step = block_size - overlap
    if step <= 0:
        raise ValueError(f"overlap {overlap} >= block {block_size}")
    if step_multiple > 1 and step > step_multiple:
        step = (step // step_multiple) * step_multiple
        overlap = block_size - step
    nx, ny = _grid_counts(image_w, image_h, block_size, overlap)
    positions = np.empty((nx * ny, 2), dtype=np.int32)
    overlaps = np.empty((nx * ny, 4), dtype=np.int32)
    for r in range(ny):
        for c in range(nx):
            t = r * nx + c
            positions[t] = (r * step, c * step)
            overlaps[t] = (
                overlap if r > 0 else 0,
                overlap if r < ny - 1 else 0,
                overlap if c > 0 else 0,
                overlap if c < nx - 1 else 0,
            )
    return TileLayout(
        image_w=image_w,
        image_h=image_h,
        block=block_size,
        overlap=overlap,
        step=step,
        nx=nx,
        ny=ny,
        padded_w=(nx - 1) * step + block_size,
        padded_h=(ny - 1) * step + block_size,
        positions=positions,
        overlaps=overlaps,
        neighbors=neighbor_ids(nx, ny),
    )


def neighbor_ids(nx: int, ny: int) -> np.ndarray:
    """8-neighborhood tile graph, order N, NE, E, SE, S, SW, W, NW."""
    offsets = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]
    out = np.full((nx * ny, 8), -1, dtype=np.int32)
    for r in range(ny):
        for c in range(nx):
            for k, (dr, dc) in enumerate(offsets):
                rr, cc = r + dr, c + dc
                if 0 <= rr < ny and 0 <= cc < nx:
                    out[r * nx + c, k] = rr * nx + cc
    return out


def reference_positions(
    image_w: int, image_h: int, block_size: int, overlap_ratio: float = 0.2
) -> List[Tuple[int, int, int, int]]:
    """The tiles clipped to the image, as (x, y, w, h), row by row (the
    tiling the reference's edge tiles follow; no step rounding)."""
    overlap = _overlap_pixels(block_size, overlap_ratio)
    step = block_size - overlap
    nx, ny = _grid_counts(image_w, image_h, block_size, overlap)
    positions = []
    for r in range(ny):
        for c in range(nx):
            x, y = c * step, r * step
            positions.append((x, y, min(block_size, image_w - x), min(block_size, image_h - y)))
    return positions


def overlap_for_tile(
    x: int,
    y: int,
    w: int,
    h: int,
    image_w: int,
    image_h: int,
    block_size: int,
    overlap_ratio: float = 0.2,
) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) overlap of a clipped tile, with the
    reference's edge-tile adjustment: a tile that reaches the image's far
    edge overlaps by what its full block would cover past it."""
    overlap = _overlap_pixels(block_size, overlap_ratio)
    top = overlap if y > 0 else 0
    left = overlap if x > 0 else 0
    bottom = overlap if y + h < image_h else 0
    right = overlap if x + w < image_w else 0
    if y + block_size >= image_h:
        bottom = max(0, block_size - (image_h - y) - top)
    if x + block_size >= image_w:
        right = max(0, block_size - (image_w - x) - left)
    return (top, bottom, left, right)
