"""Mesh tile dispatcher: the SR stages over a device mesh (port of
``srs_tpu/parallel/dispatch.py``).

The tile batch splits over the ``data`` axis and each data shard runs on
its own device; the canvas blend shards over ``space`` with halo exchange
(``parallel/halo.py``). The policy role (priorities, retries,
degradation) stays in ``scheduler/``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.blend import laplacian_fusion_tiles
from ..ops.tiles import merge_tiles
from ..tiling.geometry import TileLayout
from .halo import sharded_laplacian_blend, sharded_weighted_merge
from .mesh import Mesh, make_mesh

__all__ = ["MeshTileDispatcher"]


class MeshTileDispatcher:
    """Runs per-tile functions over the mesh, with data sharding and the
    halo-exchange merge and blend."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()

    @property
    def num_devices(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))

    def pad_batch(self, tiles: torch.Tensor) -> torch.Tensor:
        """The batch zero-padded to a multiple of the data-axis size (the
        reference's equal shards; ``run_tiled`` does not need it)."""
        d = self.mesh.shape.get("data", 1)
        rem = (-tiles.shape[0]) % d
        if rem:
            tiles = torch.cat([tiles, tiles.new_zeros((rem, *tiles.shape[1:]))])
        return tiles

    def run_tiled(self, fn: Callable[[torch.Tensor], torch.Tensor], tiles: torch.Tensor,
                  key: Optional[str] = None) -> torch.Tensor:
        """Apply a [N, ...] -> [N, ...] tile function with the batch split
        over the ``data`` axis: data shard i holds tiles
        [i*ceil(N/D), (i+1)*ceil(N/D)) (the reference's shards of the padded
        batch, without the padding), runs once on the first device of its
        ``space`` group, and its result comes back to the tiles' device.
        A shard with no tile does not run. ``key`` is accepted for the
        reference's API; nothing is compiled, so nothing is memoised."""
        devs = self.mesh.axis_devices("data")
        per = -(-tiles.shape[0] // len(devs))
        outs = []
        for i, dev in enumerate(devs):
            shard = tiles[i * per : (i + 1) * per]
            if shard.shape[0] == 0:
                continue
            outs.append(fn(shard.to(dev)).to(tiles.device))
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]

    def _space_ok(self, layout: TileLayout) -> bool:
        s = self.mesh.shape.get("space", 1)
        return s > 1 and layout.ny % s == 0

    def merge(self, tiles: torch.Tensor, weights, layout: TileLayout,
              stats: Optional[Dict] = None) -> torch.Tensor:
        """The halo-exchange merge over ``space`` when the axis is there and
        divides the tile rows; the single-device merge otherwise."""
        if self._space_ok(layout):
            return sharded_weighted_merge(tiles, weights, layout, self.mesh, stats=stats)
        return merge_tiles(tiles, weights, layout)

    def laplacian_blend(self, tiles: torch.Tensor, weight_profiles, layout: TileLayout,
                        levels: int = 6, collapse_last: bool = True,
                        stats: Optional[Dict] = None):
        """The canvas-pyramid blend sharded over ``space`` when possible,
        the single-device profile blend otherwise. Returns the owned canvas
        rows; with ``collapse_last=False`` the sharded path returns a
        :class:`..parallel.finalize.ShardedCanvas` and the single-device
        path a ``(lap0, coarse)`` pair, both for the banded save."""
        if self._space_ok(layout):
            wy, wx = weight_profiles
            return sharded_laplacian_blend(tiles, wy, wx, layout, self.mesh, levels,
                                           collapse_last=collapse_last, stats=stats)
        return laplacian_fusion_tiles(tiles, layout, weight_profiles=weight_profiles,
                                      levels=levels, clip_range=None,
                                      collapse_last=collapse_last)
