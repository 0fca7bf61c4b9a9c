"""TilingModule: tile decomposition, the tile store and the merge (port
of ``srs_tpu/tiling/tiling.py``).

- :meth:`TilingModule.split_to_batch` returns the layout and one
  [N, B, B, C] float32 batch on the device: the path the pipeline runs.
- :meth:`TilingModule.split_image` returns ``Tile`` objects with the
  reference's metadata (a uuid4 ``block_id``, global position, overlaps,
  neighbours, the image's md5, grey standard deviation as complexity,
  and with ``content_aware`` the share of forbidden zone under the tile)
  and registers them; :meth:`TilingModule.merge_tiles` merges (upscaled)
  tiles with the overlap ramps, rebuilding the layout from the metadata
  when the module did not split the image.
- The store half: ``TileStatus``, ``CacheLevel``, ``TileMetadata``,
  ``Tile``, the module's ``store`` (``cache.TileStore``, under
  ``TilingConfig.cache_dir``), ``compute_image_hash``, ``get_tile``,
  ``load_tile_streaming``, ``save_tile_cache``, ``load_tile_cache``,
  ``get_cache_stats``, ``save_checkpoint`` and ``restore_from_cache``.
  Checkpoints and tiles keep the reference's files, so either package
  restores what the other saved.

Images are read by the port's PNG decoder, other formats through PIL
where it is installed (``io.image.load_image``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import TilingConfig
from ..io.image import load_image
from ..ops.tiles import extract_tiles, merge_tiles as _merge_tiles_op, pad_image, unpad_image
from ..ops.weights import layout_weights
from ..utils.device import resolve_device
from .cache import TileStore
from .content import ContentAnalyzer
from .geometry import TileLayout, compute_layout

__all__ = ["PaddingMode", "TileStatus", "CacheLevel", "TileMetadata", "Tile", "TilingModule"]


class PaddingMode(Enum):
    """Reference padding modes (mirror = BORDER_REFLECT_101)."""

    MIRROR = "mirror"
    REPLICATE = "replicate"
    REFLECT = "reflect"
    CONSTANT = "constant"


class TileStatus(Enum):
    """(reference tiling.py:48-55)."""

    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"
    CACHED = "cached"


class CacheLevel(Enum):
    """(reference tiling.py:57-61)."""

    L1_MEMORY = "l1_memory"
    L2_DISK = "l2_disk"
    L3_CLOUD = "l3_cloud"


@dataclass
class TileMetadata:
    """(reference tiling.py:64-100)."""

    block_id: str
    tile_index: int
    row: int
    col: int
    global_x: int
    global_y: int
    input_w: int
    input_h: int
    output_w: int
    output_h: int
    overlap_top: int
    overlap_bottom: int
    overlap_left: int
    overlap_right: int
    image_hash: str = ""
    neighbor_ids: List[int] = field(default_factory=list)
    complexity_score: float = 0.0
    roi_flags: Dict[str, Any] = field(default_factory=dict)
    status: TileStatus = TileStatus.PENDING

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["status"] = self.status.value
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TileMetadata":
        d = dict(d)
        d["status"] = TileStatus(d.get("status", "pending"))
        return cls(**d)


@dataclass
class Tile:
    """(reference tiling.py:103-121)."""

    data: np.ndarray
    metadata: TileMetadata

    def get_effective_region(self) -> np.ndarray:
        """Tile content minus its overlap bands."""
        m = self.metadata
        h, w = self.data.shape[:2]
        return self.data[
            m.overlap_top : h - m.overlap_bottom if m.overlap_bottom else h,
            m.overlap_left : w - m.overlap_right if m.overlap_right else w,
        ]


class TilingModule:
    """Overlap-grid decomposition of an image into full-block tiles, with
    the tile store and checkpoint/resume, on ``device`` (the card by
    default; resolved when an image is split or merged). ``block_size``,
    ``overlap_ratio`` and ``l1_cache_size`` left at their defaults read
    ``config``, as in the reference."""

    def __init__(
        self,
        block_size: int = 2048,
        overlap_ratio: float = 0.2,
        padding_mode: Union[PaddingMode, str] = PaddingMode.MIRROR,
        output_scale: int = 2,
        content_aware: bool = False,
        cache_dir: Optional[str] = None,
        l1_cache_size: int = 50,
        config: Optional[TilingConfig] = None,
        step_multiple: int = 32,
        device: Union[str, torch.device] = "cuda",
    ):
        cfg = config or TilingConfig()
        self.config = cfg
        self.block_size = block_size if block_size != 2048 else cfg.block_size
        self.overlap_ratio = overlap_ratio if overlap_ratio != 0.2 else cfg.overlap_ratio
        self.padding_mode = (
            padding_mode if isinstance(padding_mode, PaddingMode) else PaddingMode(padding_mode)
        )
        self.output_scale = output_scale
        self.content_aware = content_aware
        self.step_multiple = step_multiple
        self.device = device
        # Nothing is written until a tile is stored.
        self.store = TileStore(cache_dir or cfg.cache_dir, l1_cache_size or cfg.l1_cache_size)
        self.analyzer = ContentAnalyzer(device=device) if content_aware else None
        self._registry: Dict[str, Tile] = {}
        self._registry_lock = threading.Lock()
        self.processing_state: Dict[str, Dict[str, Any]] = {}
        # Layouts of the images split_image cut, by image hash (merge_tiles).
        self._layouts: Dict[str, TileLayout] = {}

    def _layout(self, w: int, h: int) -> TileLayout:
        return compute_layout(
            w, h, self.block_size, self.overlap_ratio, step_multiple=self.step_multiple
        )

    def split_to_batch(
        self, image: Union[np.ndarray, torch.Tensor],
        device: Optional[Union[str, torch.device]] = None,
    ) -> Tuple[TileLayout, torch.Tensor]:
        """(layout, [N, B, B, C] float32 batch on ``device``, the module's
        by default)."""
        dev = resolve_device(self.device if device is None else device)
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image, np.float32))
        image = image.to(device=dev, dtype=torch.float32)
        h, w = image.shape[:2]
        layout = self._layout(w, h)
        padded = pad_image(image, layout, self.padding_mode.value, self.config.constant_value)
        return layout, extract_tiles(padded, layout)

    # -- hashing (reference tiling.py:148-157) ------------------------------
    @staticmethod
    def compute_image_hash(source: Union[str, np.ndarray, torch.Tensor]) -> str:
        """md5 of a file's bytes, or of an array's bytes in C order."""
        if isinstance(source, str):
            h = hashlib.md5()
            with open(source, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            return h.hexdigest()
        if isinstance(source, torch.Tensor):
            source = source.cpu().numpy()
        return hashlib.md5(np.ascontiguousarray(source).tobytes()).hexdigest()

    @staticmethod
    def _load_image(source: Union[str, np.ndarray, torch.Tensor]
                    ) -> Union[np.ndarray, torch.Tensor]:
        """float32 pixels: a tensor stays where it is, an array is cast, a
        path is decoded (PNG by the port, other formats through PIL)."""
        if isinstance(source, torch.Tensor):
            return source.float()
        if isinstance(source, np.ndarray):
            return source.astype(np.float32)
        return load_image(source)

    # -- the Tile API (reference tiling.py:197-253) --------------------------
    def split_image(self, source: Union[str, np.ndarray, torch.Tensor]) -> List[Tile]:
        """Cut ``source`` into full-block ``Tile``s with their metadata,
        register them, and record the image's ``processing_state``."""
        arr = self._load_image(source)
        image_hash = self.compute_image_hash(source)
        layout, batch = self.split_to_batch(arr)
        self._layouts[image_hash] = layout
        tiles_np = batch.cpu().numpy()
        del batch

        zone = None
        if self.analyzer is not None:
            host = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else arr
            zone = self.analyzer.create_forbidden_zone_map(host)

        img_h, img_w = int(arr.shape[0]), int(arr.shape[1])
        tiles: List[Tile] = []
        for t in range(layout.num_tiles):
            y, x = (int(v) for v in layout.positions[t])
            top, bottom, left, right = (int(v) for v in layout.overlaps[t])
            meta = TileMetadata(
                block_id=str(uuid.uuid4()),
                tile_index=t,
                row=t // layout.nx,
                col=t % layout.nx,
                global_x=x,
                global_y=y,
                input_w=layout.block,
                input_h=layout.block,
                output_w=layout.block * self.output_scale,
                output_h=layout.block * self.output_scale,
                overlap_top=top,
                overlap_bottom=bottom,
                overlap_left=left,
                overlap_right=right,
                image_hash=image_hash,
                neighbor_ids=[int(n) for n in layout.neighbors[t]],
            )
            data = tiles_np[t]
            meta.complexity_score = float(
                (0.299 * data[..., 0] + 0.587 * data[..., 1] + 0.114 * data[..., 2]).std()
            )
            if zone is not None:
                ys, xs = min(y, img_h - 1), min(x, img_w - 1)
                region = zone[ys : y + layout.block, xs : x + layout.block]
                meta.roi_flags["forbidden_ratio"] = float(region.mean()) if region.size else 0.0
            tile = Tile(data=data, metadata=meta)
            tiles.append(tile)
            with self._registry_lock:
                self._registry[meta.block_id] = tile

        self.processing_state[image_hash] = {
            "timestamp": time.time(),
            "num_tiles": layout.num_tiles,
            "block_size": layout.block,
            "overlap": layout.overlap,
            "image_w": layout.image_w,
            "image_h": layout.image_h,
            "tiles": {tl.metadata.block_id: tl.metadata.status.value for tl in tiles},
        }
        return tiles

    def merge_tiles(
        self,
        tiles: List[Tile],
        output_size: Optional[Tuple[int, int]] = None,
        scale: Optional[int] = None,
    ) -> np.ndarray:
        """Merge (possibly upscaled) tiles with the overlap ramps: float32
        (H, W, C), cropped to ``output_size`` (h, w) when given. The scale
        is ``scale``, else the tiles' size over their input size."""
        if not tiles:
            raise ValueError("no tiles to merge")
        tiles = sorted(tiles, key=lambda t: t.metadata.tile_index)
        layout = self._layouts.get(tiles[0].metadata.image_hash)
        s = scale or (tiles[0].data.shape[0] // tiles[0].metadata.input_w) or 1
        if layout is None:
            # the layout rebuilt from the tiles' metadata
            m0 = tiles[0].metadata
            nx = max(t.metadata.col for t in tiles) + 1
            ny = max(t.metadata.row for t in tiles) + 1
            step = m0.input_w - (m0.overlap_right or 0)
            w = (nx - 1) * step + m0.input_w
            h = (ny - 1) * step + m0.input_h
            layout = compute_layout(w, h, m0.input_w, (m0.overlap_right or 0) / m0.input_w)
        out_layout = layout.scaled(s)
        dev = resolve_device(self.device)
        batch = torch.stack([
            (t.data if isinstance(t.data, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(t.data, np.float32))).to(dev, torch.float32)
            for t in tiles])
        canvas = _merge_tiles_op(batch, layout_weights(out_layout, kind="ramp"), out_layout)
        out = unpad_image(canvas, out_layout)
        if output_size is not None:
            out = out[: output_size[0], : output_size[1]]
        return out.cpu().numpy()

    # -- the registry and streaming loads (reference tiling.py:255-281) -----
    def get_tile(self, block_id: str) -> Optional[Tile]:
        with self._registry_lock:
            return self._registry.get(block_id)

    def load_tile_streaming(self, image_path: str, tile_index: int) -> np.ndarray:
        """Tile ``tile_index`` of the image's layout as float32 [B, B, 3],
        mirror-padded where it passes the image's edge. PNG is decoded by
        the port (the whole image, then cropped); other formats go through
        PIL where it is installed (``io.image.load_image``)."""
        image = load_image(image_path)
        h, w = image.shape[:2]
        layout = self._layout(w, h)
        y, x = (int(v) for v in layout.positions[tile_index])
        data = image[y : min(y + layout.block, h), x : min(x + layout.block, w)]
        ph = layout.block - data.shape[0]
        pw = layout.block - data.shape[1]
        if ph or pw:
            data = np.pad(data, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        return np.ascontiguousarray(data, np.float32)

    # -- cache (reference tiling.py:283-295) --------------------------------
    def save_tile_cache(self, tile: Tile) -> None:
        self.store.put(tile.metadata.image_hash, tile.metadata.block_id, tile.data)
        tile.metadata.status = TileStatus.CACHED

    def load_tile_cache(self, image_hash: str, block_id: str) -> Optional[np.ndarray]:
        return self.store.get(image_hash, block_id)

    def get_cache_stats(self) -> Dict[str, Any]:
        return self.store.stats()

    # -- checkpoint / resume (reference tiling.py:297-340) ------------------
    def _checkpoint_path(self, image_hash: str) -> str:
        return os.path.join(self.store.cache_dir, image_hash, "checkpoint.json")

    def save_checkpoint(self, image_hash: str) -> str:
        """Write ``processing_state[image_hash]`` and the metadata of its
        registered tiles to ``<store>/<image_hash>/checkpoint.json``."""
        state = self.processing_state.get(image_hash)
        if state is None:
            raise KeyError(f"no processing state for {image_hash}")
        with self._registry_lock:
            metas = [
                t.metadata.to_dict()
                for t in self._registry.values()
                if t.metadata.image_hash == image_hash
            ]
        path = self._checkpoint_path(image_hash)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"state": state, "tiles": metas}, f)
        os.replace(tmp, path)
        return path

    def restore_from_cache(self, image_hash: str) -> Optional[List[Tile]]:
        """Rebuild the checkpoint's tiles from the store into this module's
        registry, in tile order; a tile missing from the store comes back
        PENDING with zero data. None when there is no checkpoint."""
        path = self._checkpoint_path(image_hash)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            payload = json.load(f)
        self.processing_state[image_hash] = payload["state"]
        tiles: List[Tile] = []
        for md in payload["tiles"]:
            meta = TileMetadata.from_dict(md)
            data = self.store.get(image_hash, meta.block_id)
            if data is None:
                meta.status = TileStatus.PENDING
                data = np.zeros((meta.input_h, meta.input_w, 3), np.float32)
            tile = Tile(data=data, metadata=meta)
            tiles.append(tile)
            with self._registry_lock:
                self._registry[meta.block_id] = tile
        tiles.sort(key=lambda t: t.metadata.tile_index)
        return tiles
