"""Tile cache: thread-safe LRU (L1) and content-addressed disk store (L2)
(port of ``srs_tpu/tiling/cache.py``, all of it).

Entries are keyed by ``{image_hash}/{block_id}`` and stored as .npz files
(``data`` plus ``meta_*`` arrays; no pickle, so loading runs no code),
written to a temporary name and renamed into place, so a reader never
sees a half-written tile. The layout is the reference's: a store written
by either package reads in the other. The pipeline's SR resume keeps its
upscaled tiles here.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["LRUCache", "TileStore"]


class LRUCache:
    """Thread-safe LRU (reference: tiling_module.py:373-425)."""

    def __init__(self, max_size: int = 50):
        self.max_size = max_size
        self._data: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if key not in self._data:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.max_size:
                self._data.popitem(last=False)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._data),
                "max_size": self.max_size,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }


class TileStore:
    """Two-level tile store: L1 LRU + L2 content-addressed npz directory."""

    def __init__(self, cache_dir: str, l1_size: int = 50):
        self.cache_dir = os.path.expanduser(cache_dir)
        self.l1 = LRUCache(l1_size)
        self._lock = threading.Lock()

    def _path(self, image_hash: str, block_id: str) -> str:
        return os.path.join(self.cache_dir, image_hash, f"{block_id}.npz")

    def put(self, image_hash: str, block_id: str, data: np.ndarray, **meta: Any) -> None:
        key = f"{image_hash}/{block_id}"
        self.l1.put(key, (data, meta))
        path = self._path(image_hash, block_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, data=data, **{f"meta_{k}": np.asarray(v) for k, v in meta.items()})
        os.replace(tmp, path)  # atomic publish

    def get(self, image_hash: str, block_id: str) -> Optional[np.ndarray]:
        key = f"{image_hash}/{block_id}"
        hit = self.l1.get(key)
        if hit is not None:
            return hit[0]
        path = self._path(image_hash, block_id)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            data = z["data"]
        self.l1.put(key, (data, {}))
        return data

    def has(self, image_hash: str, block_id: str) -> bool:
        return f"{image_hash}/{block_id}" in self.l1 or os.path.exists(
            self._path(image_hash, block_id)
        )

    def list_blocks(self, image_hash: str) -> list:
        d = os.path.join(self.cache_dir, image_hash)
        if not os.path.isdir(d):
            return []
        return [f[:-4] for f in os.listdir(d) if f.endswith(".npz")]

    def evict_image(self, image_hash: str) -> None:
        prefix = f"{image_hash}/"
        with self.l1._lock:
            for key in [k for k in self.l1._data if k.startswith(prefix)]:
                del self.l1._data[key]
        d = os.path.join(self.cache_dir, image_hash)
        if os.path.isdir(d):
            for f in os.listdir(d):
                try:
                    os.remove(os.path.join(d, f))
                except OSError:
                    pass
            try:
                os.rmdir(d)
            except OSError:
                pass

    def stats(self) -> Dict[str, Any]:
        l2_files = 0
        l2_bytes = 0
        if os.path.isdir(self.cache_dir):
            for root, _, files in os.walk(self.cache_dir):
                for f in files:
                    if f.endswith(".npz"):
                        l2_files += 1
                        try:
                            l2_bytes += os.path.getsize(os.path.join(root, f))
                        except OSError:
                            pass
        return {"l1": self.l1.stats(), "l2_files": l2_files, "l2_bytes": l2_bytes}
