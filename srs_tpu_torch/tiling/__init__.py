"""Tile geometry and the tile-batch split (port of ``srs_tpu.tiling``).

The reference's exports (``srs_tpu/tiling/__init__.py``) are bound on
first access (PEP 562): ``geometry`` stays importable without torch's
ops and io.
"""

import importlib

_EXPORTS = {
    "TileLayout": "geometry",
    "compute_layout": "geometry",
    "TilingModule": "tiling",
    "Tile": "tiling",
    "TileMetadata": "tiling",
    "TileStatus": "tiling",
    "PaddingMode": "tiling",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
