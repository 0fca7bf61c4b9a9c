"""Mirror padding, tile extraction and the weighted merge (port of
``srs_tpu/ops/tiles.py``).

Mode names follow the reference's ``PaddingMode``: "mirror" is
BORDER_REFLECT_101 (edge pixel not repeated), "reflect" is BORDER_REFLECT
(edge repeated), "replicate" repeats the edge, "constant" fills.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..tiling.geometry import TileLayout

__all__ = ["pad_image", "unpad_image", "extract_tiles", "merge_tiles"]

_NP_MODES = {"mirror": "reflect", "reflect": "symmetric", "replicate": "edge"}


def _pad_index(n: int, pad: int, mode: str) -> np.ndarray:
    """Source index of each padded position along one axis (numpy's pad
    rules, the same as ``jnp.pad``'s)."""
    return np.pad(np.arange(n), (0, pad), mode=_NP_MODES[mode])


def pad_image(
    image: torch.Tensor,
    layout: TileLayout,
    mode: str = "mirror",
    constant_value: float = 0.0,
) -> torch.Tensor:
    """Pad an (H, W, C) image to the layout's full grid extent."""
    ph = layout.padded_h - layout.image_h
    pw = layout.padded_w - layout.image_w
    if ph == 0 and pw == 0:
        return image
    h, w, c = image.shape
    if mode == "constant":
        out = torch.full((h + ph, w + pw, c), float(constant_value),
                         dtype=image.dtype, device=image.device)
        out[:h, :w] = image
        return out
    if mode not in _NP_MODES:
        raise ValueError(f"unknown padding mode {mode!r}")
    rows = torch.from_numpy(_pad_index(h, ph, mode)).to(image.device)
    cols = torch.from_numpy(_pad_index(w, pw, mode)).to(image.device)
    return image.index_select(0, rows).index_select(1, cols)


def extract_tiles(
    padded: torch.Tensor, layout: TileLayout, positions: Optional[np.ndarray] = None
) -> torch.Tensor:
    """The full-block tile batch [N, block, block, C]."""
    if positions is None:
        positions = layout.positions
    b = layout.block
    return torch.stack(
        [padded[int(y) : int(y) + b, int(x) : int(x) + b] for y, x in positions]
    )


def unpad_image(canvas: torch.Tensor, layout: TileLayout) -> torch.Tensor:
    """Crop a padded-extent canvas back to the true image size."""
    return canvas[: layout.image_h, : layout.image_w]


def merge_tiles(
    tiles: torch.Tensor,
    weights,
    layout: TileLayout,
    positions: Optional[np.ndarray] = None,
    premultiplied: bool = False,
) -> torch.Tensor:
    """``sum(tile * w) / max(sum(w), 1e-8)`` over the padded canvas, in
    float32 (tiles [N, B, B, C], weights [N, B, B]). With
    ``premultiplied`` the tiles already carry their weights and only the
    denominator uses ``weights``. Crop with :func:`unpad_image`."""
    if positions is None:
        positions = layout.positions
    n, b, _, c = tiles.shape
    w = torch.as_tensor(weights, dtype=torch.float32, device=tiles.device)
    canvas = torch.zeros((layout.padded_h, layout.padded_w, c), dtype=torch.float32,
                         device=tiles.device)
    wsum = torch.zeros((layout.padded_h, layout.padded_w, 1), dtype=torch.float32,
                       device=tiles.device)
    for t in range(n):
        y, x = int(positions[t][0]), int(positions[t][1])
        w3 = w[t][..., None]
        tile = tiles[t].float()
        canvas[y : y + b, x : x + b] += tile if premultiplied else tile * w3
        wsum[y : y + b, x : x + b] += w3
    return canvas / torch.clamp(wsum, min=1e-8)
