"""Tile-batch split (port of ``srs_tpu/tiling/tiling.py:123-194``).

Only the fast path the pipeline runs: :meth:`TilingModule.split_to_batch`
returns the layout and one [N, B, B, C] float32 batch on the device
asked for. The reference's ``Tile``-object API, cache and checkpointing are
not ported.
"""

from __future__ import annotations

from enum import Enum
from typing import Tuple, Union

import numpy as np
import torch

from ..ops.tiles import extract_tiles, pad_image
from ..utils.device import resolve_device
from .geometry import TileLayout, compute_layout

__all__ = ["PaddingMode", "TilingModule"]


class PaddingMode(Enum):
    """Reference padding modes (mirror = BORDER_REFLECT_101)."""

    MIRROR = "mirror"
    REPLICATE = "replicate"
    REFLECT = "reflect"
    CONSTANT = "constant"


class TilingModule:
    """Overlap-grid decomposition of an image into a full-block batch."""

    def __init__(
        self,
        block_size: int = 2048,
        overlap_ratio: float = 0.2,
        padding_mode: Union[PaddingMode, str] = PaddingMode.MIRROR,
        step_multiple: int = 32,
    ):
        self.block_size = block_size
        self.overlap_ratio = overlap_ratio
        self.padding_mode = (
            padding_mode if isinstance(padding_mode, PaddingMode) else PaddingMode(padding_mode)
        )
        self.step_multiple = step_multiple

    def split_to_batch(
        self, image: Union[np.ndarray, torch.Tensor], device: Union[str, torch.device] = "cuda"
    ) -> Tuple[TileLayout, torch.Tensor]:
        """(layout, [N, B, B, C] float32 batch on ``device``), the card by
        default (raises without one)."""
        dev = resolve_device(device)
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.asarray(image, np.float32))
        image = image.to(device=dev, dtype=torch.float32)
        h, w = image.shape[:2]
        layout = compute_layout(
            w, h, self.block_size, self.overlap_ratio, step_multiple=self.step_multiple
        )
        padded = pad_image(image, layout, self.padding_mode.value)
        return layout, extract_tiles(padded, layout)
