"""Image loading (port of ``srs_tpu/io/image.py:25-31``).

PIL is imported only when a path is loaded: the card's machine has no PIL,
and ``process()`` also takes an ndarray directly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image"]


def load_image(path: str) -> np.ndarray:
    """RGB float32 (H, W, 3) in [0, 255]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32)
