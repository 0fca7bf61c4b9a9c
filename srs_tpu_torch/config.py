"""Configuration subset the quality path reads (port of ``srs_tpu/config.py``).

``RESOLUTION_PRESETS`` (reference config.py:24) and the ``ModelConfig``
fields the SR engine uses: the quality net and the compute/parameter
dtypes (config.py:56-57).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["RESOLUTION_PRESETS", "ModelConfig"]

RESOLUTION_PRESETS: Dict[str, Tuple[int, int]] = {
    "100MP": (12245, 8163),
    "150MP": (15000, 10000),
    "200MP": (17320, 11547),
}


@dataclass
class ModelConfig:
    """On-device SR model configuration."""

    quality_model: str = "edsr_xl"  # registry key for the quality net
    compute_dtype: str = "bfloat16"  # convolutions; accumulation in f32
    params_dtype: str = "float32"
