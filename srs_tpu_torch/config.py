"""Configuration subset the quality path reads (port of ``srs_tpu/config.py``).

``RESOLUTION_PRESETS`` (reference config.py:24), the ``ModelConfig``
fields the SR engine uses (config.py:38-70: the quality and fast nets,
routing, per-scale selection, the self-ensemble, the ledger location and
the compute/parameter dtypes), and the QA configuration
(config.py:174-215).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = [
    "RESOLUTION_PRESETS",
    "ModelConfig",
    "QualityThresholds",
    "QualityAssessmentConfig",
]

RESOLUTION_PRESETS: Dict[str, Tuple[int, int]] = {
    "100MP": (12245, 8163),
    "150MP": (15000, 10000),
    "200MP": (17320, 11547),
}


@dataclass
class ModelConfig:
    """On-device SR model configuration."""

    quality_model: str = "edsr_xl"  # registry key for the quality net
    fast_model: str = "espcn"  # registry key for the fast net
    # Degradation-aware routing (models/routing.py): damaged inputs serve
    # ``robust_model`` when it is trained.
    auto_route: bool = True
    robust_model: str = "edsr_l_robust"
    # Per-scale selection (models/selection.py): each ladder step serves
    # the panel-best trained net at its scale.
    per_scale_selection: bool = True
    # Average each net pass over the 8 dihedral transforms of the tile
    # batch (EDSR's "+" mode; 8x the SR compute).
    self_ensemble: bool = False
    compute_dtype: str = "bfloat16"  # convolutions; accumulation in f32
    params_dtype: str = "float32"
    # Directory whose EVAL.json (the evidence ledger) selection reads
    # first; None reads the packaged ledger only. The reference defaults
    # to a directory under the user's home; the port reads nothing
    # outside its checkout unless asked.
    checkpoint_dir: Optional[str] = None


@dataclass
class QualityThresholds:
    """Quality gates (reference config.py:174-196; the delta-E gates wait
    for ``evaluate_commercial``)."""

    psnr_excellent: float = 40.0
    psnr_good: float = 35.0
    psnr_acceptable: float = 30.0
    ssim_excellent: float = 0.98
    ssim_good: float = 0.95
    ssim_acceptable: float = 0.90
    lpips_excellent: float = 0.02
    lpips_good: float = 0.05
    lpips_acceptable: float = 0.10
    niqe_excellent: float = 3.0
    niqe_good: float = 5.0
    niqe_acceptable: float = 8.0
    brisque_excellent: float = 20.0
    brisque_good: float = 35.0
    brisque_acceptable: float = 50.0


@dataclass
class QualityAssessmentConfig:
    """QA configuration (reference config.py:199-215): the fields the full-
    and no-reference evaluations read. The device is the pipeline's."""

    thresholds: QualityThresholds = field(default_factory=QualityThresholds)
