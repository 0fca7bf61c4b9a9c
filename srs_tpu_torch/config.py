"""Configuration subset the pipeline reads (port of ``srs_tpu/config.py``).

``RESOLUTION_PRESETS`` (reference config.py:24), the ``ModelConfig``
fields the SR engine uses (config.py:38-70: the quality and fast nets,
routing, per-scale selection, the self-ensemble, the ledger location and
the compute/parameter dtypes), the tile store's ``TilingConfig`` fields
(config.py:84-87), ``SchedulerConfig`` (config.py:143-175) and the QA
configuration (config.py:174-215).

The port's directories under the user's cache are its own
(``~/.cache/srs_tpu_torch/...``), so the two packages never share a tile
store or a scheduler checkpoint.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "RESOLUTION_PRESETS",
    "ModelConfig",
    "TilingConfig",
    "SchedulerConfig",
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
class TilingConfig:
    """The tile store's fields of the reference's ``TilingConfig``
    (config.py:84-87): its directory and the in-memory LRU's entries. The
    rest of that class waits for the module-level API (ROADMAP Queue 1)."""

    cache_dir: str = field(
        default_factory=lambda: os.path.expanduser("~/.cache/srs_tpu_torch/tiling")
    )
    l1_cache_size: int = 50  # in-memory LRU entries (reference config.py:52)


@dataclass
class SchedulerConfig:
    """Tile dispatcher configuration (reference config.py:143-175): the
    policy surface of ``scheduler.AgentScheduler`` (priority, retries,
    degradation, autoscaling bounds)."""

    max_agents: int = 100
    max_concurrent: int = 60
    min_agents: int = 5
    scale_max_agents: int = 500
    queue_depth_low: int = 10
    queue_depth_high: int = 50
    queue_depth_critical: int = 100
    scale_up_threshold: float = 0.8
    scale_down_threshold: float = 0.2
    autoscale_up_queue: int = 50
    autoscale_down_queue: int = 10
    max_retries: int = 3
    retry_delays: List[float] = field(default_factory=lambda: [1.0, 2.0, 4.0])
    weight_factors: Dict[str, float] = field(
        default_factory=lambda: {"queue": 0.4, "time": 0.3, "latency": 0.3}
    )
    heartbeat_timeout: float = 30.0
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.expanduser("~/.cache/srs_tpu_torch/scheduler")
    )


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
