"""The configuration tree (port of ``srs_tpu/config.py``): a dataclass
per stage under ``SystemConfig``, with the reference's fields and
defaults, ``SystemConfig.from_env`` (the same environment variables) and
the module-level ``config``, read once at import.

Where the port differs: its directories under the user's cache are its
own (``~/.cache/srs_tpu_torch/...``), so the two packages never share a
tile store or a scheduler checkpoint; ``ModelConfig.checkpoint_dir`` is
None (the port reads nothing outside its checkout unless asked); and the
QA device defaults to ``"cuda"``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "RESOLUTION_PRESETS",
    "ModelConfig",
    "TilingConfig",
    "SuperResolutionConfig",
    "BlendingConfig",
    "SchedulerConfig",
    "QualityThresholds",
    "QualityAssessmentConfig",
    "WebUIConfig",
    "ParallelConfig",
    "SystemConfig",
    "config",
]

RESOLUTION_PRESETS: Dict[str, Tuple[int, int]] = {
    "100MP": (12245, 8163),
    "150MP": (15000, 10000),
    "200MP": (17320, 11547),
}


@dataclass
class ModelConfig:
    """On-device SR model configuration."""

    default_provider: str = "hybrid"  # quality | fast | hybrid | bicubic
    quality_model: str = "edsr_xl"  # registry key for the quality net
    fast_model: str = "espcn"  # registry key for the fast net
    # Degradation-aware routing (models/routing.py): damaged inputs serve
    # ``robust_model`` when it is trained.
    auto_route: bool = True
    robust_model: str = "edsr_l_robust"
    # Per-scale selection (models/selection.py): each ladder step serves
    # the panel-best trained net at its scale.
    per_scale_selection: bool = True
    compute_dtype: str = "bfloat16"  # convolutions; accumulation in f32
    params_dtype: str = "float32"
    # Average each net pass over the 8 dihedral transforms of the tile
    # batch (EDSR's "+" mode; 8x the SR compute).
    self_ensemble: bool = False
    # Directory whose EVAL.json (the evidence ledger) selection reads
    # first; None reads the packaged ledger only. The reference defaults
    # to a directory under the user's home; the port reads nothing
    # outside its checkout unless asked.
    checkpoint_dir: Optional[str] = None
    max_retries: int = 3
    retry_base_delay: float = 1.0
    retry_max_delay: float = 8.0


@dataclass
class TilingConfig:
    """Tile decomposition configuration (reference config.py:73-96)."""

    block_size: int = 2048
    output_block_size: int = 4096
    overlap_ratio: float = 0.2  # valid range [0.1, 0.3]
    min_overlap_ratio: float = 0.1
    max_overlap_ratio: float = 0.3
    padding_mode: str = "mirror"  # mirror | replicate | reflect | constant
    constant_value: int = 0
    content_aware: bool = True
    cache_dir: str = field(
        default_factory=lambda: os.path.expanduser("~/.cache/srs_tpu_torch/tiling")
    )
    l1_cache_size: int = 50  # in-memory LRU entries (reference config.py:52)
    enable_checkpoint: bool = True

    def __post_init__(self) -> None:
        if not (self.min_overlap_ratio <= self.overlap_ratio <= self.max_overlap_ratio):
            raise ValueError(
                f"overlap_ratio {self.overlap_ratio} outside "
                f"[{self.min_overlap_ratio}, {self.max_overlap_ratio}]"
            )


@dataclass
class SuperResolutionConfig:
    """SR stage configuration (reference config.py:99-124)."""

    target_resolution: str = "100MP"  # preset key or "custom"
    custom_width: int = 0
    custom_height: int = 0
    scale_factor: float = 2.0
    strength: float = 0.5
    steps: int = 50
    guidance_scale: float = 7.5
    seed: int = -1
    hybrid_stages: List[str] = field(
        default_factory=lambda: ["fast_prefilter", "quality_main", "fast_polish"]
    )
    prompt_category: str = "general"
    negative_prompt: str = ""

    def target_size(self) -> Tuple[int, int]:
        if self.target_resolution in RESOLUTION_PRESETS:
            return RESOLUTION_PRESETS[self.target_resolution]
        if self.custom_width > 0 and self.custom_height > 0:
            return (self.custom_width, self.custom_height)
        raise ValueError(f"unknown target resolution {self.target_resolution!r}")


@dataclass
class BlendingConfig:
    """Tile fusion configuration (reference config.py:127-140)."""

    fusion_method: str = "laplacian"  # laplacian|poisson|weighted|feather|gradient
    pyramid_levels: int = 6
    weight_type: str = "cosine"  # linear | cosine | sigmoid
    seam_threshold: float = 0.95  # windowed-SSIM seam threshold
    seam_window: int = 16
    seam_stride: int = 8
    enable_seam_repair: bool = True
    enable_color_correction: bool = True
    color_correction_method: str = "histogram"  # histogram | mean_std | guided
    poisson_mode: str = "normal"  # normal | mixed | monochrome


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
    """Quality gates (reference config.py:174-195)."""

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
    delta_e_excellent: float = 1.0
    delta_e_good: float = 3.0
    delta_e_acceptable: float = 5.0


@dataclass
class QualityAssessmentConfig:
    """QA configuration (reference config.py:198-221)."""

    assessment_level: str = "full"  # full | fast | none
    thresholds: QualityThresholds = field(default_factory=QualityThresholds)
    scale_weights: Dict[str, float] = field(
        default_factory=lambda: {
            "structure_color": 0.1,
            "mid_frequency": 0.2,
            "high_frequency": 0.4,
        }
    )
    commercial_weights: Dict[str, float] = field(
        default_factory=lambda: {
            "detail_fidelity": 0.3,
            "color_accuracy": 0.4,
            "visual_comfort": 0.3,
        }
    )
    device: str = "cuda"  # cuda | cpu
    enable_lpips: bool = True


@dataclass
class WebUIConfig:
    """Web UI configuration (reference config.py:224-238)."""

    max_upload_mb: int = 500
    allowed_formats: List[str] = field(
        default_factory=lambda: ["jpg", "jpeg", "png", "tiff", "raw", "cr2", "nef", "arw"]
    )
    output_formats: List[str] = field(default_factory=lambda: ["tiff", "png", "jpeg", "jxl"])
    resolution_presets: Dict[str, Tuple[int, int]] = field(
        default_factory=lambda: dict(RESOLUTION_PRESETS)
    )
    port: int = 8501


@dataclass
class ParallelConfig:
    """Device mesh configuration (reference config.py:241-254): ``data``
    shards the tile batch, ``space`` the canvas rows."""

    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": 1, "space": 1})
    use_all_devices: bool = True
    halo_exchange: bool = True
    donate_buffers: bool = True


@dataclass
class SystemConfig:
    """Root configuration (reference config.py:257-303)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    tiling: TilingConfig = field(default_factory=TilingConfig)
    super_resolution: SuperResolutionConfig = field(default_factory=SuperResolutionConfig)
    blending: BlendingConfig = field(default_factory=BlendingConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    quality: QualityAssessmentConfig = field(default_factory=QualityAssessmentConfig)
    webui: WebUIConfig = field(default_factory=WebUIConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @classmethod
    def from_env(cls) -> "SystemConfig":
        """The defaults with the environment's overrides: ``BLOCK_SIZE``,
        ``OVERLAP_RATIO``, ``TARGET_RESOLUTION``, ``MAX_CONCURRENT``,
        ``QA_DEVICE``, ``SRS_PROVIDER`` and ``SRS_MESH`` (e.g.
        ``"data=4,space=2"``)."""
        cfg = cls()
        env = os.environ
        if "BLOCK_SIZE" in env:
            cfg.tiling.block_size = int(env["BLOCK_SIZE"])
        if "OVERLAP_RATIO" in env:
            cfg.tiling.overlap_ratio = float(env["OVERLAP_RATIO"])
        if "TARGET_RESOLUTION" in env:
            cfg.super_resolution.target_resolution = env["TARGET_RESOLUTION"]
        if "MAX_CONCURRENT" in env:
            cfg.scheduler.max_concurrent = int(env["MAX_CONCURRENT"])
        if "QA_DEVICE" in env:
            cfg.quality.device = env["QA_DEVICE"]
        if "SRS_PROVIDER" in env:
            cfg.model.default_provider = env["SRS_PROVIDER"]
        if "SRS_MESH" in env:
            mesh: Dict[str, int] = {}
            for part in env["SRS_MESH"].split(","):
                k, _, v = part.partition("=")
                mesh[k.strip()] = int(v)
            cfg.parallel.mesh_shape = mesh
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kwargs: Any) -> "SystemConfig":
        return dataclasses.replace(self, **kwargs)


# The environment's configuration, read once at import (reference config.py:307).
config = SystemConfig.from_env()
